"""OS-window live frontend: the reference LIVE build's real-framebuffer
loop (crt_main.c:284-557 binds an FW-library window at 60 Hz) against bare
Xlib through ctypes — no SDL or GUI toolkit dependency, just libX11.so.6.

The port of ``ntsc_crt_tpu/apps/x11_live.py``.  The session logic is
entirely apps/live.py (the exact controls.txt key map, the session on the
CUDA card); this module only owns the window: a TrueColor ZPixmap blit per
frame plus KeyPress translation.  With no usable $DISPLAY, or a default
visual other than 24-bit 0x00RRGGBB, the CLI falls back to the terminal
renderer (apps/term_live.py).

Every Xlib function has its argument and result types declared (`XLIB`):
Display*, GC, Visual* and XImage* are pointers, Window and KeySym are XIDs
(unsigned long); left to ctypes' int default they would be cut to 32 bits.

    python -m ntsc_crt_tpu_torch.apps.x11_live [image.ppm] [-s SYSTEM]
        [--fps 60]

The Xlib surface is wrapped in one small class (`XWindow`) taking the
loaded library as a constructor seam, so tests drive the full frame/key
path against a fake Xlib without a display.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time
from ctypes import (POINTER, c_char_p, c_int, c_long, c_uint, c_ulong,
                    c_void_p)

import numpy as np

# X11 constants (X.h)
KeyPressMask = 1 << 0
ExposureMask = 1 << 15
KeyPress = 2
ZPixmap = 2
# the layout pack_zpixmap writes: depth 24, 0x00RRGGBB
DEPTH = 24
MASKS = (0xFF0000, 0x00FF00, 0x0000FF)


def pack_zpixmap(rgb: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 RGB -> (h, w) uint32 0x00RRGGBB ZPixmap pixels for a
    32-bit-depth little-endian TrueColor visual (the overwhelmingly common
    X11 configuration; byte order in memory is B, G, R, X)."""
    px = rgb.astype(np.uint32)
    return (px[..., 0] << 16) | (px[..., 1] << 8) | px[..., 2]


class _XEvent(ctypes.Union):
    _fields_ = [("type", c_int), ("pad", c_long * 24)]


class Visual(ctypes.Structure):
    """Xlib's Visual (Xlib.h), read for its RGB masks."""
    _fields_ = [("ext_data", c_void_p), ("visualid", c_ulong),
                ("c_class", c_int), ("red_mask", c_ulong),
                ("green_mask", c_ulong), ("blue_mask", c_ulong),
                ("bits_per_rgb", c_int), ("map_entries", c_int)]


_DPY, _XID, _PTR = c_void_p, c_ulong, c_void_p
# every Xlib function XWindow calls: (restype, argtypes)
XLIB = {
    "XOpenDisplay": (_DPY, [c_char_p]),
    "XDefaultScreen": (c_int, [_DPY]),
    "XDefaultRootWindow": (_XID, [_DPY]),
    "XCreateSimpleWindow": (_XID, [_DPY, _XID, c_int, c_int, c_uint, c_uint,
                                   c_uint, c_ulong, c_ulong]),
    "XSelectInput": (c_int, [_DPY, _XID, c_long]),
    "XStoreName": (c_int, [_DPY, _XID, c_char_p]),
    "XMapWindow": (c_int, [_DPY, _XID]),
    "XDefaultGC": (_PTR, [_DPY, c_int]),
    "XDefaultVisual": (_PTR, [_DPY, c_int]),
    "XDefaultDepth": (c_int, [_DPY, c_int]),
    "XCreateImage": (_PTR, [_DPY, _PTR, c_uint, c_int, c_int, _PTR, c_uint,
                            c_uint, c_int, c_int]),
    "XFlush": (c_int, [_DPY]),
    "XPutImage": (c_int, [_DPY, _XID, _PTR, _PTR, c_int, c_int, c_int, c_int,
                          c_uint, c_uint]),
    "XPending": (c_int, [_DPY]),
    "XNextEvent": (c_int, [_DPY, POINTER(_XEvent)]),
    "XLookupKeysym": (_XID, [POINTER(_XEvent), c_int]),
    "XDestroyWindow": (c_int, [_DPY, _XID]),
    "XCloseDisplay": (c_int, [_DPY]),
}


def bind(xlib):
    """Declare XLIB's types on the library handle; returns it."""
    for name, (res, args) in XLIB.items():
        fn = getattr(xlib, name)
        fn.restype = res
        fn.argtypes = args
    return xlib


class XWindow:
    """Minimal Xlib window: open, blit full frames, poll key presses.

    `xlib` is the ctypes library handle — pass a fake for tests.  Raises
    RuntimeError when the display cannot be opened or its default visual
    is not 24-bit 0x00RRGGBB (callers fall back to the terminal
    frontend)."""

    def __init__(self, width: int, height: int, title: str = "ntsc-crt",
                 xlib=None):
        self.w, self.h = width, height
        self.x = bind(xlib if xlib is not None
                      else ctypes.CDLL("libX11.so.6"))
        self.dpy = self.x.XOpenDisplay(None)
        if not self.dpy:
            raise RuntimeError("cannot open X display")
        self.screen = self.x.XDefaultScreen(self.dpy)
        visual = self.x.XDefaultVisual(self.dpy, self.screen)
        depth = self.x.XDefaultDepth(self.dpy, self.screen)
        vis = Visual.from_address(visual)
        masks = (vis.red_mask, vis.green_mask, vis.blue_mask)
        if depth != DEPTH or masks != MASKS:
            self.x.XCloseDisplay(self.dpy)
            raise RuntimeError(
                f"default visual is depth {depth}, masks "
                f"{tuple(hex(m) for m in masks)}: not 24-bit 0x00RRGGBB")
        root = self.x.XDefaultRootWindow(self.dpy)
        self.win = self.x.XCreateSimpleWindow(
            self.dpy, root, 0, 0, width, height, 0, 0, 0)
        self.x.XSelectInput(self.dpy, self.win,
                            KeyPressMask | ExposureMask)
        self.x.XStoreName(self.dpy, self.win, title.encode())
        self.x.XMapWindow(self.dpy, self.win)
        self.gc = self.x.XDefaultGC(self.dpy, self.screen)
        self._buf = np.zeros((height, width), np.uint32)
        # depth 24, bitmap_pad 32, bytes_per_line w*4 — the standard
        # TrueColor ZPixmap layout pack_zpixmap emits
        self.img = self.x.XCreateImage(
            self.dpy, visual, DEPTH, ZPixmap, 0, self._buf.ctypes.data,
            width, height, 32, width * 4)
        if not self.img:
            raise RuntimeError("XCreateImage failed")
        self.x.XFlush(self.dpy)

    def blit(self, rgb: np.ndarray):
        """Draw one (h, w, 3) uint8 RGB frame."""
        self._buf[...] = pack_zpixmap(rgb)
        self.x.XPutImage(self.dpy, self.win, self.gc, self.img, 0, 0, 0, 0,
                         self.w, self.h)
        self.x.XFlush(self.dpy)

    def poll_keys(self) -> list[str]:
        """Drain pending KeyPress events into controls.txt key names."""
        keys = []
        ev = _XEvent()
        while self.x.XPending(self.dpy):
            self.x.XNextEvent(self.dpy, ctypes.byref(ev))
            if ev.type != KeyPress:
                continue
            sym = self.x.XLookupKeysym(ctypes.byref(ev), 0)
            name = self._keysym_name(sym)
            if name is not None:
                keys.append(name)
        return keys

    # keysymdef.h values for the controls.txt map (apps/live.py)
    _SYMS = {0xFF52: "up", 0xFF54: "down", 0xFF53: "right", 0xFF51: "left",
             0xFF1B: "esc", 0x0020: " "}

    @classmethod
    def _keysym_name(cls, sym: int) -> str | None:
        if sym in cls._SYMS:
            return cls._SYMS[sym]
        if 0x20 < sym < 0x7F:                            # latin-1 printables
            return chr(sym)
        return None

    def close(self):
        self.x.XDestroyWindow(self.dpy, self.win)
        self.x.XCloseDisplay(self.dpy)


def run_loop(sess, img, win, fps: float = 60.0, frames: int = 0,
             clock=time.perf_counter, sleep=time.sleep) -> float:
    """The displaycb loop (crt_main.c:454-516) against an XWindow:
    double-buffered host copy (frame N dispatched while N-1 blits) and a
    60 Hz cap.  Returns the steady-state ms/frame EMA."""
    period = 1.0 / fps if fps > 0 else 0.0
    pending = None
    ema_ms = None
    n = 0
    while True:
        t0 = clock()
        dev = sess.tick_fast(img, fetch=False)
        frame = np.asarray(pending) if pending is not None else None
        pending = dev
        ms = (clock() - t0) * 1e3
        ema_ms = ms if ema_ms is None else 0.9 * ema_ms + 0.1 * ms
        if frame is not None:
            for k in win.poll_keys():
                if k == "esc":
                    return ema_ms
                sess.handle_key(k)
            win.blit(frame)
        n += 1
        if frames and n >= frames:
            return ema_ms
        if period:
            left = period - (clock() - t0)
            if left > 0:
                sleep(left)


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ntsc-x11-torch",
        description="real-time X11 window CRT (reference LIVE build)")
    ap.add_argument("image", nargs="?")
    ap.add_argument("-s", "--system", default="NTSC")
    ap.add_argument("-W", "--outw", type=int, default=832)
    ap.add_argument("-H", "--outh", type=int, default=624)
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--noise", type=int, default=12)
    args = ap.parse_args(argv)

    try:
        if not os.environ.get("DISPLAY"):
            raise RuntimeError("no $DISPLAY")
        win = XWindow(args.outw, args.outh)
    except (RuntimeError, OSError) as e:
        print(f"X11 unavailable ({e}); falling back to the terminal "
              f"frontend (ntsc-live-torch)", file=sys.stderr)
        from ntsc_crt_tpu_torch.apps import term_live
        return term_live.main(argv, device=device)

    from ntsc_crt_tpu_torch.apps.live import LiveSession
    from ntsc_crt_tpu_torch.models.systems import SYSTEMS
    cfg = SYSTEMS[args.system.upper()]
    if args.image:
        from ntsc_crt_tpu_torch.utils import imageio
        img = imageio.read_image(args.image)
    elif cfg.kind == "nes":
        img = np.random.RandomState(0).randint(0, 64, (240, 256), np.uint16)
    else:
        from ntsc_crt_tpu_torch.utils.testcard import test_card
        img = test_card()
    try:
        sess = LiveSession(cfg, outw=args.outw, outh=args.outh,
                           noise=args.noise, device=device)
        ema = run_loop(sess, img, win, fps=args.fps, frames=args.frames)
        print(f"steady-state {ema:.2f} ms/frame", file=sys.stderr)
    finally:
        win.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
