"""Real-time terminal front-end for the live session — the runnable
equivalent of the reference's LIVE build (crt_main.c:284-557), which opens a
60 Hz 832x624 window on the author's FW library and maps the keyboard to
monitor knobs (controls.txt).

Here the display is the terminal itself: each frame is downsampled and drawn
with 24-bit-color half-block cells (one character = two pixels), the
keyboard is read raw from stdin with the exact controls.txt key map
(apps/live.py), and the loop is capped at 60 Hz like `sys_sethz(60)`
(crt_main.c:513-516).  A status line reports the measured frame latency so
the 60 Hz budget is visible.  The port of ``ntsc_crt_tpu/apps/term_live.py``;
the session runs on the CUDA card (``main(..., device=...)`` from Python
picks another).

    python -m ntsc_crt_tpu_torch.apps.term_live [image.ppm] [-s SYSTEM]
        [--fps 60] [--frames N] [--no-display]

--frames N exits after N frames (headless/CI use); --no-display skips the
ANSI drawing but keeps timing (pure pipeline latency).
ESC quits.  Other keys: controls.txt (q/a w/s r f e t m g b space arrows
1-8 c for NES dot-crawl step where applicable).
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np

ESC = "\x1b"


def render_halfblocks(rgb: np.ndarray, cols: int, rows: int) -> str:
    """Downsample (h, w, 3) uint8 RGB to a cols x rows character grid of
    '▀' half-blocks (fg = top pixel, bg = bottom pixel, 24-bit ANSI)."""
    h, w = rgb.shape[:2]
    ph = rows * 2
    ys = (np.arange(ph) * h) // ph
    xs = (np.arange(cols) * w) // cols
    px = rgb[ys][:, xs]                      # (2*rows, cols, 3)
    top, bot = px[0::2], px[1::2]            # (rows, cols, 3)
    out = []
    for r in range(rows):
        run = []
        prev = None
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg_, bb = bot[r, c]
            key = (tr, tg, tb, br, bg_, bb)
            if key != prev:                  # elide repeated SGR sequences
                run.append(f"{ESC}[38;2;{tr};{tg};{tb}m"
                           f"{ESC}[48;2;{br};{bg_};{bb}m")
                prev = key
            run.append("▀")
        run.append(f"{ESC}[0m")
        out.append("".join(run))
    return "\n".join(out)


class RawKeys:
    """Non-blocking raw-mode stdin; decodes arrow-key escape sequences to
    the names live.handle_key expects.  No-op when stdin isn't a tty."""

    _ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}

    def __enter__(self):
        self._fd = None
        if sys.stdin.isatty():
            import termios
            import tty
            self._fd = sys.stdin.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self) -> list[str]:
        if self._fd is None:
            return []
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = os.read(self._fd, 1).decode(errors="ignore")
            if ch == ESC:
                seq = ""
                while select.select([sys.stdin], [], [], 0)[0] and len(seq) < 2:
                    seq += os.read(self._fd, 1).decode(errors="ignore")
                if seq.startswith("[") and seq[1:] in self._ARROWS:
                    keys.append(self._ARROWS[seq[1:]])
                else:
                    keys.append("esc")
            elif ch:
                keys.append(ch)
        return keys


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ntsc-live-torch",
        description="real-time terminal CRT (reference LIVE build, "
                    "crt_main.c:284-557)")
    ap.add_argument("image", nargs="?", help="PPM/BMP input (default: "
                    "built-in SMPTE-style test card)")
    ap.add_argument("-s", "--system", default="NTSC")
    ap.add_argument("-W", "--outw", type=int, default=832)
    ap.add_argument("-H", "--outh", type=int, default=624)
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--frames", type=int, default=0,
                    help="exit after N frames (0 = run until ESC)")
    ap.add_argument("--no-display", action="store_true")
    ap.add_argument("--noise", type=int, default=12)
    args = ap.parse_args(argv)

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

    sess = LiveSession(cfg, outw=args.outw, outh=args.outh, noise=args.noise,
                       device=device)
    period = 1.0 / args.fps if args.fps > 0 else 0.0

    try:
        cols, lines = os.get_terminal_size()
    except OSError:
        cols, lines = 100, 40
    rows = max(4, lines - 2)
    cols = max(16, min(cols, 200))

    n = 0
    ema_ms = None
    if not args.no_display:
        sys.stdout.write(f"{ESC}[2J")        # clear once
    # Double-buffer: dispatch frame N and issue its async host copy, then
    # display frame N-1 (whose copy has been in flight for a whole frame) —
    # the copy overlaps the next frame's work instead of waiting for it.
    preview_hw = (8, 8) if args.no_display else (rows, cols)
    pending = None
    with RawKeys() as kb:
        while True:
            t0 = time.perf_counter()
            dev = sess.tick_fast(img, preview_hw=preview_hw, fetch=False)
            frame = np.asarray(pending) if pending is not None else None
            pending = dev
            t1 = time.perf_counter()
            ms = (t1 - t0) * 1e3
            ema_ms = ms if ema_ms is None else (0.9 * ema_ms + 0.1 * ms)
            if frame is None:
                n += 1
                continue

            for k in kb.poll():
                if k == "esc":
                    if not args.no_display:
                        sys.stdout.write(f"{ESC}[0m\n")
                    return 0
                sess.handle_key(k)

            if not args.no_display:
                buf = render_halfblocks(frame, cols, rows)
                status = (f"{ESC}[0m{args.system} {args.outw}x{args.outh} "
                          f"frame {n}  {ema_ms:6.2f} ms/frame "
                          f"({1000.0 / max(ema_ms, 1e-6):5.1f} fps capable) "
                          f"noise={sess.noise} sat={sess.saturation} "
                          f"bright={sess.brightness} ESC=quit")
                sys.stdout.write(f"{ESC}[H{buf}\n{status[:cols]}")
                sys.stdout.flush()

            n += 1
            if args.frames and n >= args.frames:
                if not args.no_display:
                    sys.stdout.write(f"{ESC}[0m\n")
                print(f"\n{n} frames, steady-state {ema_ms:.2f} ms/frame "
                      f"({1000.0 / max(ema_ms, 1e-6):.1f} fps capable), "
                      f"target {period * 1e3:.1f} ms", file=sys.stderr)
                return 0
            if period:                       # 60 Hz cap (crt_main.c:513-516)
                left = period - (time.perf_counter() - t0)
                if left > 0:
                    time.sleep(left)


if __name__ == "__main__":
    sys.exit(main())
