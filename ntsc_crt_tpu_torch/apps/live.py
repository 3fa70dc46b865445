"""Interactive real-time session — the library equivalent of the reference's
LIVE build (crt_main.c:284-557, controls.txt).

The port of ``ntsc_crt_tpu/apps/live.py``.  The reference wires keyboard
callbacks to `struct CRT` fields and runs a 60 Hz modulate/demodulate loop
with phosphor fade and interlace toggling.  Here the same loop is a host
object holding the CRT state on the CUDA card (``device=None``) or the
device it is given; `handle_key` implements the exact key map from
controls.txt so embedders (emulators, notebooks, a terminal front end)
drive it directly.  The knobs reach the step as host ints, which cost no
host-to-device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ntsc_crt_tpu_torch.models import pipeline, video
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import SystemConfig


class PendingFrame:
    """A frame on its way to the host: a non-blocking copy into pinned
    memory and the CUDA event after it.  ``np.asarray(frame)`` waits for
    the event, then reads the buffer; until then the host runs on."""

    def __init__(self, frame: torch.Tensor):
        self._event = None
        if frame.is_cuda:
            self._buf = torch.empty(frame.shape, dtype=frame.dtype,
                                    pin_memory=True)
            self._buf.copy_(frame, non_blocking=True)
            self._event = torch.cuda.Event()
            # the copy's stream is the frame's card's, which need not be
            # the current device
            self._event.record(torch.cuda.current_stream(frame.device))
        else:
            self._buf = frame.contiguous()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._buf.numpy()
        return a if dtype is None else a.astype(dtype)


@dataclasses.dataclass
class LiveSession:
    """60 Hz-style interactive loop state (crt_main.c:284-557)."""

    cfg: SystemConfig
    outw: int = 832
    outh: int = 624
    noise: int = 0
    hue: int = 0                 # artifact hue (encoder)
    monitor_hue: int = 0         # decoding hue (7/8 keys)
    brightness: int = 0
    contrast: int = 180
    saturation: int = 10
    black_point: int = 0
    white_point: int = 100
    blend: int = 0
    scanlines: int = 0
    color: bool = True
    raw: bool = False
    progressive: bool = False
    fadephos: bool = True
    field: int = 0
    frame: int = 0
    dot_crawl_offset: int = 0
    v_fac: int = 0               # vertical stretch (crt_core.h:86)
    # the reference's compile-time build variants
    do_bloom: bool = False       # CRT_DO_BLOOM (crt_core.h:70)
    eq_mode: str = "threeband"   # USE_CONVOLUTION conv7/6/5/4 (crt_core.c:85)
    do_vsync: bool = True        # CRT_DO_VSYNC (crt_core.h:71)
    do_hsync: bool = True        # CRT_DO_HSYNC (crt_core.h:72)
    draw_border: bool = False    # NES_BORDER (crt_nes.c:69)
    border_color: int = 0
    optimized: bool = True       # NES_OPTIMIZED (crt_nes.c:63)
    device: Any = None           # None: the CUDA card

    def __post_init__(self):
        self.device = pipeline.resolve_device(self.device)
        self.state = pipeline.crt_init(self.cfg, self.outw, self.outh,
                                       device=self.device)
        self._img = None
        self._img_key = None

    def _mon(self) -> MonitorParams:
        return MonitorParams(
            hue=self.monitor_hue, brightness=self.brightness,
            contrast=self.contrast, saturation=self.saturation,
            black_point=self.black_point, white_point=self.white_point,
            blend=self.blend, scanlines=self.scanlines)

    def _advance(self, img: torch.Tensor) -> None:
        """One display frame (displaycb, crt_main.c:454-497)."""
        if self.cfg.cc_vper > 1:
            self.dot_crawl_offset = (self.dot_crawl_offset + 1) % self.cfg.cc_vper
        if self.field == 0:
            self.frame ^= 1                       # crt_main.c:482-484
        st = self.state
        out_prev = (video.fade_phosphors(st.out) if self.fadephos
                    else torch.zeros_like(st.out))  # crt_main.c:459-463
        self.state = pipeline.step(
            self.cfg, st._replace(out=out_prev), img, field=self.field,
            frame=self.frame, hue=self.hue, noise=self.noise, mon=self._mon(),
            as_color=1 if self.color else 0, raw=self.raw,
            dot_crawl_offset=self.dot_crawl_offset, v_fac=self.v_fac,
            do_bloom=self.do_bloom, eq_mode=self.eq_mode,
            do_vsync=self.do_vsync, do_hsync=self.do_hsync,
            draw_border=self.draw_border, border_color=self.border_color,
            optimized=self.optimized)
        if not (self.progressive or self.cfg.progressive):
            self.field ^= 1                       # crt_main.c:492-494

    def tick(self, img) -> np.ndarray:
        """One display frame; returns the full output on the host.
        img: (h, w, 3) uint8 RGB, or (h, w) uint16 PPU indices for NES."""
        self._advance(torch.as_tensor(np.asarray(img), device=self.device))
        return self.state.out.cpu().numpy()

    def tick_fast(self, img, preview_hw=None, fetch: bool = True):
        """One display frame with the image kept on the device, cached by
        object identity — pass a NEW array for new content.
        preview_hw=(rows, cols) returns a strided-downsampled preview (top and
        bottom pixel pairs for half-block cells) instead of the full frame,
        so less comes back to the host.  fetch=False returns a PendingFrame
        whose copy to the host is already under way: display loops
        double-buffer with it (``np.asarray`` waits for the copy)."""
        if self._img is None or self._img_key != id(img):
            self._img = torch.as_tensor(np.asarray(img), device=self.device)
            self._img_key = id(img)
        self._advance(self._img)
        preview = self.state.out
        if preview_hw is not None:
            rows, cols = preview_hw
            h, w = self.outh, self.outw
            ph = min(2 * rows, h)
            pw = min(cols, w)
            preview = preview[::max(1, h // ph)][:ph,
                                                 ::max(1, w // pw)][:, :pw]
        if not fetch:
            return PendingFrame(preview)
        return preview.cpu().numpy()

    def reset(self):
        """'r' — crt_reset defaults (crt_core.c:250-261)."""
        self.monitor_hue = 0
        self.saturation = 10
        self.brightness = 0
        self.contrast = 180
        self.black_point = 0
        self.white_point = 100

    def handle_key(self, key: str):
        """The controls.txt key map (crt_main.c:310-435)."""
        k = key
        if k == "q":
            self.black_point += 1
        elif k == "a":
            self.black_point -= 1
        elif k == "w":
            self.white_point += 1
        elif k == "s":
            self.white_point -= 1
        elif k == "r":
            self.reset()
        elif k == "f":
            self.field ^= 1
        elif k == "e":
            self.progressive = not self.progressive
        elif k == "t":
            self.raw = not self.raw
        elif k == "m":
            self.fadephos = not self.fadephos
        elif k == "g":
            self.scanlines ^= 1
        elif k == "b":
            self.blend ^= 1
        elif k == " ":
            self.color = not self.color
        elif k == "up":
            self.brightness += 1
        elif k == "down":
            self.brightness -= 1
        elif k == "right":
            self.contrast += 1
        elif k == "left":
            self.contrast -= 1
        elif k == "1":
            self.saturation -= 1
        elif k == "2":
            self.saturation += 1
        elif k == "3":
            self.noise = max(0, self.noise - 1)
        elif k == "4":
            self.noise += 1
        elif k == "5":
            self.hue = (self.hue - 1) % 360
        elif k == "6":
            self.hue = (self.hue + 1) % 360
        elif k == "7":
            self.monitor_hue = (self.monitor_hue - 1) % 360
        elif k == "8":
            self.monitor_hue = (self.monitor_hue + 1) % 360
