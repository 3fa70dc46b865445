"""Pixel formats (crt_core.h:62-67) and packing between the framework's
canonical RGB (h, w, 3) uint8 and the reference's six byte layouts.

The compute path is format-agnostic: the reference's format switches
(crt_ntsc.c:279-305 on read, crt_core.c:613-656 on write) only permute
bytes, so both ends convert at the API boundary.  Alpha is always written
0xff on 4-byte formats, matching the reference; it is never read.

The port's own copy of ``ntsc_crt_tpu/utils/formats.py`` (numpy only; a
test holds the two equal)."""

from __future__ import annotations

import numpy as np

RGB, BGR, ARGB, RGBA, ABGR, BGRA = range(6)

_NAMES = {"rgb": RGB, "bgr": BGR, "argb": ARGB, "rgba": RGBA,
          "abgr": ABGR, "bgra": BGRA}


def bpp(fmt: int) -> int:
    """crt_bpp4fmt (crt_core.c:63-78); 0 for unknown formats."""
    if fmt in (RGB, BGR):
        return 3
    if fmt in (ARGB, RGBA, ABGR, BGRA):
        return 4
    return 0


def by_name(name: str) -> int:
    return _NAMES[name.lower()]


# byte position of (R, G, B) within one pixel, per format
_RGB_POS = {
    RGB: (0, 1, 2), BGR: (2, 1, 0),
    RGBA: (0, 1, 2), BGRA: (2, 1, 0),
    ARGB: (1, 2, 3), ABGR: (3, 2, 1),
}
_ALPHA_POS = {RGBA: 3, BGRA: 3, ARGB: 0, ABGR: 0}


def to_rgb(buf: np.ndarray, fmt: int) -> np.ndarray:
    """(h, w, bpp) raw bytes in `fmt` -> canonical (h, w, 3) uint8 RGB."""
    r, g, b = _RGB_POS[fmt]
    return np.stack([buf[..., r], buf[..., g], buf[..., b]], axis=-1)


def from_rgb(rgb: np.ndarray, fmt: int) -> np.ndarray:
    """Canonical (h, w, 3) uint8 RGB -> (h, w, bpp) raw bytes in `fmt`."""
    out = np.zeros(rgb.shape[:2] + (bpp(fmt),), np.uint8)
    r, g, b = _RGB_POS[fmt]
    out[..., r] = rgb[..., 0]
    out[..., g] = rgb[..., 1]
    out[..., b] = rgb[..., 2]
    if fmt in _ALPHA_POS:
        out[..., _ALPHA_POS[fmt]] = 0xFF
    return out
