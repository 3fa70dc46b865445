"""The yardstick of the NES cell's rooflines: the work K13 (``nes_square``)
and the row placement must do for a cell's shapes.  The card's peaks and
the bound are ``crt_bench/work.py``'s.

K13's counts are a frozen copy of ``chip_smoke.work_nes`` as it stood when
the NES cell was defined.  The placement's is a floor that reads the same
work whatever implements it (K6, torch gathers, a later kernel): each
decoded line's pixels read once and the output written once, at blend 0
and no scanline gaps, where no previous row is read.  Both are computed
from the cell's shapes alone, never from a kernel's arguments.  A change
to what these compute is corrected here by a benchmark change.
"""

from __future__ import annotations

from crt_bench.reference.systems import SystemConfig

SQUARE_TABLE = 512 * 12      # the 4-phase sums, int32 (nes.square_table)
BURST_SINES = 719            # int32 (nes.burst_sines)
KNOBS = 5                    # dco, black_point, white_point, border, hue


def picture_samples(cfg: SystemConfig) -> int:
    """The field samples a slot's picture writes: desth rows of destw from
    (yo, xo), a row past H spilling into the next, none past the field (the
    optimized build, no border).  Rows of destw <= H samples never
    overlap."""
    V, H = cfg.vres, cfg.hres
    xo, yo = cfg.av_beg & ~3, cfg.top
    return sum(max(0, min(r * H + xo + cfg.av_len, V * H) - (r * H + xo))
               for r in range(yo, yo + cfg.lines))


def nes_square(cfg: SystemConfig, B: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, int32 ops) of K13 over B frames of h x w PPU pixels (2
    bytes each) into cfg's field: the PPU pixels, the square table, the
    knobs and the burst's sines read, every field byte and the ccf export
    (cc_vper x cc_samples int32) written.  Ops: 10 a picture sample, 1
    every other field sample, and a slot's stored-byte table, 12 x 512
    entries of 6."""
    field = cfg.vres * cfg.hres
    n = picture_samples(cfg)
    nbytes = (B * h * w * 2 + SQUARE_TABLE * 4 + B * KNOBS * 4
              + BURST_SINES * 4 + B * field
              + B * cfg.cc_vper * cfg.cc_samples * 4)
    ops = B * (n * 10 + (field - n) + 12 * 512 * 6)
    return nbytes, ops


def place_rows(B: int, L: int, outw: int, outh: int) -> tuple[int, int]:
    """(bytes, int32 ops) of the row placement's floor over B frames: the
    L decoded lines of outw RGB pixels read once, the outh x outw RGB
    output written once; no operation counted."""
    return B * L * outw * 3 + B * outh * outw * 3, 0
