"""The yardstick of the bloom kernels' rooflines: the work K2 in its bloom
mode, ``bloom_line_width`` and K6 in its bloom mode must do for a cell's
shapes.  The card's peaks and the bound are ``crt_bench/work.py``'s.

The per-sample, per-pixel and per-chunk counts are frozen copies of
``chip_smoke.work_decode`` (bloom), ``work_line_width`` and
``work_place`` (bloom) as they stood when the bloom cell was defined; the
bytes are each input read once and each output written once.  They are
computed from the cell's shapes alone, never from a kernel's arguments or
the run's data, so they read the same work whatever implements it.  Where
the work depends on the data, each counts the least these shapes can
need:

* K2's march runs to each line's last drawn pixel, which the line's width
  sets; it is counted at the least width the energy EMA can reach on each
  line at the configuration's noise level, every line's sum at its most;
* ``bloom_line_width`` reads each line's window of av_len samples, which
  do not overlap while the lines' windows start at one sample (a steady
  hsync);
* K6 reads the previous rows a slot of the less demanding field parity
  needs, and without blend none of the undrawn pixels' rows.

A change to what these kernels compute is corrected here by a benchmark
change.
"""

from __future__ import annotations

from crt_bench.reference_bloom.kernels import eq_len
from crt_bench.work import EQ3_OPS


def _tdiv(a: int, b: int) -> int:
    """C's truncating division."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def least_line_widths(L: int, av_len: int, noise: int) -> list[int]:
    """Each line's least drawn width: the energy EMA from 16384/8 driven by
    ((max_e >> 1) - s) << 10 / max_e with every line's sum s at its most,
    127 * av_len (crt_core.c:512-520)."""
    max_e = (128 + _tdiv(noise, 2)) * av_len
    drive = _tdiv(((max_e >> 1) - 127 * av_len) << 10, max_e)
    e, out = 16384 // 8, []
    for _ in range(L):
        e = _tdiv(e * 123, 128) + drive
        out.append((av_len * 112 // 128) + (e >> 9))
    return out


def decode_rows_bloom(B: int, L: int, H: int, V: int, av_len: int,
                      outw: int, cc: int, noise: int) -> tuple[int, int]:
    """(bytes, int32 ops) of K2 in its bloom mode over B frames of L lines:
    the L + 1 field rows the lines read, each line's row, shift, waves (cc
    each for I and Q), brightness, contrast, pixel step and EQ start, the
    RGB pixels out.  A line marches to its last pixel's right source at
    its least width, at 8 + the three EQs + 6 a sample; per pixel 54."""
    n_eq = eq_len(av_len, cc)
    march = 0
    for w in least_line_widths(L, av_len, noise):
        last = max(((w << 12) // outw * (outw - 1)) >> 12, 0)
        march += min(last + 1, n_eq - 1) + 1
    nbytes = (B * min(L + 1, V) * H + B * L * 4 * 6 + 2 * B * L * cc * 4
              + B * L * outw * 3)
    return nbytes, B * march * (8 + EQ3_OPS + 6) + B * L * outw * 54


def bloom_line_width(B: int, L: int, av_len: int) -> tuple[int, int]:
    """(bytes, int32 ops) of bloom_line_width over B frames of L lines: each
    line's av_len window samples, its row and window start, max_e, the
    energies out.  A dp4a and a mask select a window word; per line 40."""
    win = B * L * av_len
    return win + B * L * 4 * 3 + B * 4, (win // 4) * 2 + B * L * 40


def _old_rows(L: int, ratio: int, fp: int, scanlines: int, blend: bool,
              odd: bool) -> int:
    """The previous frame's rows a slot's K6 reads: those kept (scanline
    gaps, the odd field's clips) and, with blend, each group's beg row."""
    need = set()
    for r in range(ratio * L):
        k, j = divmod(r, ratio)
        keep = ((j - fp) % ratio if odd else j) >= ratio - scanlines
        if fp and odd:
            keep = (keep or (j < fp and k == 0)
                    or (j > fp and j >= ratio - scanlines and k == L - 1))
        if keep:
            need.add(r)
        elif blend:
            src = max(k - 1, 0) if odd and j < fp else k
            need.add(ratio * src + (fp if odd else 0))
    return len(need)


def place_rows_bloom(B: int, L: int, outw: int, ratio: int, blend: bool,
                     scanlines: int) -> tuple[int, int]:
    """(bytes, int32 ops) of K6 in its bloom mode over B frames of L lines
    of outw pixels placed ratio rows each: the lines, each slot's field
    shift, each line's pixel step and first sample, the previous rows read
    (_old_rows at the parity that reads fewer), the output.  Per 16-byte
    chunk out: 30, the blend 16, the bloom mode's pixel tests 40."""
    fp = ((((ratio * L << 16) // L) + 32768) >> 16) // 2
    row = outw * 3
    old = min(_old_rows(L, ratio, fp, scanlines, blend, odd)
              for odd in (False, True))
    out = B * ratio * L * row
    nbytes = B * L * row + B * 4 + out + B * old * row + 2 * B * L * 4
    return nbytes, out // 16 * (30 + (16 if blend else 0) + 40)
