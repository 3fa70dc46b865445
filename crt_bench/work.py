"""The yardstick of the kernel rooflines: the work K1 (encode_rows) and K2
(decode_rows, 3-band EQ) must do for a cell's shapes, and the card's peaks.

The per-sample and per-pixel counts are frozen copies of
``chip_smoke.work_encode`` / ``work_decode`` as they stood when this
benchmark was defined; the bytes are each input read once and each output
written once.  They are computed from the cell's shapes (batch, the
system's lines and active samples, the input and output sizes), never from
a kernel's arguments, so they read the same work whatever implements it.
A change to what K1 or K2 computes is corrected here by a benchmark
change.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
# int32 source operations a second: the peak pattern of the port's probe
# kernel (K10, ops/kernels/probe.py) as measured on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit, recorded in PERF.md's table of kernels;
# frozen, so that a change to the probe does not move the yardstick
INT32_OPS_PER_S = 56.71e12
EQ3_OPS = 3 * 50              # the three 3-band EQ marches, per sample


def encode_rows(B: int, h: int, w: int, desth: int, destw: int, cc: int,
                band: bool = True) -> tuple[int, int]:
    """(bytes, int32 ops) of K1 over B frames of h x w RGB into desth rows
    of destw samples: the image, each row's source row and carrier tables
    (cc entries each for I and Q), gain and base per frame, the int8 rows
    out.  Per sample: resample index 2, RGB->YIQ 18, IIR 12, carrier 4,
    IRE 5, clamp 2 (31 without bandlimiting)."""
    nbytes = (B * h * w * 3 + B * desth * 4 + 2 * B * desth * cc * 4
              + 2 * B * 4 + B * desth * destw)
    return nbytes, B * desth * destw * (43 if band else 31)


def decode_rows(B: int, L: int, H: int, av_len: int, outw: int,
                cc: int) -> tuple[int, int]:
    """(bytes, int32 ops) of K2 in its 3-band mode over B frames of L lines
    of H samples: the L + 4 field rows it is handed, each line's shift,
    waves (cc each for I and Q), brightness and contrast, the RGB pixels
    out.  Per sample: Y/I/Q 5, the three EQs, output shifts 3; per pixel:
    lerp 17, YIQ->RGB, contrast and clamp 27."""
    nbytes = (B * (L + 4) * H + B * L * 4 + 2 * B * L * cc * 4
              + 2 * B * L * 4 + B * L * outw * 3)
    return nbytes, B * L * (av_len * (8 + EQ3_OPS) + outw * 44)


def bound_s(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
