"""Bandlimiting filters with exact reference integer semantics.

Counterpart of ``ntsc_crt_tpu/ops/filters.py``:

* encode side — a 1-pole IIR low-pass per Y/I/Q channel, state reset per
  scanline (crt_ntsc.c:89-126);
* decode side — a 3-band equalizer built from two cascaded 4-stage one-pole
  low-pass chains plus a 3-deep delay line (crt_core.c:151-233), or the
  short FIR of the reference's USE_CONVOLUTION build (crt_core.c:96-147).

Both round or truncate on every sample, so the recurrences are serial along
x.  These plain versions march x in a Python loop, vectorised over every
row and channel; the CUDA kernels (ops/kernels/) fuse them per row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ntsc_crt_tpu_torch.ops.fixedpoint import (
    EXP_ONE,
    EXP_P,
    EXP_PI,
    T14_PI,
    host_expx,
    host_sincos14,
    host_tdiv,
    i32,
)

EQ_P = 16  # crt_core.c:155
EQ_R = 1 << (EQ_P - 1)


class EQCoefs(NamedTuple):
    lf: int
    hf: int
    g_lo: int
    g_mid: int
    g_hi: int


def init_eq(f_lo: int, f_hi: int, rate: int, g_lo: int, g_mid: int,
            g_hi: int) -> EQCoefs:
    """Exact init_eq (crt_core.c:171-196) at EQ_P == 16."""
    sn, _ = host_sincos14(host_tdiv(T14_PI * f_lo, rate))
    lf = 2 * (sn << (EQ_P - 15))
    sn, _ = host_sincos14(host_tdiv(T14_PI * f_hi, rate))
    hf = 2 * (sn << (EQ_P - 15))
    return EQCoefs(lf, hf, g_lo, g_mid, g_hi)


def init_iir(freq: int, limit: int) -> int:
    """Exact init_iir coefficient (crt_ntsc.c:98-106): c for h += (s-h)*c >> 11."""
    rate = host_tdiv(freq << 9, limit)
    return EXP_ONE - host_expx(-host_tdiv(EXP_PI << 9, rate))


def iir_lowpass(s: torch.Tensor, c) -> torch.Tensor:
    """h += ((s - h) * c) >> 11 marched along the LAST axis, h reset to 0
    (crt_ntsc.c:117-126).  s: int32 [..., n]; c broadcastable to s[..., 0].
    Returns the filtered sequence."""
    xs = i32(s).movedim(-1, 0)
    c = i32(c, device=xs.device)
    h = torch.zeros_like(xs[0])
    out = torch.empty_like(xs)
    for x in range(xs.shape[0]):
        h = h + (((xs[x] - h) * c) >> EXP_P)
        out[x] = h
    return out.movedim(0, -1)


def eq_threeband(s: torch.Tensor, lf, hf, g_lo, g_mid, g_hi) -> torch.Tensor:
    """Exact eqf() marched along the LAST axis with the state reset per line
    (crt_core.c:198-233).  s: int32 [..., n]; coefficients broadcastable to
    s[..., 0], so Y/I/Q can ride a channel axis in one march."""
    xs = i32(s).movedim(-1, 0)
    dev = xs.device
    lf, hf, g0, g1, g2 = (i32(v, device=dev) for v in (lf, hf, g_lo, g_mid,
                                                       g_hi))
    zero = torch.zeros_like(xs[0])
    fL = [zero] * 4
    fH = [zero] * 4
    h = [zero] * 3
    out = torch.empty_like(xs)
    for x in range(xs.shape[0]):
        sx = xs[x]
        prevL, prevH = sx, sx
        for k in range(4):
            fL[k] = fL[k] + ((lf * (prevL - fL[k]) + EQ_R) >> EQ_P)
            fH[k] = fH[k] + ((hf * (prevH - fH[k]) + EQ_R) >> EQ_P)
            prevL, prevH = fL[k], fH[k]
        out[x] = (((fL[3] * g0) >> EQ_P) + (((fH[3] - fL[3]) * g1) >> EQ_P)
                  + (((h[2] - fH[3]) * g2) >> EQ_P))
        h = [sx, h[0], h[1]]
    return out.movedim(0, -1)


# taps -> (weights, shift) of the convolution EQ builds (crt_core.c:130-145);
# only valid for 4-sample chroma systems (crt_core.c:90-94)
_CONV_EQ_KERNELS = {
    7: ([1, 4, 7, 8, 7, 4, 1], 5),
    6: ([1, 3, 4, 4, 3, 1], 4),
    5: ([1, 2, 2, 2, 1], 3),
    4: ([1, 1, 1, 1], 2),
}


def eq_convolution(s: torch.Tensor, taps: int = 7) -> torch.Tensor:
    """out_i = (sum_k w_k * s_{i-k}) >> shift along the last axis, zeros
    before the line start — eqf() in the USE_CONVOLUTION build."""
    weights, shift = _CONV_EQ_KERNELS[taps]
    s = i32(s)
    n = s.shape[-1]
    out = torch.zeros_like(s)
    for k, wk in enumerate(weights):
        if k < n:
            out[..., k:] += wk * s[..., :n - k]
    return out >> shift
