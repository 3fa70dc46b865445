"""Frozen: ``init_eq`` / ``init_iir`` of ``ntsc_crt_tpu_torch/ops/filters.py``
and the plain row marches of ``ops/kernels/rowfilters.py`` (K7, K8), as
they stood when the benchmark was defined; and the float32 march of the
benchmark's control."""

from __future__ import annotations

from typing import NamedTuple

import torch

from crt_bench.reference.fixedpoint import (EXP_ONE, EXP_P, EXP_PI, T14_PI,
                                            host_expx, host_sincos14,
                                            host_tdiv, i32)


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


def iir_lowpass_rows_plain(x: torch.Tensor, c) -> torch.Tensor:
    """The same march in plain torch along the LAST axis of x int32
    [..., T], c broadcastable to x[..., 0]: one vectorised step per
    sample."""
    xs = i32(x).movedim(-1, 0)
    c = i32(c, device=xs.device)
    h = torch.zeros_like(xs[0])
    out = torch.empty_like(xs)
    for t in range(xs.shape[0]):
        h = h + (((xs[t] - h) * c) >> EXP_P)
        out[t] = h
    return out.movedim(0, -1)


def eq_threeband_rows_plain(x: torch.Tensor, lf, hf, g0, g1,
                            g2) -> torch.Tensor:
    """The same march in plain torch along the LAST axis of x int32
    [..., T], each coefficient broadcastable to x[..., 0] (so Y/I/Q can
    ride a channel axis in one march)."""
    xs = i32(x).movedim(-1, 0)
    dev = xs.device
    lf, hf, g0, g1, g2 = (i32(v, device=dev) for v in (lf, hf, g0, g1, g2))
    zero = torch.zeros_like(xs[0])
    fL = [zero] * 4
    fH = [zero] * 4
    h = [zero] * 3
    out = torch.empty_like(xs)
    for t in range(xs.shape[0]):
        sx = xs[t]
        prevL, prevH = sx, sx
        for k in range(4):
            fL[k] = fL[k] + ((lf * (prevL - fL[k]) + EQ_R) >> EQ_P)
            fH[k] = fH[k] + ((hf * (prevH - fH[k]) + EQ_R) >> EQ_P)
            prevL, prevH = fL[k], fH[k]
        out[t] = (((fL[3] * g0) >> EQ_P) + (((fH[3] - fL[3]) * g1) >> EQ_P)
                  + (((h[2] - fH[3]) * g2) >> EQ_P))
        h = [sx, h[0], h[1]]
    return out.movedim(0, -1)


def eq_threeband_rows_float(x: torch.Tensor, lf, hf, g0, g1,
                            g2) -> torch.Tensor:
    """eq_threeband_rows_plain in float32 without its rounding shifts, the
    result floored back to int32: the benchmark's control, a lower
    precision than the configurations state."""
    xs = x.to(torch.float32).movedim(-1, 0)
    dev = xs.device
    one = float(1 << EQ_P)
    lf, hf, g0, g1, g2 = (i32(v, device=dev).to(torch.float32) / one
                          for v in (lf, hf, g0, g1, g2))
    zero = torch.zeros_like(xs[0])
    fL = [zero] * 4
    fH = [zero] * 4
    h = [zero] * 3
    out = torch.empty_like(xs)
    for t in range(xs.shape[0]):
        sx = xs[t]
        prevL, prevH = sx, sx
        for k in range(4):
            fL[k] = fL[k] + lf * (prevL - fL[k])
            fH[k] = fH[k] + hf * (prevH - fH[k])
            prevL, prevH = fL[k], fH[k]
        out[t] = fL[3] * g0 + (fH[3] - fL[3]) * g1 + (h[2] - fH[3]) * g2
        h = [sx, h[0], h[1]]
    return torch.floor(out).to(torch.int32).movedim(0, -1)
