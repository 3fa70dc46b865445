"""Bandlimiting filters with exact reference integer semantics.

Counterpart of ``ntsc_crt_tpu/ops/filters.py``:

* encode side — a 1-pole IIR low-pass per Y/I/Q channel, state reset per
  scanline (crt_ntsc.c:89-126);
* decode side — a 3-band equalizer built from two cascaded 4-stage one-pole
  low-pass chains plus a 3-deep delay line (crt_core.c:151-233), or the
  short FIR of the reference's USE_CONVOLUTION build (crt_core.c:96-147).

Both round or truncate on every sample, so the recurrences are serial along
x.  ``iir_lowpass`` and ``eq_threeband`` flatten the lead dims to rows, as
the JAX ops do, and hand them to kernels K7 and K8 (ops/kernels/
rowfilters.py): a CUDA tensor launches the kernel, a CPU tensor marches x in
a Python loop, vectorised over every row.  Under a spatial group
(parallel/spatial.py) the rows split over its cards, as the JAX ops' do
(filters.py:135, :176).  The HIPASS form of the IIR and
the convolution EQ stay plain torch on every device, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ntsc_crt_tpu_torch.ops.fixedpoint import (
    EXP_ONE,
    EXP_PI,
    T14_PI,
    host_expx,
    host_sincos14,
    host_tdiv,
    i32,
)
from ntsc_crt_tpu_torch.ops.kernels import rowfilters
from ntsc_crt_tpu_torch.ops.kernels.rowfilters import EQ_P
from ntsc_crt_tpu_torch.parallel import spatial


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


def _rows(s: torch.Tensor, coefs):
    """s int32 [..., n] as (R, n) rows and each coefficient broadcast to the
    lead dims as (R,) — JAX filters.py:131-133, 171-174."""
    s = i32(s)
    lead = s.shape[:-1]
    rows = s.reshape(-1, s.shape[-1]).contiguous()
    return rows, [torch.broadcast_to(i32(c, device=s.device), lead)
                  .reshape(-1).contiguous() for c in coefs]


def iir_lowpass(s: torch.Tensor, c, hipass: bool = False) -> torch.Tensor:
    """h += ((s - h) * c) >> 11 marched along the LAST axis, h reset to 0
    (crt_ntsc.c:117-126).  s: int32 [..., n]; c broadcastable to s[..., 0].
    Returns the filtered sequence; hipass=True returns s - h instead, the
    reference's HIPASS form (crt_ntsc.c:114-126)."""
    if hipass:
        s = i32(s)
        return s - rowfilters.iir_lowpass_rows_plain(s, c)
    rows, (crow,) = _rows(s, (c,))
    return spatial.shard_rows_call(rowfilters.iir_lowpass_rows, rows,
                                   crow).reshape(s.shape)


def eq_threeband(s: torch.Tensor, lf, hf, g_lo, g_mid, g_hi) -> torch.Tensor:
    """Exact eqf() marched along the LAST axis with the state reset per line
    (crt_core.c:198-233).  s: int32 [..., n]; coefficients broadcastable to
    s[..., 0], so Y/I/Q can ride a channel axis in one march."""
    rows, cs = _rows(s, (lf, hf, g_lo, g_mid, g_hi))
    return spatial.shard_rows_call(rowfilters.eq_threeband_rows, rows,
                                   *cs).reshape(s.shape)


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
