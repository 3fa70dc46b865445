"""K7 ``iir_lowpass_rows`` and K8 ``eq_threeband_rows``: a serial integer
filter marched along each row, state reset at the row start.

* K7 — the encoder's 1-pole IIR, h += ((s - h) * c) >> 11 from h = 0
  (crt_ntsc.c:117-126);
* K8 — the decoder's exact 3-band eqf(): two cascaded 4-stage one-pole
  chains and a 3-deep history (crt_core.c:198-233).

Each row has its own coefficients.  Replaces
``ntsc_crt_tpu/ops/pallas/filters_pallas.py::iir_lowpass_rows`` and
``::eq_threeband_rows``; ``ops/filters.py``'s ``iir_lowpass`` and
``eq_threeband`` reach them as the JAX ops reach theirs.  A CPU tensor runs
the plain torch march below; a CUDA tensor launches csrc/rowfilters.cu.
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops.fixedpoint import EXP_P, i32

EQ_P = 16  # crt_core.c:155
EQ_R = 1 << (EQ_P - 1)

# kernel launches since the last reset (read by chip_smoke.py)
IIR_LAUNCHES = 0
EQ_LAUNCHES = 0


def _check_rows(name, x, coefs, dev):
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only
    R, T = x.shape
    build.check("x", x, torch.int32, (R, T), dev)
    for k, c in coefs.items():
        build.check(k, c, torch.int32, (R,), dev)
    if R >= 2**31 or R * T >= 2**40:
        raise ValueError(f"{name}: {R} rows of {T} are too many")
    return build, R, T


def iir_lowpass_rows(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x int32 (R, T), c int32 (R,) -> int32 (R, T): each row low-passed."""
    if x.device.type == "cpu":
        return iir_lowpass_rows_plain(x, c)
    global IIR_LAUNCHES
    build, R, T = _check_rows("iir_lowpass_rows", x, dict(c=c), x.device)
    y = torch.empty_like(x)
    build.launch("ntsc_iir_lowpass_rows", x.device, x.data_ptr(), c.data_ptr(),
                 y.data_ptr(), R, T)
    IIR_LAUNCHES += 1
    return y


def eq_threeband_rows(x: torch.Tensor, lf: torch.Tensor, hf: torch.Tensor,
                      g0: torch.Tensor, g1: torch.Tensor,
                      g2: torch.Tensor) -> torch.Tensor:
    """x int32 (R, T); lf, hf, g0 (g_lo), g1 (g_mid), g2 (g_hi) int32 (R,)
    -> int32 (R, T): each row through the 3-band EQ."""
    if x.device.type == "cpu":
        return eq_threeband_rows_plain(x, lf, hf, g0, g1, g2)
    global EQ_LAUNCHES
    coefs = dict(lf=lf, hf=hf, g0=g0, g1=g1, g2=g2)
    build, R, T = _check_rows("eq_threeband_rows", x, coefs, x.device)
    y = torch.empty_like(x)
    build.launch("ntsc_eq_threeband_rows", x.device, x.data_ptr(),
                 *(c.data_ptr() for c in coefs.values()), y.data_ptr(), R, T)
    EQ_LAUNCHES += 1
    return y


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
