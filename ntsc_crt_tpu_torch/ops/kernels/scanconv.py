"""K9 ``scanconv_rows``: the static scan conversion of EQ'd Y/I/Q rows, and
the unfused decode chain that runs it.

Per row r and output pixel p: the lerp of samples s and s + 1 with the
12-bit weights of ``fastpath.lerp_resample_weights(T, outw)`` (a read at
s + 1 == T gives 0), YIQ -> RGB, contrast, clamp to 0..255, packed as
0x00RRGGBB (crt_core.c:555-611).

Replaces ``ntsc_crt_tpu/ops/pallas/scanconv_pallas.py::scanconv_rows``.  A
CPU tensor runs the plain torch version below; a CUDA tensor launches
csrc/scanconv.cu.

``decode_rows_unfused`` is the JAX decoder's unfused non-bloom branch
(``ntsc_crt_tpu/models/demodulate.py:983-1017, 1032-1034, 1061-1073``) with
K2's contract: align, demodulate, the 3-band EQ through
``filters.eq_threeband`` (K8), then K9.  It computes what K2 fuses, so the
two are held equal; the pipeline itself decodes through K2.  Under a
spatial group K8 and K9 each split their rows over its cards
(parallel/spatial.py), as at JAX ``demodulate.py:1067``.
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops import fastpath, filters
from ntsc_crt_tpu_torch.ops.kernels import decode
from ntsc_crt_tpu_torch.parallel import spatial


def scanconv_rows(oy: torch.Tensor, oi: torch.Tensor, oq: torch.Tensor,
                  contrast: torch.Tensor, *, outw: int) -> torch.Tensor:
    """oy/oi/oq int32 (R, T), contrast int32 (R,) -> packed RGB int32
    (R, outw)."""
    if oy.device.type == "cpu":
        return scanconv_rows_plain(oy, oi, oq, contrast, outw=outw)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = oy.device
    R, T = oy.shape
    for name, t in (("oy", oy), ("oi", oi), ("oq", oq)):
        build.check(name, t, torch.int32, (R, T), dev)
    build.check("contrast", contrast, torch.int32, (R,), dev)
    if not (T >= 1 and 1 <= outw and (T << 12) < 2**31 and R < 2**31):
        raise ValueError(f"scanconv_rows: bad geometry R={R} T={T} "
                         f"outw={outw}")
    out = torch.empty((R, outw), dtype=torch.int32, device=dev)
    build.launch("ntsc_scanconv_rows", dev, oy.data_ptr(), oi.data_ptr(),
                 oq.data_ptr(), contrast.data_ptr(), out.data_ptr(), R, T,
                 outw)
    return out


def scanconv_rows_plain(oy, oi, oq, contrast, *, outw: int) -> torch.Tensor:
    """The same conversion in plain torch: two gathers a channel from the
    rows with one zero sample appended."""
    T = oy.shape[1]
    s, Lw, Rw = fastpath.lerp_resample_weights(T, outw)
    dev = oy.device
    s = torch.as_tensor(s, device=dev).long()
    Lw = torch.as_tensor(Lw, device=dev)
    Rw = torch.as_tensor(Rw, device=dev)

    def lerp(v, sh):
        v = torch.nn.functional.pad(v, (0, 1))            # the zero tail
        return ((v[:, s] * Lw) >> sh) + ((v[:, s + 1] * Rw) >> sh)

    y, i, q = lerp(oy, 2), lerp(oi, 14), lerp(oq, 14)
    ct = contrast[:, None]
    r = ((((y + 3879 * i + 2556 * q) >> 12) * ct) >> 8).clamp(0, 255)
    g = ((((y - 1126 * i - 2605 * q) >> 12) * ct) >> 8).clamp(0, 255)
    b = ((((y - 4530 * i + 7021 * q) >> 12) * ct) >> 8).clamp(0, 255)
    return (r << 16) | (g << 8) | b


def demod_rows(field: torch.Tensor, line_row: torch.Tensor,
               shifts: torch.Tensor, waveI: torch.Tensor, waveQ: torch.Tensor,
               bright: torch.Tensor, *, av_len: int) -> torch.Tensor:
    """The EQ's input of every line, as K2 forms it: sig[t] = line l's
    samples from shifts[l] (its field row line_row[l] continuing into the
    next, decode.line_pairs), Y = sig + bright, I/Q = sig * wave[t % cc] >>
    9 (crt_core.c:538-543).  Returns int32 (B, L, 3, av_len)."""
    B, L = shifts.shape
    H = field.shape[2]
    ext = decode.line_pairs(field, line_row).reshape(B * L, 2 * H)
    sig = fastpath.shift_rows(ext, shifts.reshape(-1),
                              av_len).reshape(B, L, av_len)
    wv_i = fastpath.tile_period(waveI, av_len)
    wv_q = fastpath.tile_period(waveQ, av_len)
    return torch.stack([sig + bright[..., None], (sig * wv_i) >> 9,
                        (sig * wv_q) >> 9], dim=2)


def decode_rows_unfused(field: torch.Tensor, line_row: torch.Tensor,
                        shifts: torch.Tensor, waveI: torch.Tensor,
                        waveQ: torch.Tensor, bright: torch.Tensor,
                        contrast: torch.Tensor, *, coefs, av_len: int,
                        outw: int) -> torch.Tensor:
    """K2's 3-band decode (``decode.decode_rows`` with three EQCoefs) as
    separate passes: the same arguments, the same uint8 (B, L, outw, 3)
    result."""
    B, L = shifts.shape
    stacked = demod_rows(field, line_row, shifts, waveI, waveQ, bright,
                         av_len=av_len)                   # (B, L, 3, AV)
    per_chan = [torch.tensor([c[k] for c in coefs], dtype=torch.int32,
                             device=field.device) for k in range(5)]
    eqd = filters.eq_threeband(stacked, *per_chan)
    flat = lambda v: v.reshape(B * L, av_len).contiguous()  # noqa: E731
    packed = spatial.shard_rows_call(
        scanconv_rows, flat(eqd[:, :, 0] << 4), flat(eqd[:, :, 1] >> 3),
        flat(eqd[:, :, 2] >> 3), contrast.reshape(B * L).contiguous(),
        outw=outw)
    rgb = torch.stack([packed >> 16, packed >> 8, packed], dim=-1) & 0xFF
    return rgb.to(torch.uint8).reshape(B, L, outw, 3)
