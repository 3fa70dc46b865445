"""K2 ``decode_rows``: the per-line decode, three-band mode.

Per (frame, line) row: sig[t] = concat(rows[b, row0 + l], rows[b, row0 + l
+ 1])[shift + t] (the reference's flat `sig[pos + i]` reads,
crt_core.c:538-543); Y = sig + bright, I/Q = sig * wave[t % cc] >> 9; a
3-band EQ per channel (crt_core.c:206-233); oy << 4, oi >> 3, oq >> 3; the
static lerp scan conversion to outw pixels; YIQ -> RGB, contrast and clamp
(crt_core.c:555-611).

Replaces ``ntsc_crt_tpu/ops/pallas/decode_fused.py::decode_fused_rows`` in
three-band mode.  A CPU tensor runs the plain torch version below (the
portable decode of ``models/demodulate.py:983-1086``); a CUDA tensor
launches csrc/decode.cu.
"""

from __future__ import annotations

import ctypes

import torch

from ntsc_crt_tpu_torch.ops import fastpath, filters

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0


def decode_rows(rows: torch.Tensor, shifts: torch.Tensor, waveI: torch.Tensor,
                waveQ: torch.Tensor, bright: torch.Tensor,
                contrast: torch.Tensor, *, row0: int, coefs, av_len: int,
                outw: int) -> torch.Tensor:
    """rows int8 (B, NR, H) with NR >= row0 + L + 1; shifts int32 (B, L),
    each line's active-video start; waveI/waveQ int32 (B, L, cc), cc = 4 or
    5; bright/contrast int32 (B, L); coefs three filters.EQCoefs (Y, I, Q).
    Returns uint8 (B, L, outw, 3).  Samples past the two rows read as 0."""
    if rows.device.type == "cpu":
        return decode_rows_plain(rows, shifts, waveI, waveQ, bright, contrast,
                                 row0=row0, coefs=coefs, av_len=av_len,
                                 outw=outw)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    global LAUNCHES
    dev = rows.device
    B, NR, H = rows.shape
    L, cc = shifts.shape[1], waveI.shape[2]
    build.check("rows", rows, torch.int8, (B, NR, H), dev)
    build.check("shifts", shifts, torch.int32, (B, L), dev)
    build.check("waveI", waveI, torch.int32, (B, L, cc), dev)
    build.check("waveQ", waveQ, torch.int32, (B, L, cc), dev)
    build.check("bright", bright, torch.int32, (B, L), dev)
    build.check("contrast", contrast, torch.int32, (B, L), dev)
    if cc not in (4, 5):
        raise ValueError(f"decode_rows: cc must be 4 or 5, got {cc}")
    if not (row0 >= 0 and NR >= row0 + L + 1 and 2 <= av_len <= H
            and outw >= 1):
        raise ValueError(f"decode_rows: bad geometry NR={NR} row0={row0} "
                         f"L={L} H={H} av_len={av_len} outw={outw}")
    out = torch.empty((B, L, outw, 3), dtype=torch.uint8, device=dev)
    k = (ctypes.c_int * 15)(*[int(v) for c in coefs for v in c])
    build.launch("ntsc_decode_rows", rows.data_ptr(), shifts.data_ptr(),
                 waveI.data_ptr(), waveQ.data_ptr(), bright.data_ptr(),
                 contrast.data_ptr(), ctypes.addressof(k), out.data_ptr(),
                 B, L, NR, H, row0, av_len, outw, cc, build.stream(dev))
    LAUNCHES += 1
    return out


def decode_rows_plain(rows, shifts, waveI, waveQ, bright, contrast, *,
                      row0: int, coefs, av_len: int,
                      outw: int) -> torch.Tensor:
    """The same decode in plain torch: align, demodulate, one vectorised EQ
    march over every row and channel, gather-lerp, YIQ -> RGB."""
    B, L = shifts.shape
    H = rows.shape[2]
    ext = torch.cat([rows[:, row0:row0 + L], rows[:, row0 + 1:row0 + L + 1]],
                    dim=2).reshape(B * L, 2 * H)
    sig = fastpath.shift_rows(ext, shifts.reshape(-1),
                              av_len).reshape(B, L, av_len)
    wv_i = fastpath.tile_period(waveI, av_len)
    wv_q = fastpath.tile_period(waveQ, av_len)
    stacked = torch.stack([sig + bright[..., None], (sig * wv_i) >> 9,
                           (sig * wv_q) >> 9], dim=2)    # (B, L, 3, av_len)
    per_chan = [torch.tensor([c[k] for c in coefs], dtype=torch.int32,
                             device=rows.device) for k in range(5)]
    eqd = filters.eq_threeband(stacked, *per_chan)
    yv = fastpath.lerp_resample(eqd[:, :, 0] << 4, outw, 2)
    iv = fastpath.lerp_resample(eqd[:, :, 1] >> 3, outw, 14)
    qv = fastpath.lerp_resample(eqd[:, :, 2] >> 3, outw, 14)
    ct = contrast[..., None]
    r = (((yv + 3879 * iv + 2556 * qv) >> 12) * ct) >> 8
    g = (((yv - 1126 * iv - 2605 * qv) >> 12) * ct) >> 8
    b = (((yv - 4530 * iv + 7021 * qv) >> 12) * ct) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)
