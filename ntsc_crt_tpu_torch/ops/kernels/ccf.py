"""K4 ``ccf_ema``: the per-line colour-carrier EMA of the decoder.

For each batch entry and each of L lines in order (crt_core.c:452-466):
take the carried state row ccf[vper[l]], fold the line's m burst sample
groups into it as ccr = ccr*127/128 + sample (C truncating division, int32
wrap), keep the old row on an inactive line, write the row back and emit it.

Replaces ``ntsc_crt_tpu/ops/pallas/ccf_scan.py::ccf_ema`` and keeps its
contract.  A CPU tensor runs the plain torch loop below; a CUDA tensor
launches csrc/ccf.cu (one warp an entry, its rows streamed through shared
memory with cp.async while the lanes fold).
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops.fixedpoint import cdiv

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0
# the kernel's limits on VP, CC and m (csrc/ccf.cu)
MAX_VP, MAX_CC, MAX_M = 5, 5, 16


def ccf_ema(per_cls: torch.Tensor, vper_l: torch.Tensor,
            active_l: torch.Tensor, ccf0: torch.Tensor):
    """per_cls int32 (B, L, m, CC) burst sample groups per line; vper_l
    int32 (B, L) state row of each line, in [0, VP); active_l bool (B, L);
    ccf0 int32 (B, VP, CC).  Returns (ccf' int32 (B, VP, CC), ccr after
    every line int32 (B, L, CC))."""
    if per_cls.device.type == "cpu":
        return ccf_ema_plain(per_cls, vper_l, active_l, ccf0)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    global LAUNCHES
    dev = per_cls.device
    B, L, m, CC = per_cls.shape
    VP = ccf0.shape[1]
    build.check("per_cls", per_cls, torch.int32, (B, L, m, CC), dev)
    build.check("vper_l", vper_l, torch.int32, (B, L), dev)
    build.check("active_l", active_l, torch.bool, (B, L), dev)
    build.check("ccf0", ccf0, torch.int32, (B, VP, CC), dev)
    if not (1 <= VP <= MAX_VP and 1 <= CC <= MAX_CC and 1 <= m <= MAX_M
            and B >= 1 and L >= 1):
        raise ValueError(f"ccf_ema: needs VP <= {MAX_VP}, CC <= {MAX_CC}, "
                         f"m <= {MAX_M}, got VP={VP} CC={CC} m={m} B={B} "
                         f"L={L}")
    ccf_f = torch.empty((B, VP, CC), dtype=torch.int32, device=dev)
    ccr_l = torch.empty((B, L, CC), dtype=torch.int32, device=dev)
    build.launch("ntsc_ccf_ema", dev, per_cls.data_ptr(), vper_l.data_ptr(),
                 active_l.data_ptr(), ccf0.data_ptr(), ccf_f.data_ptr(),
                 ccr_l.data_ptr(), B, L, m, VP, CC)
    LAUNCHES += 1
    return ccf_f, ccr_l


def ccf_ema_plain(per_cls, vper_l, active_l, ccf0):
    """The same EMA in plain torch: one step per line, vectorised over the
    batch and the phase classes."""
    B, L, m, CC = per_cls.shape
    bi = torch.arange(B, device=per_cls.device)
    vper_l = vper_l.long()
    ccf = ccf0.clone()
    ccr_l = torch.empty((B, L, CC), dtype=torch.int32, device=per_cls.device)
    for l in range(L):
        vp = vper_l[:, l]
        ccr = ccf[bi, vp]
        new = ccr
        for mm in range(m):
            new = cdiv(new * 127, 128) + per_cls[:, l, mm]
        ccr = torch.where(active_l[:, l, None], new, ccr)
        ccf[bi, vp] = ccr
        ccr_l[:, l] = ccr
    return ccf, ccr_l
