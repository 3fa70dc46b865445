"""K3 ``hsync_chase``: the serial per-line horizontal sync search.

For each batch entry and each of L lines in order (crt_core.c:434-450): sum
the 2W-sample window of rows2[b, l] that starts at hsync + c0, take the first
position t whose running sum is <= thresh (2W if none), and, when the line
is active, move the estimate to posmod(t - W + hsync, H).  Returns the
estimate after every line.

Replaces ``ntsc_crt_tpu/ops/pallas/hsync_scan.py::hsync_chase`` and keeps its
contract (rows2, active_l, hsync0, W, c0, thresh, H).  A CPU tensor runs the
plain torch loop below; a CUDA tensor launches csrc/hsync.cu (one warp an
entry, each line's window staged lines ahead with cp.async).
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops.fixedpoint import posmod

# the kernel's limit on W: lane t of a warp sums window samples 0..t < 2W
MAX_W = 16


def hsync_chase(rows2: torch.Tensor, active_l: torch.Tensor,
                hsync0: torch.Tensor, *, W: int, c0: int, thresh: int,
                H: int) -> torch.Tensor:
    """rows2 int8 (B, L, HP) padded line rows; active_l bool (B, L); hsync0
    int32 (B,).  Returns int32 (B, L).  Window samples outside [0, HP) read
    as 0."""
    if rows2.device.type == "cpu":
        return hsync_chase_plain(rows2, active_l, hsync0, W=W, c0=c0,
                                 thresh=thresh, H=H)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = rows2.device
    B, L, HP = rows2.shape
    if not (1 <= W <= MAX_W and B >= 1 and L >= 1 and HP >= 1 and H >= 1):
        raise ValueError(f"hsync_chase: needs 1 <= W <= {MAX_W}, got W={W} "
                         f"B={B} L={L} H={H}")
    build.check("rows2", rows2, torch.int8, (B, L, HP), dev)
    build.check("active_l", active_l, torch.bool, (B, L), dev)
    build.check("hsync0", hsync0, torch.int32, (B,), dev)
    if rows2.data_ptr() % 4:
        raise ValueError("hsync_chase: rows2 must start on a 4-byte "
                         "boundary (the kernel copies aligned words)")
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    build.launch("ntsc_hsync_chase", dev, rows2.data_ptr(),
                 active_l.data_ptr(), hsync0.data_ptr(), out.data_ptr(), B,
                 L, HP, W, c0, thresh, H)
    return out


def hsync_chase_plain(rows2, active_l, hsync0, *, W: int, c0: int,
                      thresh: int, H: int) -> torch.Tensor:
    """The same chase in plain torch: one vectorised window probe per line."""
    B, L, HP = rows2.shape
    tW = 2 * W
    off = torch.arange(tW, device=rows2.device)
    hs = hsync0.to(torch.int32)
    out = torch.empty((B, L), dtype=torch.int32, device=rows2.device)
    for l in range(L):
        x = (hs + c0).long()[:, None] + off                # (B, 2W)
        win = torch.gather(rows2[:, l], 1, x.clamp(0, HP - 1))
        win = torch.where((x >= 0) & (x < HP), win.to(torch.int32), 0)
        hit = torch.cumsum(win, 1, dtype=torch.int32) <= thresh
        j = torch.where(hit.any(1), hit.to(torch.int32).argmax(1), tW)
        hs = torch.where(active_l[:, l], posmod(j - W + hs, H), hs)
        out[:, l] = hs
    return out
