"""K3 ``hsync_chase``: the serial per-line horizontal sync search.

For each batch entry and each of L lines in order (crt_core.c:434-450): sum
the 2W-sample window of line l that starts at hsync + c0, take the first
position t whose running sum is <= thresh (2W if none), and, when the line
is active, move the estimate to posmod(t - W + hsync, H).  Returns the
estimate after every line.

The lines are read in place from the noisy field: line l starts on field
row line_row[l] and runs on into the next row (the last row continuing at
row 0 of the same frame, fastpath.line_samples), its samples from H + pad
on reading as 0.  Replaces ``ntsc_crt_tpu/ops/pallas/hsync_scan.py::
hsync_chase``, whose rows2 (B, L, H + pad) are these lines copied out.  A
CPU tensor runs the plain torch loop below; a CUDA tensor launches
csrc/hsync.cu (one warp an entry, each line's window staged lines ahead
with cp.async).
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops import fastpath
from ntsc_crt_tpu_torch.ops.fixedpoint import posmod

# the kernel's limit on W: lane t of a warp sums window samples 0..t < 2W
MAX_W = 16


def hsync_chase(field: torch.Tensor, line_row: torch.Tensor,
                active_l: torch.Tensor, hsync0: torch.Tensor, *, pad: int,
                W: int, c0: int, thresh: int) -> torch.Tensor:
    """field int8 (B, V, H); line_row int32 (B, L), each line's first field
    row, in [0, V); active_l bool (B, L); hsync0 int32 (B,).  Returns int32
    (B, L).  Window samples outside [0, H + pad) read as 0."""
    if field.device.type == "cpu":
        return hsync_chase_plain(field, line_row, active_l, hsync0, pad=pad,
                                 W=W, c0=c0, thresh=thresh)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = field.device
    B, V, H = field.shape
    L = line_row.shape[-1]
    if not (1 <= W <= MAX_W and B >= 1 and L >= 1 and H >= 1 and pad >= 0
            and H + pad <= V * H < 2**31):
        raise ValueError(f"hsync_chase: needs 1 <= W <= {MAX_W} and "
                         f"H + pad <= V * H < 2**31, got W={W} B={B} L={L} "
                         f"V={V} H={H} pad={pad}")
    build.check("field", field, torch.int8, (B, V, H), dev)
    build.check("line_row", line_row, torch.int32, (B, L), dev)
    build.check("active_l", active_l, torch.bool, (B, L), dev)
    build.check("hsync0", hsync0, torch.int32, (B,), dev)
    if field.data_ptr() % 4:
        raise ValueError("hsync_chase: field must start on a 4-byte "
                         "boundary (the kernel copies aligned words)")
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    build.launch("ntsc_hsync_chase", dev, field.data_ptr(),
                 line_row.data_ptr(), active_l.data_ptr(), hsync0.data_ptr(),
                 out.data_ptr(), B, V, L, H, pad, W, c0, thresh)
    return out


def hsync_chase_plain(field, line_row, active_l, hsync0, *, pad: int, W: int,
                      c0: int, thresh: int) -> torch.Tensor:
    """The same chase in plain torch: the lines copied out of the field,
    then one vectorised window probe per line."""
    B, L = line_row.shape
    H = field.shape[2]
    HP = H + pad
    rows2 = fastpath.line_samples(field, line_row,
                                  torch.arange(HP, device=field.device))
    tW = 2 * W
    off = torch.arange(tW, device=field.device)
    hs = hsync0.to(torch.int32)
    out = torch.empty((B, L), dtype=torch.int32, device=field.device)
    for l in range(L):
        x = (hs + c0).long()[:, None] + off                # (B, 2W)
        win = torch.gather(rows2[:, l], 1, x.clamp(0, HP - 1))
        win = torch.where((x >= 0) & (x < HP), win.to(torch.int32), 0)
        hit = torch.cumsum(win, 1, dtype=torch.int32) <= thresh
        j = torch.where(hit.any(1), hit.to(torch.int32).argmax(1), tW)
        hs = torch.where(active_l[:, l], posmod(j - W + hs, H), hs)
        out[:, l] = hs
    return out
