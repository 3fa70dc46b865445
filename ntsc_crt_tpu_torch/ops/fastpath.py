"""The modulator's and demodulator's data movements as plain integer
indexing.

Counterpart of ``ntsc_crt_tpu/ops/fastpath.py``.  The JAX package replaces
every gather with one-hot matmuls, mixed-radix masked shifts or int8-limb
products because TPU gathers are slow; on a GPU an indexed load is exact and
cheap, so each routine here is the gather itself.
"""

from __future__ import annotations

import numpy as np
import torch


def select_rows_batched(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data[b, idx[b, m]] for data (B, N, ...) and idx (B, M)."""
    b = torch.arange(data.shape[0], device=data.device)[:, None]
    return data[b, idx.long()]


def line_samples(field: torch.Tensor, line_row: torch.Tensor,
                 x: torch.Tensor, offset: torch.Tensor = None) -> torch.Tensor:
    """Samples offset + x of each line, read in place from the field: a
    line starts on field row line_row and runs on through the rows after
    it, the last row continuing at row 0 of the same frame (the reference's
    flat reads; past the field's end they are UB there), so its sample i is
    byte (line_row * H + i) mod (V * H) of the frame.  field (B, V, H);
    line_row (B, L); x int64 >= 0, (K,) or (B, L, K); offset (B, L) >= 0,
    each line's first sample, or None for 0.  Returns (B, L, K) of field's
    dtype."""
    B, V, H = field.shape
    first = line_row.long() * H
    if offset is not None:
        first += offset
    flat = first[..., None] + x
    flat = flat.remainder_(V * H).expand(B, line_row.shape[1], -1)
    return torch.gather(field.reshape(B, V * H), 1,
                        flat.reshape(B, -1)).view(flat.shape)


def shift_rows(ext: torch.Tensor, shifts: torch.Tensor,
               out_len: int) -> torch.Tensor:
    """out[r, i] = ext[r, shifts[r] + i] for i < out_len, as int32; reads
    past the row end give 0.  ext (R, W); shifts int32 (R,) >= 0."""
    W = ext.shape[1]
    idx = shifts.long()[:, None] + torch.arange(out_len, device=ext.device)
    got = torch.gather(ext, 1, idx.clamp(max=W - 1)).to(torch.int32)
    return torch.where(idx < W, got, 0)


def tile_period(vals: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """out[..., i] = vals[..., (i + offset) % P] for i < n."""
    P = vals.shape[-1]
    idx = (torch.arange(n, device=vals.device) + offset) % P
    return vals[..., idx]


def lerp_resample_weights(av_len: int, outw: int):
    """Static scan-conversion maps (crt_core.c:528-532, 555-570): pixel p
    reads source samples s=pos>>12 and s+1 with 12-bit weights
    L=0xfff-R, R=pos&0xfff, pos=p*dx, dx=((av_len-1)<<12)//outw."""
    dx = ((av_len - 1) << 12) // outw
    pos = np.arange(outw, dtype=np.int64) * dx
    s = (pos >> 12).astype(np.int32)
    R = (pos & 0xFFF).astype(np.int32)
    L = 0xFFF - R
    return s, L, R


def lerp_resample(vals: torch.Tensor, outw: int, shift: int) -> torch.Tensor:
    """((a*L) >> shift) + ((b*R) >> shift) with a = vals[..., s] and
    b = vals[..., s+1], int32 products wrapping like the reference's
    (crt_core.c:568-570).  vals int32 (..., av_len) -> (..., outw)."""
    av_len = vals.shape[-1]
    s, L, R = lerp_resample_weights(av_len, outw)
    dev = vals.device
    s = torch.as_tensor(s, device=dev).long()
    a = vals[..., s]
    b = vals[..., (s + 1).clamp(max=av_len - 1)]
    return (((a * torch.as_tensor(L, device=dev)) >> shift)
            + ((b * torch.as_tensor(R, device=dev)) >> shift))


def store_active(analog: torch.Tensor, ire: torch.Tensor, xo: int,
                 yo: int) -> torch.Tensor:
    """Write the active block at (yo, xo) with the reference's FLAT indexing
    (crt_ntsc.c:322: analog[(x+xo) + (y+yo)*HRES]): a row whose xo + destw
    exceeds HRES spills into the start of the next row; writes past the
    final row (UB in the reference) are clipped.  Writes `analog` in place
    and returns it."""
    B, desth, destw = ire.shape
    V, H = analog.shape[1], analog.shape[2]
    spill = xo + destw - H
    rows = min(desth, V - yo)
    if spill <= 0:
        analog[:, yo:yo + rows, xo:xo + destw] = ire[:, :rows]
        return analog
    main_w = destw - spill
    analog[:, yo:yo + rows, xo:] = ire[:, :rows, :main_w]
    rows2 = min(desth, V - yo - 1)
    analog[:, yo + 1:yo + 1 + rows2, :spill] = ire[:, :rows2, main_w:]
    return analog
