"""Frozen: the plain versions of the port's bloom kernels
(``ntsc_crt_tpu_torch/ops/kernels/decode.py``, ``models/demodulate.py``)
as they stood when the bloom cell was defined: K2 in its bloom mode,
``bloom_line_width`` and the general row placement with the drawn-pixel
plane.  Each reads a line's two field rows copied out, (B, L, 2H)."""

from __future__ import annotations

import torch

from crt_bench.reference import fastpath, filters
from crt_bench.reference.fixedpoint import cdiv
from crt_bench.reference.modulate import _b


def eq_len(av_len: int, cc: int) -> int:
    """Samples the bloom-mode EQ runs: av_len rounded up to the TPU
    kernel's chunk."""
    chunk = 32 if cc == 4 else 40
    return -(-av_len // chunk) * chunk


# K2, bloom mode

def decode_rows_bloom_plain(pairs, shifts, waveI, waveQ, bright, contrast, *,
                            coefs, av_len: int, outw: int, bloom_dx,
                            bloom_lidx, eq_float: bool = False):
    """pairs int8 (B, L, 2H); shifts, bright, contrast, bloom_dx and
    bloom_lidx int32 (B, L); waveI/waveQ int32 (B, L, cc).  Row r draws
    pixel p from samples t = max((p * dx) >> 12, 0) and t + 1; the EQ runs
    on zero input from av_len to eq_len, both sources clamp there, and the
    right source reads zero where t + 1 == av_len - 1 - lidx
    (crt_core.c:512-570).  Returns uint8 (B, L, outw, 3).  eq_float marches
    the EQ in float32 without its truncations (the benchmark's control)."""
    B, L = shifts.shape
    cc = waveI.shape[2]
    n = eq_len(av_len, cc)
    sig = fastpath.shift_rows(pairs.reshape(B * L, -1), shifts.reshape(-1),
                              av_len).reshape(B, L, av_len)
    sig = torch.nn.functional.pad(sig, (0, n - av_len))
    wv_i = fastpath.tile_period(waveI, n)
    wv_q = fastpath.tile_period(waveQ, n)
    stacked = torch.stack([sig + bright[..., None], (sig * wv_i) >> 9,
                           (sig * wv_q) >> 9], dim=2)    # (B, L, 3, n)
    per_chan = [torch.tensor([c[k] for c in coefs], dtype=torch.int32,
                             device=pairs.device) for k in range(5)]
    march = (filters.eq_threeband_rows_float if eq_float
             else filters.eq_threeband_rows_plain)
    eqd = march(stacked, *per_chan)
    oy, oi, oq = eqd[:, :, 0] << 4, eqd[:, :, 1] >> 3, eqd[:, :, 2] >> 3
    p = torch.arange(outw, dtype=torch.int32, device=pairs.device)
    pos = p * bloom_dx[..., None]                         # (B, L, outw)
    t = (pos >> 12).clamp(min=0)
    ia = t.clamp(max=n - 1).long()
    ib = (t + 1).clamp(max=n - 1).long()
    zero = t + 1 == (av_len - 1 - bloom_lidx)[..., None]
    Rw = pos & 0xFFF
    Lw = 0xFFF - Rw

    def lerp(v, sh):
        a = torch.gather(v, 2, ia)
        b = torch.where(zero, 0, torch.gather(v, 2, ib))
        return ((a * Lw) >> sh) + ((b * Rw) >> sh)

    yv, iv, qv = lerp(oy, 2), lerp(oi, 14), lerp(oq, 14)
    ct = contrast[..., None]
    r = (((yv + 3879 * iv + 2556 * qv) >> 12) * ct) >> 8
    g = (((yv - 1126 * iv - 2605 * qv) >> 12) * ct) >> 8
    b = (((yv - 4530 * iv + 7021 * qv) >> 12) * ct) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


# bloom_line_width

def _cdiv_total(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """cdiv with d == 0 giving -1 and INT_MIN / -1 giving INT_MIN."""
    odd = (d == 0) | (d == -1)
    q = cdiv(a, torch.where(odd, 1, d))
    return torch.where(d == 0, -1, torch.where(d == -1, -a, q))


def bloom_line_width_plain(pairs, xpos_l, max_e, *, av_len: int):
    """The beam-energy EMA with the line sums that drive it
    (crt_core.c:512-520): line l's sum is its first row over [xpos, xpos +
    av_len) clipped to the row, plus the next row over [0, xpos + av_len -
    H); then prev_e = prev_e*123/128 + (((max_e >> 1) - s) << 10) / max_e
    per line from 16384/8, truncating divisions in wrapping int32.  pairs
    int8 (B, L, 2H); xpos_l int32 (B, L); max_e int32 (B,).  Returns
    prev_e int32 (B, L)."""
    H = pairs.shape[-1] // 2
    iota = torch.arange(H, dtype=torch.int32, device=pairs.device)
    xa = xpos_l[..., None]
    in_w = (iota >= xa) & (iota < xa + av_len)
    in_spill = iota < xa + av_len - H
    sums = (torch.where(in_w, pairs[..., :H], 0).sum(2, dtype=torch.int32)
            + torch.where(in_spill, pairs[..., H:], 0).sum(
                2, dtype=torch.int32))
    drive = _cdiv_total(((max_e[:, None] >> 1) - sums) << 10,
                        max_e[:, None].expand_as(sums))
    e = torch.full_like(max_e, 16384 // 8)
    out = torch.empty_like(sums)
    for l in range(sums.shape[1]):
        e = cdiv(e * 123, 128) + drive[:, l]
        out[:, l] = e
    return out


# row placement off K6's gate

def bloom_drawn(bloom_dx, bloom_scan, av_len: int, outw: int):
    """bool (B, L, outw): the pixels inside each bloom line's drawn width
    (crt_core.c:555 loop bound), in wrapping int32."""
    p = torch.arange(outw, dtype=torch.int32, device=bloom_dx.device)
    return bloom_scan[..., None] + p * bloom_dx[..., None] < ((av_len - 1)
                                                              << 12)


def place_rows_general(rgb, out_prev, beg_l, end_l, active_l, blend,
                       scanlines, outh: int, *, valid) -> torch.Tensor:
    """One per-output-row gather: each row takes the last line that covers
    it, blended with the previous frame if asked (crt_core.c:552-664); a
    pixel outside its line's drawn width (valid, bool (B, L, outw)) keeps
    the previous contents of the line's beg row."""
    B, L = rgb.shape[0], rgb.shape[1]
    dev = rgb.device
    scanlines = _b(scanlines, B, dev)
    end_c = torch.clamp(end_l, max=outh)
    cov_end = torch.maximum(beg_l + 1, end_c - scanlines[:, None])

    rows = torch.arange(outh, dtype=torch.int32, device=dev)[None, :, None]
    covers = ((rows >= beg_l[:, None, :]) & (rows < cov_end[:, None, :])
              & active_l[:, None, :])                     # (B, outh, L)
    lid = torch.arange(L, dtype=torch.int32, device=dev)
    last = torch.where(covers, lid, -1).amax(dim=2)       # (B, outh)
    exists = last >= 0
    lsel = last.clamp(min=0)

    content = fastpath.select_rows_batched(rgb, lsel)     # (B, outh, outw, 3)
    beg_sel = torch.gather(beg_l, 1, lsel.long())
    old_at_beg = fastpath.select_rows_batched(out_prev,
                                              beg_sel.clamp(0, outh - 1))
    blended = (content >> 1) + (old_at_beg >> 1)          # crt_core.c:608
    on = _b(blend, B, dev) != 0
    content = torch.where(on[:, None, None, None], blended, content)
    vsel = fastpath.select_rows_batched(valid, lsel)      # (B, outh, outw)
    content = torch.where(vsel[..., None], content, old_at_beg)
    return torch.where(exists[..., None, None], content, out_prev)
