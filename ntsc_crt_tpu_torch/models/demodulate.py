"""Demodulator: sampled analog composite signals -> RGB, like a CRT would.

Counterpart of ``ntsc_crt_tpu/models/demodulate.py`` (crt_demodulate,
crt_core.c:291-666), batch-first, for 4-sample chroma systems with the
default three-band EQ.  Each stage keeps one formulation, the plain one:

1. **Noise injection** — the serial LCG in closed form (ops/lcg.py).
2. **VSYNC recovery** — running sums over the candidate rows and the first
   crossing below the threshold (crt_core.c:369-397).
3. **Per-line sequential state** — the hsync chase (kernel K3), the burst
   gather and the ccf carrier EMA (a per-line torch loop), then the decode
   waves.
4. **Line decode** — alignment, Y/I/Q, 3-band EQ and scan conversion in
   kernel K2.
5. **Row placement** — each output row takes the last line that covers it,
   blended with the previous frame if asked (crt_core.c:552-664).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import numpy as np
import torch

from ntsc_crt_tpu.models.systems import SystemConfig
from ntsc_crt_tpu_torch.ops import fastpath, filters, lcg
from ntsc_crt_tpu_torch.ops.fixedpoint import cdiv, crem, posmod, sincos14
from ntsc_crt_tpu_torch.ops.kernels import decode, hsync
from ntsc_crt_tpu_torch.models.modulate import _b

Knob = Union[int, torch.Tensor]


class MonitorParams(NamedTuple):
    """Runtime monitor knobs (struct CRT fields, crt_core.h:82-86).
    Each field may be an int or an int (B,) tensor."""
    hue: Knob = 0
    brightness: Knob = 0
    contrast: Knob = 180
    saturation: Knob = 10
    black_point: Knob = 0
    white_point: Knob = 100
    blend: Knob = 0
    scanlines: Knob = 0


def _eq_coefs(cfg: SystemConfig):
    """crt_init's EQ setup for 4-sample chroma (crt_core.c:277-287)."""
    k = cfg.khz2l
    y = filters.init_eq(k(1500), k(3000), cfg.hres, 65536, 8192, 9175)
    i = filters.init_eq(k(80), k(1150), cfg.hres, 65536, 65536, 1311)
    q = filters.init_eq(k(80), k(1000), cfg.hres, 65536, 65536, 0)
    return y, i, q


# ---------------------------------------------------------------------------
# Noise injection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _noise_tables(cfg: SystemConfig, device: torch.device):
    """The LCG tables over the field, reduced mod 2^24: the noise byte reads
    bits 16..23 only, and 24-bit factors keep the product inside int64."""
    apow, csum = lcg._lcg_tables(cfg.input_size, lcg.LCG_A, lcg.LCG_B)
    shape = (cfg.vres, cfg.hres)
    return (torch.as_tensor((apow & 0xFFFFFF).astype(np.int64).reshape(shape),
                            device=device),
            torch.as_tensor((csum & 0xFFFFFF).astype(np.int64).reshape(shape),
                            device=device))


def _inject_noise(cfg: SystemConfig, analog2d: torch.Tensor, rn: torch.Tensor,
                  noise: torch.Tensor):
    """crt_core.c:346-367, batched: analog2d int8 (B, V, H), rn and noise
    int32 (B,).  Returns (noisy int8 (B, V, H), rn' int32 (B,))."""
    a24, c24 = _noise_tables(cfg, analog2d.device)
    rn24 = (rn.to(torch.int64) & 0xFFFFFF)[:, None, None]
    byte = (((a24 * rn24 + c24) >> 16) & 0xFF).to(torch.int32) - 0x7F
    s = analog2d.to(torch.int32) + ((byte * noise[:, None, None]) >> 8)
    rn_out = lcg.lcg_state(rn, cfg.input_size)
    return s.clamp(-127, 127).to(torch.int8), rn_out


# ---------------------------------------------------------------------------
# Sync recovery
# ---------------------------------------------------------------------------


def _find_vsync(cfg: SystemConfig, inp2d: torch.Tensor, vsync: torch.Tensor):
    """First (line, sample) crossing the vsync threshold (crt_core.c:369-397):
    first line, then first sample; if none crosses, the last candidate line
    and j == HRES.  inp2d int8 (B, V, H); vsync (B,).  Returns
    (line, field) int32 (B,)."""
    W = cfg.vsync_window
    dev = inp2d.device
    cand = posmod(vsync[:, None]
                  + torch.arange(-W, W, dtype=torch.int32, device=dev)[None],
                  cfg.vres)                               # (B, 2W)
    rows = fastpath.select_rows_batched(inp2d, cand)      # (B, 2W, H) int8
    hit = torch.cumsum(rows, dim=2, dtype=torch.int32) \
        <= cfg.vsync_thresh * cfg.sync_level
    any_hit = hit.any(dim=2)                              # (B, 2W)
    first_j = hit.to(torch.int32).argmax(dim=2)
    row = any_hit.to(torch.int32).argmax(dim=1, keepdim=True)
    exists = any_hit.any(dim=1)
    line = torch.where(exists, torch.gather(cand, 1, row)[:, 0],
                       cand[:, 2 * W - 1])
    j = torch.where(exists, torch.gather(first_j, 1, row)[:, 0], cfg.hres)
    field = (j > cfg.hres // 2).to(torch.int32)
    return line.to(torch.int32), field


def _ccf_ema(per_cls: torch.Tensor, vper_l: torch.Tensor,
             active_l: torch.Tensor, ccf0: torch.Tensor):
    """Fold each active line's burst into the carrier EMA of its vertical
    phase, line after line (crt_core.c:452-466): ccr = ccr*127/128 + burst
    sample, m times per line.  per_cls int32 (B, L, m, CC); vper_l (B, L);
    active_l bool (B, L); ccf0 int32 (B, VP, CC).  Returns (ccf' (B, VP, CC),
    ccr after every line (B, L, CC))."""
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


def _line_scan(cfg: SystemConfig, inp2d, hsync0, ccf0, vsync, hue_sn, hue_cs,
               saturation, outh: int, v_fac: int, field_px):
    """Per-line sequential pass: hsync chase, ccf EMA and the decode waves
    (crt_core.c:409-536).  inp2d int8 (B, V, H); carries (B, ...).  Returns
    (hsync', ccf', (xpos, beg, end, active, wave) per line, rolled4) where
    rolled4[b, i] is field row (top + i + vsync) mod V, i < L + 4."""
    CC = cfg.cc_samples
    B = inp2d.shape[0]
    L = cfg.lines
    H, V = cfg.hres, cfg.vres
    W = cfg.hsync_window
    dev = inp2d.device
    lines = torch.arange(cfg.top, cfg.bot, dtype=torch.int32, device=dev)

    # beg/end/active follow from field_px alone (crt_core.c:428-431)
    lrel = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    beg_l = (lrel * (outh + v_fac)) // cfg.lines + field_px[:, None]
    end_l = ((lrel + 1) * (outh + v_fac)) // cfg.lines + field_px[:, None]
    active_l = beg_l < outh                               # (B, L)

    # padded per-line rows: row l = field row (l + vsync) mod V, continued
    # into the following row (flat-indexing reads; at the bottom the
    # reference reads out of bounds — UB — and this wraps to the top).  The
    # pad covers the furthest read: the burst window at the largest hsync
    # and the hsync search window.
    PAD = max(cfg.cb_beg + cfg.burst_len, cfg.sync_beg + 2 * W) + 2 * W
    row_idx4 = posmod(cfg.top + torch.arange(L + 4, dtype=torch.int32,
                                             device=dev)[None, :]
                      + vsync[:, None], V)
    rolled4 = fastpath.select_rows_batched(inp2d, row_idx4)  # (B, L+4, H)
    rows2 = torch.cat([rolled4[:, :L], rolled4[:, 1:L + 1, :PAD]], dim=2)

    hsync_l = hsync.hsync_chase(
        rows2, active_l.contiguous(), hsync0.contiguous(), W=W,
        c0=cfg.sync_beg - W, thresh=cfg.hsync_thresh * cfg.sync_level, H=H)
    hsync_f = hsync_l[:, L - 1]

    xpos_l = posmod(cfg.av_beg + hsync_l - 3, H)          # xnudge=-3
    ypos_l = posmod(lines[None, :] + vsync[:, None] + 3, V)  # ynudge=+3
    vper_l = crem(ypos_l, cfg.cc_vper)                    # (B, L)

    # burst window of every line (crt_core.c:458-466)
    bbase = (hsync_l & ~3) + cfg.cb_beg
    bidx = bbase.long()[..., None] + torch.arange(cfg.burst_len, device=dev)
    bvals = torch.gather(rows2, 2, bidx).to(torch.int32)  # (B, L, burst_len)
    m = cfg.burst_len // CC
    col_for_cls = [(k - cfg.cb_beg) % CC for k in range(CC)]
    per_cls = bvals.reshape(B, L, m, CC)[..., col_for_cls]
    ccf_f, ccr_l = _ccf_ema(per_cls, vper_l, active_l, ccf0)

    # decode waves (4-sample IQ extraction, crt_core.c:471-479)
    phasealign = posmod(hsync_l, CC)

    def pick(off):
        idx = crem(phasealign + off, CC).long()[..., None]
        return torch.gather(ccr_l, 2, idx)[..., 0]

    dci = pick(1) - pick(3)
    dcq = pick(2) - pick(0)
    hs = hue_sn[:, None]
    hc = hue_cs[:, None]
    w0 = ((dci * hc - dcq * hs) >> 4) * saturation[:, None]
    w1 = ((dcq * hc + dci * hs) >> 4) * saturation[:, None]
    wave_l = torch.stack([w0, w1, -w0, -w1], dim=2)       # (B, L, 4)
    return hsync_f, ccf_f, (xpos_l, beg_l, end_l, active_l, wave_l), rolled4


# ---------------------------------------------------------------------------
# Core decode
# ---------------------------------------------------------------------------


def demodulate_core(
    cfg: SystemConfig,
    analog: torch.Tensor,     # int8 (B, VRES, HRES)
    out_prev: torch.Tensor,   # uint8 (B, outh, outw, 3) canonical RGB
    hsync: torch.Tensor,      # (B,)
    vsync: torch.Tensor,      # (B,)
    ccf: torch.Tensor,        # int32 (B, cc_vper, cc_samples)
    rn: torch.Tensor,         # (B,)
    noise,
    mon: MonitorParams,
    *,
    v_fac: int = 0,
) -> tuple[torch.Tensor, dict]:
    """One decode pass.  Returns (rgb uint8 (B, outh, outw, 3), new state
    dict with keys hsync/vsync/ccf/rn)."""
    if cfg.cc_samples != 4 or cfg.vhs_noise:
        raise NotImplementedError(
            f"{cfg.name}: the port decodes 4-sample, noise-LCG systems only "
            "(ROADMAP Queue 1, M7/M8)")
    B, outh, outw = out_prev.shape[0], out_prev.shape[1], out_prev.shape[2]
    dev = analog.device
    L = cfg.lines
    noise = _b(noise, B, dev)

    bright = _b(mon.brightness, B, dev) - (
        cfg.black_level + _b(mon.black_point, B, dev))
    hue_ang = (crem(_b(mon.hue, B, dev), 360) + 33) * 8192
    sn, cs = sincos14(cdiv(hue_ang, 180))
    hue_sn, hue_cs = sn >> 11, cs >> 11                   # crt_core.c:318-320
    saturation = _b(mon.saturation, B, dev)

    inp2d, rn_new = _inject_noise(cfg, analog, _b(rn, B, dev), noise)
    vsync_new, field = _find_vsync(cfg, inp2d, _b(vsync, B, dev))
    ratio = ((outh << 16) // cfg.lines + 32768) >> 16
    field_px = field * (ratio // 2)

    hsync_new, ccf_new, outs, rolled4 = _line_scan(
        cfg, inp2d, _b(hsync, B, dev), ccf.to(torch.int32), vsync_new,
        hue_sn, hue_cs, saturation, outh, v_fac, field_px)
    xpos_l, beg_l, end_l, active_l, wave_l = outs

    # Q wave is the I table rotated by 3 (crt_core.c:541-542); line l reads
    # field rows l+3 and l+4 (ynudge=+3), i.e. rolled4 from row 3
    rgb = decode.decode_rows(
        rolled4, xpos_l.contiguous(), wave_l.contiguous(),
        torch.roll(wave_l, -3, dims=-1).contiguous(),
        bright[:, None].expand(B, L).contiguous(),
        _b(mon.contrast, B, dev)[:, None].expand(B, L).contiguous(),
        row0=3, coefs=_eq_coefs(cfg), av_len=cfg.av_len, outw=outw)
    out_new = _place_rows(rgb, out_prev, beg_l, end_l, active_l, mon.blend,
                          _b(mon.scanlines, B, dev), outh)
    return out_new, dict(hsync=hsync_new, vsync=vsync_new, ccf=ccf_new,
                         rn=rn_new)


def _place_rows(rgb, out_prev, beg_l, end_l, active_l, blend, scanlines,
                outh: int) -> torch.Tensor:
    """The reference's sequential row writes (store at `beg`, duplicate up to
    `end - scanlines`, 50/50 blend against the previous contents;
    crt_core.c:552-664) as one per-output-row gather: each row takes the
    last line that covers it.  "Last line wins" equals the C semantics
    whenever line begs strictly increase — true iff outh + v_fac >=
    CRT_LINES (e.g. 480 >= 240)."""
    B, L = rgb.shape[0], rgb.shape[1]
    dev = rgb.device
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
    # a blend known to be off on the host skips the previous-frame gather
    if torch.is_tensor(blend) or np.any(blend):
        beg_sel = torch.gather(beg_l, 1, lsel.long())
        old_at_beg = fastpath.select_rows_batched(out_prev,
                                                  beg_sel.clamp(0, outh - 1))
        blended = (content >> 1) + (old_at_beg >> 1)      # crt_core.c:608
        on = _b(blend, B, dev) != 0
        content = torch.where(on[:, None, None, None], blended, content)
    return torch.where(exists[..., None, None], content, out_prev)
