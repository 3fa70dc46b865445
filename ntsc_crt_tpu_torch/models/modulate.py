"""Modulator: digital RGB frames -> sampled analog NTSC composite fields.

Counterpart of ``ntsc_crt_tpu/models/modulate.py``, NTSC encoder family
only (``modulate_rgb``, crt_ntsc.c:128-330, and ``modulate_vhs`` on top of
it, crt_ntscvhs.c).  Batch-first like the JAX
package: every tensor carries a leading frame dim.  Per frame the field is
built in three phases:

1. **Field skeleton** — the sync/equalizing/blank structure, a constant per
   field parity, written through a static mask (samples the skeleton does not
   write keep the previous field: the reference relies on that).
2. **Color burst** — per-line constants over the burst window from the hue.
3. **Active video** — kernel K1 (ops/kernels/encode.py) resamples, converts,
   bandlimits, modulates and clamps every picture row; `_store_active` places
   the block in the field.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ntsc_crt_tpu_torch.models.systems import CHROMA_CHECKERED, SystemConfig
from ntsc_crt_tpu_torch.ops import filters, lcg
from ntsc_crt_tpu_torch.ops.fixedpoint import cdiv, crem, i32, sincos14
from ntsc_crt_tpu_torch.ops.kernels import encode


def _b(x, B: int, device) -> torch.Tensor:
    """A scalar-or-(B,) parameter as an int32 (B,) tensor on `device`."""
    if isinstance(x, (int, np.integer)):
        return i32(torch.full((B,), int(x), dtype=torch.int64, device=device))
    return torch.broadcast_to(i32(x, device=device), (B,)).contiguous()


# ---------------------------------------------------------------------------
# Field skeleton (crt_ntsc.c:205-252)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def build_skeletons(cfg: SystemConfig):
    """(skel_even, skel_odd, write_mask) as numpy constants.

    skel_*: int8 (VRES, HRES) — the sync/blank structure for each field
    parity.  write_mask: bool (VRES, HRES) — True where the skeleton writes;
    everything else keeps the previous analog contents.
    """
    H, V = cfg.hres, cfg.vres
    sync, blank = cfg.sync_level, cfg.blank_level

    def region_line(offs):
        """SYNC until offs[0]%, BLANK until offs[1]%, SYNC until offs[2]%,
        BLANK until offs[3]% — the reference's while-loop quads."""
        row = np.full(H, blank, np.int8)
        bounds = [o * H // 100 for o in offs]
        row[0:bounds[0]] = sync
        row[bounds[0]:bounds[1]] = blank
        row[bounds[1]:bounds[2]] = sync
        row[bounds[2]:bounds[3]] = blank
        return row

    equalizing = region_line([4, 50, 54, 100])          # crt_ntsc.c:211-216
    vsync_even = region_line([46, 50, 96, 100])         # crt_ntsc.c:217-228
    vsync_odd = region_line([4, 50, 96, 100])
    if not cfg.vsync_field_dependent:
        vsync_odd = vsync_even

    video = np.full(H, blank, np.int8)
    video[cfg.sync_beg:cfg.bw_beg] = sync               # crt_ntsc.c:233-235

    skel_even = np.zeros((V, H), np.int8)
    skel_odd = np.zeros((V, H), np.int8)
    mask = np.zeros((V, H), bool)

    equ_rows = list(range(cfg.equ_a[0], cfg.equ_a[1] + 1)) + \
        list(range(cfg.equ_b[0], cfg.equ_b[1] + 1))
    sync_rows = list(range(cfg.sync_region[0], cfg.sync_region[1] + 1))

    for n in range(V):
        if n in equ_rows:
            skel_even[n] = skel_odd[n] = equalizing
            mask[n] = True
        elif n in sync_rows:
            skel_even[n] = vsync_even
            skel_odd[n] = vsync_odd
            mask[n] = True
        else:
            skel_even[n, :cfg.av_beg] = video[:cfg.av_beg]
            skel_odd[n, :cfg.av_beg] = video[:cfg.av_beg]
            mask[n, :cfg.av_beg] = True
            if n < cfg.top:  # fully blanked inactive lines (crt_ntsc.c:236-238)
                skel_even[n, cfg.av_beg:] = blank
                skel_odd[n, cfg.av_beg:] = blank
                mask[n, cfg.av_beg:] = True
    return skel_even, skel_odd, mask


@functools.lru_cache(maxsize=16)
def video_rows_mask(cfg: SystemConfig) -> np.ndarray:
    rows = np.ones(cfg.vres, bool)
    for lo, hi in (cfg.equ_a, cfg.sync_region, cfg.equ_b):
        rows[lo:hi + 1] = False
    return rows


@functools.lru_cache(maxsize=16)
def _field_constants(cfg: SystemConfig, device: torch.device):
    """(skel_even, skel_odd, write_mask, video_rows) on `device`, copied
    once: a copy from host memory in every step would stall the host until
    the device drained."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in build_skeletons(cfg) + (video_rows_mask(cfg),))


def _dest_size(cfg: SystemConfig, raw: bool, img_w: int, img_h: int,
               do_bloom: bool = False):
    """destw/desth sizing (crt_ntsc.c:148-173); CRT_DO_BLOOM draws a
    smaller picture."""
    if do_bloom:
        destw = (cfg.av_len * 55500) >> 16
        desth = (cfg.lines * 63500) >> 16
        if raw:
            destw = min(img_w, destw)
            desth = min(img_h, desth)
        return destw, desth
    destw, desth = cfg.av_len, (cfg.lines * 64500) >> 16
    if raw:
        destw = min(img_w, cfg.av_len)
        desth = min(img_h, (cfg.lines * 64500) >> 16)
    return destw, desth


def _store_active(analog: torch.Tensor, ire: torch.Tensor, xo: int,
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


# ---------------------------------------------------------------------------
# NTSC (1D carrier tables + CC_PHASE sign, crt_ntsc.c)
# ---------------------------------------------------------------------------


def modulate_rgb(
    cfg: SystemConfig,
    analog: torch.Tensor,     # int8 (B, VRES, HRES) — persistent field buffer
    img: torch.Tensor,        # uint8 (B, h, w, 3) canonical RGB
    *,
    field, frame, hue, as_color=1,
    xoffset: int = 0, yoffset: int = 0,
    black_point=0, white_point=100,
    raw: bool = False, do_bloom: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (analog', ccf') — ccf' is the encoder's burst export
    (iccf << 7, crt_ntsc.c:325-329), shape (B, cc_vper, cc_samples) int32.
    do_bloom: the CRT_DO_BLOOM destination sizing."""
    if not (cfg.kind == "rgb" and cfg.cc_samples == 4):
        raise ValueError(f"{cfg.name}: not an NTSC-family encoder")
    dev = analog.device
    B = analog.shape[0]
    h, w = img.shape[1], img.shape[2]
    field = _b(field, B, dev) & 1
    frame = _b(frame, B, dev) & 1
    hue = _b(hue, B, dev)
    black_point = _b(black_point, B, dev)
    white_point = _b(white_point, B, dev)
    CC = cfg.cc_samples

    destw, desth = _dest_size(cfg, raw, w, h, do_bloom)
    xo = (cfg.av_beg + xoffset + (cfg.av_len - destw) // 2) & ~3  # :203
    yo = cfg.top + yoffset + (cfg.lines - desth) // 2

    inv_phase = (field == frame).to(torch.int32)          # crt_ntsc.c:199
    if cfg.chroma_pattern == CHROMA_CHECKERED:
        ph = 1 - 2 * (inv_phase & 1)                      # CC_PHASE
        flip = inv_phase * (CC // 2)
    else:
        ph = torch.ones((B,), dtype=torch.int32, device=dev)
        flip = torch.zeros((B,), dtype=torch.int32, device=dev)

    # carrier tables (B, CC) (crt_ntsc.c:174-188)
    k = torch.arange(CC, dtype=torch.int32, device=dev)[None, :]
    n_ang = hue[:, None] + k * (360 // CC)
    burst_sn, _ = sincos14(cdiv((n_ang + cfg.hue_offset) * 8192, 180))
    modI_sn, _ = sincos14(cdiv(n_ang * 8192, 180))
    modQ_sn, _ = sincos14(cdiv((n_ang + cfg.q_offset) * 8192, 180))
    on = (_b(as_color, B, dev) != 0)[:, None]
    ccburst = torch.where(on, burst_sn >> 10, 0)
    ccmodI = torch.where(on, modI_sn >> 10, 0)
    ccmodQ = torch.where(on, modQ_sn >> 10, 0)

    # --- skeleton + burst ---------------------------------------------------
    skel_even, skel_odd, mask, vrows = _field_constants(cfg, dev)
    skel = torch.where((field == 1)[:, None, None], skel_odd, skel_even)
    analog = torch.where(mask, skel, analog)   # a new field: the writes
    #                                            below leave the caller's alone

    t = torch.arange(cfg.burst_len, device=dev) + cfg.cb_beg
    cb_idx = (t[None, :] + flip[:, None]) % CC            # (B, burst_len)
    burst_vals = (cfg.blank_level + torch.gather(ccburst, 1, cb_idx)
                  * cfg.burst_level) >> 5
    seg = analog[:, :, cfg.cb_beg:cfg.cb_beg + cfg.burst_len]
    analog[:, :, cfg.cb_beg:cfg.cb_beg + cfg.burst_len] = torch.where(
        vrows[None, :, None], burst_vals[:, None, :].to(torch.int8), seg)

    # iccf export: last burst write per phase class (crt_ntsc.c:249, 325-329)
    icc_idx = (k.long() + flip[:, None]) % CC
    iccf = (cfg.blank_level + torch.gather(ccburst, 1, icc_idx)
            * cfg.burst_level) >> 5
    ccf = (iccf << 7)[:, None, :].expand(B, cfg.cc_vper, CC).contiguous()

    # --- active video --------------------------------------------------------
    y_idx = torch.arange(desth, dtype=torch.int32, device=dev)[None, :]
    field_offset = cdiv(cdiv(field * h + desth, desth), 2)[:, None]
    # C reads one row past the image at the bottom (UB); clamp to the last
    sy = ((y_idx * h) // desth + field_offset).clamp(max=h - 1)

    gain = cdiv(cfg.white_level * white_point, 100)
    base = cfg.black_level + black_point
    coefs = ((filters.init_iir(cfg.l_freq, cfg.y_freq),
              filters.init_iir(cfg.l_freq, cfg.i_freq),
              filters.init_iir(cfg.l_freq, cfg.q_freq))
             if cfg.do_bandlimiting else None)
    ire = encode.encode_rows(
        img.to(torch.uint8).contiguous(), sy.contiguous(),
        (ccmodI * ph[:, None]).contiguous(),
        (ccmodQ * ph[:, None]).contiguous(), gain, base, coefs=coefs,
        xo_mod=xo % CC, destw=destw)
    return _store_active(analog, ire, xo, yo), ccf


# ---------------------------------------------------------------------------
# NTSC-VHS (crt_ntscvhs.c)
# ---------------------------------------------------------------------------


def modulate_vhs(
    cfg: SystemConfig,
    analog: torch.Tensor,     # int8 (B, VRES, HRES)
    img: torch.Tensor,        # uint8 (B, h, w, 3)
    randstate: torch.Tensor,  # (B,) crt_rand state, shared with the decoder
    *,
    field, frame, hue, as_color=1, xoffset: int = 0, yoffset: int = 0,
    black_point=0, white_point=100, raw: bool = False,
    do_aberration=0, do_bloom: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """crt_ntscvhs.c:128-337: the NTSC encoder, then head switching — with
    do_aberration on (an int or a (B,) tensor), one crt_rand draw picks
    6..17 bottom lines that lose their sync tips (:234-238) — and a zeroed
    ccf export (:330-335).  The per-frame hsync reset (:258) is the
    pipeline's.  do_bloom: the CRT_DO_BLOOM destination sizing
    (crt_ntscvhs.c:149-156).  Returns (analog', ccf_zero, randstate')."""
    analog, _ = modulate_rgb(
        cfg, analog, img, field=field, frame=frame, hue=hue,
        as_color=as_color, xoffset=xoffset, yoffset=yoffset,
        black_point=black_point, white_point=white_point, raw=raw,
        do_bloom=do_bloom)
    dev = analog.device
    B = analog.shape[0]
    do_ab = _b(do_aberration, B, dev) != 0
    rs = _b(randstate, B, dev)
    rs_next = lcg.crt_rand_step(rs)
    aberration = torch.where(
        do_ab, (crem(lcg.crt_rand_out(rs_next), 12) - 8) + 14, 0)
    randstate = torch.where(do_ab, rs_next, rs)

    # analog is modulate_rgb's fresh buffer, so the kill writes in place
    V = cfg.vres
    rows = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    _, _, _, vrows = _field_constants(cfg, dev)
    kill = vrows[None, :] & (rows >= V - aberration[:, None])   # (B, V)
    analog[:, :, :cfg.bw_beg].masked_fill_(kill[:, :, None], cfg.blank_level)

    ccf = torch.zeros((B, cfg.cc_vper, cfg.cc_samples), dtype=torch.int32,
                      device=dev)
    return analog, ccf, randstate
