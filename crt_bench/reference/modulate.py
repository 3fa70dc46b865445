"""Frozen: the NTSC, NTSC-VHS and NES encoders of
``ntsc_crt_tpu_torch/models/modulate.py`` as they stood when the benchmark
was defined, on the kernels' plain versions."""

from __future__ import annotations

import functools

import numpy as np
import torch

from crt_bench.reference import fastpath, filters, kernels, lcg
from crt_bench.reference.fixedpoint import cdiv, crem, i32, sincos14
from crt_bench.reference.systems import CHROMA_CHECKERED, SystemConfig


def _b(x, B: int, device) -> torch.Tensor:
    """A scalar-or-(B,) parameter as an int32 (B,) tensor on `device`; a
    Python int wraps to int32 on the host (one fill on the device)."""
    if isinstance(x, (int, np.integer)):
        v = ((int(x) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        return torch.full((B,), v, dtype=torch.int32, device=device)
    return torch.broadcast_to(i32(x, device=device), (B,)).contiguous()


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


def _iir_coefs(cfg: SystemConfig):
    """K1's (cY, cI, cQ) IIR coefficients (crt_ntsc.c:98-106), or None
    for a system without bandlimiting."""
    if not cfg.do_bandlimiting:
        return None
    return tuple(filters.init_iir(cfg.l_freq, f)
                 for f in (cfg.y_freq, cfg.i_freq, cfg.q_freq))


def _encode_lines(img, sy, modI, modQ, gain, base, **static) -> torch.Tensor:
    """K1's plain version over the picture rows."""
    return kernels.encode_rows_plain(img.to(torch.uint8), sy, modI, modQ,
                                     gain, base, **static)


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

    per_row = lambda m: (m * ph[:, None])[:, None].expand(  # noqa: E731
        B, desth, CC).contiguous()
    ire = _encode_lines(img, sy, per_row(ccmodI), per_row(ccmodQ),
                        cdiv(cfg.white_level * white_point, 100),
                        cfg.black_level + black_point, coefs=_iir_coefs(cfg),
                        xo_mod=xo % CC, destw=destw)
    return fastpath.store_active(analog, ire, xo, yo), ccf


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


def modulate_nes(
    cfg: SystemConfig,
    analog: torch.Tensor,     # int8 (B, VRES, HRES)
    ppu: torch.Tensor,        # uint16 (B, h, w) NES PPU pixels (6 or 9 bit)
    *,
    hue, dot_crawl_offset=0, xoffset: int = 0, yoffset: int = 0,
    black_point=0, white_point=100,
    border_color=0, draw_border: bool = False,
    optimized: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """crt_nes.c:106-201 (the optimized build): kernel K13
    (ops/kernels/nes.py) writes the whole field — the skeleton, the colour
    burst and the picture (the PPU pixels resampled by index, the 4-phase
    square-wave sum, the IRE scale and the int8 wrap) — and returns the
    burst's ccf export.  The field it is handed gives only its shape: every
    sample is new, as the reference's setup_field rewrites it.  draw_border
    renders the PPU border (NES_BORDER, crt_nes.c:138-161); optimized=False
    is the NES_OPTIMIZED=0 build (crt_nes.c:204-308), whose only difference
    is the colour burst on every non-vsync line (0..258), not only on the
    picture rows.  Returns (analog', ccf' int32 (B, VP, CC))."""
    if cfg.kind != "nes":
        raise ValueError(f"{cfg.name}: not the NES encoder")
    dev = analog.device
    B, H = analog.shape[0], cfg.hres
    destw, desth = cfg.av_len, cfg.lines
    xo = (cfg.av_beg + xoffset) & ~3
    yo = cfg.top + yoffset
    brow0, brows = (yo, desth) if optimized else (0, 259)  # crt_nes.c:174/249
    # the skeleton is build_skeleton_nes's: sync from SYNC_BEG to BW_BEG, to
    # PPUpx2pos(327) on lines 259-261; the border's rows run TOP..BOT+2
    # from LAV_BEG
    return kernels.nes_square_plain(
        torch.empty_like(analog), ppu, kernels.square_table(dev),
        _b(dot_crawl_offset, B, dev), _b(black_point, B, dev),
        _b(white_point, B, dev), _b(border_color, B, dev), _b(hue, B, dev),
        kernels.burst_sines(dev), xo=xo, yo=yo, destw=destw, desth=desth,
        draw_border=draw_border, box=(cfg.top, cfg.bot + 3, cfg.lav_beg),
        vp=cfg.cc_vper, skeleton=(cfg.sync_beg, cfg.bw_beg, 259,
                                  327 * H // 341, cfg.sync_level,
                                  cfg.blank_level),
        burst_box=(brow0, brows, cfg.cb_beg, cfg.burst_len),
        cc=cfg.cc_samples, vert_step=cfg.vert_step,
        burst_level=cfg.burst_level,
        black_level=cfg.black_level)
