"""Modulator: digital frames -> sampled analog NTSC composite fields.

Counterpart of ``ntsc_crt_tpu/models/modulate.py``, every encoder family:
``modulate_rgb`` (NTSC, crt_ntsc.c:128-330) with ``modulate_vhs`` on top of
it (crt_ntscvhs.c); ``modulate_vper`` (SNES, TEMPLATE, PV1K: a carrier table
per vertical phase class); ``modulate_nesrgb`` (RGB input on NES timing);
``modulate_nes`` (square waves from NES PPU pixel indices).  Batch-first
like the JAX package: every tensor carries a leading frame dim.  Per frame
the field is built in three phases:

1. **Field skeleton** — the sync/equalizing/blank structure, a constant per
   field parity, written through a static mask (samples the skeleton does not
   write keep the previous field: the reference relies on that).  The NES
   family writes every sample.
2. **Color burst** — per-line constants over the burst window from the hue.
3. **Active video** — kernel K1 (ops/kernels/encode.py) resamples, converts,
   bandlimits, modulates and clamps every picture row; `_store_active` places
   the block in the field.  NES synthesises its square waves in plain torch
   (the JAX package has no Pallas kernel there).

The JAX package's one-hot einsums (its TPU gathers) are plain indexing here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ntsc_crt_tpu_torch.models.systems import CHROMA_CHECKERED, SystemConfig
from ntsc_crt_tpu_torch.ops import filters, lcg
from ntsc_crt_tpu_torch.ops.fixedpoint import cdiv, crem, i32, sincos14
from ntsc_crt_tpu_torch.ops.kernels import encode
from ntsc_crt_tpu_torch.parallel import spatial


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
def build_skeleton_nes(cfg: SystemConfig) -> np.ndarray:
    """NES-family skeleton (setup_field, crt_nes.c:81-104 / crt_nesrgb.c:24-47):
    every sample of every line is written, with a long sync separator on the
    bottom vsync lines 259-261."""
    H, V = cfg.hres, cfg.vres
    skel = np.full((V, H), cfg.blank_level, np.int8)
    sep_end = 327 * H // 341                            # PPUpx2pos(327)
    for n in range(V):
        end = sep_end if n >= 259 else cfg.bw_beg
        skel[n, cfg.sync_beg:end] = cfg.sync_level
    return skel


@functools.lru_cache(maxsize=16)
def _nes_skeleton(cfg: SystemConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(build_skeleton_nes(cfg), device=device)


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
    """K1 (encode.encode_rows) over the picture rows, split by row over the
    active spatial group (parallel/spatial.py): sy and the carrier tables
    by row, the image and gain/base whole (a row may read any source
    row)."""
    return spatial.shard_lines_call(
        encode.encode_rows, img.to(torch.uint8).contiguous(), sy.contiguous(),
        modI, modQ, gain, base, whole=(0, 4, 5), **static)


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

    per_row = lambda m: (m * ph[:, None])[:, None].expand(  # noqa: E731
        B, desth, CC).contiguous()
    ire = _encode_lines(img, sy, per_row(ccmodI), per_row(ccmodQ),
                        cdiv(cfg.white_level * white_point, 100),
                        cfg.black_level + black_point, coefs=_iir_coefs(cfg),
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


# ---------------------------------------------------------------------------
# SNES / TEMPLATE / PV1K: per-line vertical chroma phase (2D carrier tables)
# ---------------------------------------------------------------------------


def _burst_rows(ccburst: torch.Tensor, cfg: SystemConfig, row0: int,
                nrows: int) -> torch.Tensor:
    """Burst samples of field rows row0 .. row0 + nrows - 1: row n takes
    ccburst[b, n % VP, t % CC] at sample t of the burst window.  ccburst
    int32 (B, VP, CC) -> int8 (B, nrows, burst_len)."""
    dev = ccburst.device
    VP, CC = cfg.cc_vper, cfg.cc_samples
    cls = (torch.arange(nrows, device=dev) + row0) % VP
    t = (torch.arange(cfg.burst_len, device=dev) + cfg.cb_beg) % CC
    cb = ccburst[:, cls][:, :, t]
    return ((cfg.blank_level + cb * cfg.burst_level) >> 5).to(torch.int8)


def _vper_tables(cfg: SystemConfig, dco: torch.Tensor, base, burst_base,
                 q_offset: int):
    """The 2D tables (B, VP, CC) of crt_snes.c:170-188 and its kin: angle
    n = (y + dco) * vert_step + base + x * (360 / CC) at vertical class y
    and sample class x; the burst at n + burst_base, I at n, Q at
    n + q_offset.  Returns (burst, I, Q) as 14-bit sines >> 10."""
    dev = dco.device
    VP, CC = cfg.cc_vper, cfg.cc_samples
    yv = torch.arange(VP, dtype=torch.int32, device=dev)[None, :, None]
    xv = torch.arange(CC, dtype=torch.int32, device=dev)[None, None, :]
    n_ang = ((yv + dco[:, None, None]) * cfg.vert_step + base
             + xv * (360 // CC))
    b_sn, _ = sincos14(cdiv((n_ang + burst_base) * 8192, 180))
    i_sn, _ = sincos14(cdiv(n_ang * 8192, 180))
    q_sn, _ = sincos14(cdiv((n_ang + q_offset) * 8192, 180))
    return b_sn >> 10, i_sn >> 10, q_sn >> 10


def _encode_vper(cfg: SystemConfig, analog, img, sy, modI, modQ,
                 black_point, white_point, xo: int, yo: int, destw: int,
                 coefs) -> torch.Tensor:
    """K1 with each picture row's table picked by its field row's vertical
    class (y + yo) % VP, then the store at (yo, xo)."""
    desth = sy.shape[1]
    phr = (torch.arange(desth, device=analog.device) + yo) % cfg.cc_vper
    ire = _encode_lines(img, sy, modI[:, phr].contiguous(),
                        modQ[:, phr].contiguous(),
                        cdiv(cfg.white_level * white_point, 100),
                        cfg.black_level + black_point, coefs=coefs,
                        xo_mod=xo % cfg.cc_samples, destw=destw)
    return _store_active(analog, ire, xo, yo)


def modulate_vper(
    cfg: SystemConfig,
    analog: torch.Tensor,     # int8 (B, VRES, HRES)
    img: torch.Tensor,        # uint8 (B, h, w, 3)
    *,
    field, frame, hue, as_color=1, xoffset: int = 0, yoffset: int = 0,
    black_point=0, white_point=100, raw: bool = False,
    dot_crawl_offset=0, do_bloom: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """crt_snes.c:125-327 / crt_template.c:125-337 / crt_pv1k.c:121-321.

    Differences from the NTSC path: the carrier and burst tables are 2D
    [cc_vper][cc_samples] with a per-line vertical phase advance (dot
    crawl); the burst angle is (n - step + hue_offset); picture row y takes
    table row (y + yo) % cc_vper instead of a CC_PHASE sign flip; xo is
    aligned to cc_samples (crt_snes.c:201; PV1K's is 5); SNES has no
    interlace offset, so `field` picks only the skeleton; the iccf export
    writes class (n + 3) % VP from class n (crt_snes.c:239).  do_bloom: the
    CRT_DO_BLOOM destination sizing (crt_snes.c:144-151).  `frame` is unread,
    as in the reference.  Returns (analog', ccf' int32 (B, VP, CC))."""
    del frame
    if cfg.kind != "rgb":
        raise ValueError(f"{cfg.name}: not an RGB-input encoder")
    dev = analog.device
    B = analog.shape[0]
    CC, VP = cfg.cc_samples, cfg.cc_vper
    h, w = img.shape[1], img.shape[2]
    field = _b(field, B, dev) & 1
    hue = _b(hue, B, dev)
    black_point = _b(black_point, B, dev)
    white_point = _b(white_point, B, dev)

    destw, desth = _dest_size(cfg, raw, w, h, do_bloom)
    xo = cfg.av_beg + xoffset + (cfg.av_len - destw) // 2
    xo = xo - xo % CC                                     # crt_snes.c:201
    yo = cfg.top + yoffset + (cfg.lines - desth) // 2

    step = 360 // CC
    ccburst, ccmodI, ccmodQ = _vper_tables(
        cfg, _b(dot_crawl_offset, B, dev), hue[:, None, None],
        cfg.hue_offset - step, cfg.q_offset)
    on = (_b(as_color, B, dev) != 0)[:, None, None]
    ccburst, ccmodI, ccmodQ = (torch.where(on, t, 0)
                               for t in (ccburst, ccmodI, ccmodQ))

    skel_even, skel_odd, mask, vrows = _field_constants(cfg, dev)
    skel = torch.where((field == 1)[:, None, None], skel_odd, skel_even)
    analog = torch.where(mask, skel, analog)

    burst = slice(cfg.cb_beg, cfg.cb_beg + cfg.burst_len)
    analog[:, :, burst] = torch.where(
        vrows[None, :, None], _burst_rows(ccburst, cfg, 0, cfg.vres),
        analog[:, :, burst])

    # iccf[(n+3) % VP][k] is written from class n % VP (crt_snes.c:239)
    src = (torch.arange(VP, device=dev) - 3) % VP
    ccf = ((cfg.blank_level + ccburst[:, src] * cfg.burst_level) >> 5) << 7

    y_idx = torch.arange(desth, dtype=torch.int32, device=dev)[None, :]
    if cfg.interlace_offset:
        field_offset = cdiv(cdiv(field * h + desth, desth), 2)[:, None]
    else:
        field_offset = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    sy = ((y_idx * h) // desth + field_offset).clamp(max=h - 1)
    analog = _encode_vper(cfg, analog, img, sy, ccmodI, ccmodQ, black_point,
                          white_point, xo, yo, destw, _iir_coefs(cfg))
    return analog, ccf


# ---------------------------------------------------------------------------
# NESRGB: RGB input with NES timing/artifacts, no bandlimiting
# ---------------------------------------------------------------------------


def modulate_nesrgb(
    cfg: SystemConfig,
    analog: torch.Tensor,     # int8 (B, VRES, HRES)
    img: torch.Tensor,        # uint8 (B, h, w, 3)
    *,
    hue, dot_crawl_offset=0, xoffset: int = 0, yoffset: int = 0,
    black_point=0, white_point=100,
) -> tuple[torch.Tensor, torch.Tensor]:
    """crt_nesrgb.c:49-170: the NES skeleton (rewritten every call; the
    reference's run-once setup_field is equivalent, since the active region
    is rewritten each frame), burst on the picture rows only, carrier tables
    without the hue (the burst angle is hue + 90 + n + 33), no IIR: K1 runs
    without bandlimiting.  Returns (analog', ccf' int32 (B, VP, CC))."""
    dev = analog.device
    B = analog.shape[0]
    h = img.shape[1]
    hue = _b(hue, B, dev)

    destw, desth = cfg.av_len, cfg.lines                  # crt_nesrgb.c:53-54
    xo = (cfg.av_beg + xoffset) & ~3
    yo = cfg.top + yoffset

    ccburst, ccmodI, ccmodQ = _vper_tables(
        cfg, _b(dot_crawl_offset, B, dev), 0, hue[:, None, None] + 123, -90)

    analog = _nes_skeleton(cfg, dev).expand(B, -1, -1).clone()
    analog[:, yo:yo + desth, cfg.cb_beg:cfg.cb_beg + cfg.burst_len] = \
        _burst_rows(ccburst, cfg, yo, desth)
    ccf = ((cfg.blank_level + ccburst * cfg.burst_level) >> 5) << 7

    y_idx = torch.arange(desth, dtype=torch.int32, device=dev)[None, :]
    sy = ((y_idx * h) // desth).clamp(0, h - 1).expand(B, desth)
    analog = _encode_vper(cfg, analog, img, sy, ccmodI, ccmodQ,
                          _b(black_point, B, dev), _b(white_point, B, dev),
                          xo, yo, destw, None)
    return analog, ccf


# ---------------------------------------------------------------------------
# NES: square-wave synthesis from PPU pixel indices (crt_nes.c)
# ---------------------------------------------------------------------------

# amplified IRE levels (crt_nes.c:26-40) as [l][e][lum]
_NES_T = np.array(
    [-12042, 0, 34406, 81427,          # 0d 1d 2d 3d
     -17203, -8028, 19497, 57342,      # emphasized
     43581, 75693, 112965, 112965,     # 00 10 20 30
     26951, 52181, 83721, 83721],      # emphasized
    dtype=np.int64).reshape(2, 2, 4)


def _wrap_i8(x: torch.Tensor) -> torch.Tensor:
    """C signed-char assignment (wrap mod 256): the NES encoder stores
    unclamped IRE sums (crt_nes.c:190-191)."""
    return (((x + 128) & 255) - 128).to(torch.int8)


def _nes_square_sum4(p: torch.Tensor, phase0: torch.Tensor) -> torch.Tensor:
    """sum_{j<4} square_sample(p, phase0 + j) (crt_nes.c:21-61), exact —
    the JAX package's closed form (modulate.py:755-815).

    square_sample is IRE[l][e][lum], bilinear in the bits (l, e) for a fixed
    lum, so the 4-phase sum is 4*T00 + L*(T10-T00) + E*(T01-T00) +
    LE*(T11-T10-T01+T00) with L, E, LE the sums of l_j, e_j, l_j*e_j; each
    lum table is bilinear in lum's two bits; the emphasis masks
    {0300,0100,0500,0400,0600,0200} reduce to k = (phase>>1) % 6: bit6 iff
    k<=2, bit7 iff k==0 or k>=4, bit8 iff 2<=k<=4.  p, phase0: broadcastable
    non-negative int32; no clamp (|S| <= 4*112965)."""
    hue_p = p & 0x0F
    lum0 = (p >> 4) & 1
    lum1 = (p >> 5) & 1
    lum01 = lum0 & lum1
    e6, e7, e8 = (p >> 6) & 1, (p >> 7) & 1, (p >> 8) & 1
    is0 = (hue_p == 0x00).to(torch.int32)
    not13 = (hue_p != 0x0D).to(torch.int32)

    def blin(t):  # a 4-entry table, bilinear in the lum bits
        c0, c1, c2, c3 = (int(t[0]), int(t[1] - t[0]), int(t[2] - t[0]),
                          int(t[3] - t[2] - t[1] + t[0]))
        return c0 + c1 * lum0 + c2 * lum1 + c3 * lum01

    T = _NES_T
    t00 = blin(T[0, 0])
    d10 = blin(T[1, 0] - T[0, 0])
    d01 = blin(T[0, 1] - T[0, 0])
    d11 = blin(T[1, 1] - T[1, 0] - T[0, 1] + T[0, 0])

    u = crem(phase0, 12)
    z = hue_p + u                             # <= 26: two range reductions
    z = z - torch.where(z >= 12, 12, 0)
    z = z - torch.where(z >= 12, 12, 0)
    L = E = LE = 0
    for j in range(4):
        mj = u + j
        k = (mj - torch.where(mj >= 12, 12, 0)) >> 1     # (phase>>1) % 6
        zj = z + j
        v = ((zj - torch.where(zj >= 12, 12, 0)) < 6).to(torch.int32)
        a6 = (k <= 2).to(torch.int32)
        a7 = ((k == 0) | (k >= 4)).to(torch.int32)
        a8 = ((k >= 2) & (k <= 4)).to(torch.int32)
        e = (e6 & a6) | (e7 & a7) | (e8 & a8)
        l = is0 | (v & not13)
        L = L + l
        E = E + e
        LE = LE + (l & e)
    total = (t00 << 2) + L * d10 + E * d01 + LE * d11
    return torch.where(hue_p >= 0x0E, 0, total)           # black columns


def _nes_phase(rows: torch.Tensor, dco: torch.Tensor,
               VP: int) -> torch.Tensor:
    """phasetab[(row + dco) % VP] = 4 * class (B, n), with C's %: a
    negative class matches no entry and reads 0, as the JAX package's
    onehot_pick does."""
    cls = crem(rows[None, :] + dco[:, None], VP)
    return torch.where(cls >= 0, 4 * cls, 0)


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
    """crt_nes.c:106-201 (the optimized build).  The PPU pixels are
    resampled by index and square_sample is evaluated in closed form
    (_nes_square_sum4).  draw_border renders the PPU border (NES_BORDER,
    crt_nes.c:138-161); optimized=False is the NES_OPTIMIZED=0 build
    (crt_nes.c:204-308), whose only difference is the colour burst on every
    non-vsync line (0..258), not only on the picture rows.  Plain torch on
    every device.  Returns (analog', ccf' int32 (B, VP, CC))."""
    if cfg.kind != "nes":
        raise ValueError(f"{cfg.name}: not the NES encoder")
    dev = analog.device
    B = analog.shape[0]
    H, VP = cfg.hres, cfg.cc_vper
    h, w = ppu.shape[1], ppu.shape[2]
    ppu = ppu.to(torch.int32) & 0x1FF
    dco = _b(dot_crawl_offset, B, dev)
    black_point = _b(black_point, B, dev)[:, None, None]
    white_point = _b(white_point, B, dev)[:, None, None]

    destw, desth = cfg.av_len, cfg.lines
    xo = (cfg.av_beg + xoffset) & ~3
    yo = cfg.top + yoffset

    # burst table (crt_nes.c:123-130): the angle is reduced % 360 first
    yv = torch.arange(VP, dtype=torch.int32, device=dev)[None, :, None]
    xv = torch.arange(cfg.cc_samples, dtype=torch.int32, device=dev)
    n_ang = crem(_b(hue, B, dev)[:, None, None] + xv * (360 // cfg.cc_samples)
                 + (yv + dco[:, None, None]) * cfg.vert_step + 33, 360)
    ccburst = sincos14(cdiv(n_ang * 8192, 180))[0] >> 10

    analog = _nes_skeleton(cfg, dev).expand(B, -1, -1).clone()
    brow0, brows = (yo, desth) if optimized else (0, 259)  # crt_nes.c:174/249
    analog[:, brow0:brow0 + brows, cfg.cb_beg:cfg.cb_beg + cfg.burst_len] = \
        _burst_rows(ccburst, cfg, brow0, brows)
    ccf = ((cfg.blank_level + ccburst * cfg.burst_level) >> 5) << 7

    def to_ire(p, phase):
        ire = cfg.black_level + black_point + _nes_square_sum4(p, phase)
        return _wrap_i8(cdiv(ire * white_point, 100) >> 12)  # crt_nes.c:190

    if draw_border:
        # rows TOP..BOT+2, columns LAV_BEG..HRES, drawn before the picture
        # overwrites the middle; the first border column is pixel 0xf0
        nb0, nb1 = cfg.top, cfg.bot + 3
        tb = torch.arange(H - cfg.lav_beg, dtype=torch.int32, device=dev)
        phb = _nes_phase(torch.arange(nb0, nb1, dtype=torch.int32,
                                      device=dev), dco, VP) + 6
        pb = torch.where(tb == 0, 0xF0,
                         _b(border_color, B, dev)[:, None, None] & 0x1FF)
        analog[:, nb0:nb1, cfg.lav_beg:] = to_ire(
            pb, phb[..., None] + 3 * tb)

    sy = ((torch.arange(desth, device=dev) * h) // desth).clamp(max=h - 1)
    sx = (torch.arange(destw, device=dev) * w) // destw
    p = ppu[:, sy][:, :, sx]                              # (B, desth, destw)
    ph0 = _nes_phase(torch.arange(desth, dtype=torch.int32, device=dev)
                     + yo, dco, VP)
    xphase = 3 * (torch.arange(destw, dtype=torch.int32, device=dev) % 4)
    analog = _store_active(analog, to_ire(p, ph0[..., None] + xphase), xo, yo)
    return analog, ccf
