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
   bandlimits, modulates and clamps every picture row;
   `fastpath.store_active` places the block in the field.  NES's square
   waves are kernel K13 (ops/kernels/nes.py), which stores its block itself
   (the JAX package leaves that pass to XLA).

On the card the NTSC family (``modulate_rgb``, ``modulate_vhs``) and the
vper encoders (``modulate_vper``) write the three phases and VHS's sync
kill in one launch, K1's field mode (``encode.encode_field``), each byte of
the new field once, the burst laid by each row's vertical class; its plain
version, the CPU's path, makes the passes one after another
(``encode.assemble_field``), as the line split does around K1's block
(``_write_field``).

Under a profiler the carrier and burst tables (and VHS's draw) record the
span ``ntsc.modulate.field``, and the field's bytes ``ntsc.modulate.encode``
(``utils/profiling.py`` ``span``); NES's one kernel is its ``encode``.
Inside ``encode`` NESRGB's full-field passes record their own spans: the
skeleton and the burst stored into it ``ntsc.modulate.skeleton``, K1's
block stored into the field ``ntsc.modulate.store``.

Each family writes its new field's bytes in one call through
``graphs.eager``: under a CUDA graph of the step (models/graphs.py) that
call stays eager, since it reads the caller's image and field and returns
a fresh field; the tables before it are (B,)-sized graph work.

The JAX package's one-hot einsums (its TPU gathers) are plain indexing here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ntsc_crt_tpu_torch.models import graphs
from ntsc_crt_tpu_torch.models.systems import CHROMA_CHECKERED, SystemConfig
from ntsc_crt_tpu_torch.ops import fastpath, filters, lcg
from ntsc_crt_tpu_torch.ops.fixedpoint import (cdiv, crem, host_i32, i32,
                                               sincos14)
from ntsc_crt_tpu_torch.ops.kernels import encode, nes
from ntsc_crt_tpu_torch.parallel import spatial
from ntsc_crt_tpu_torch.utils import profiling


def _b(x, B: int, device) -> torch.Tensor:
    """A scalar-or-(B,) parameter as an int32 (B,) tensor on `device`; a
    Python int wraps to int32 on the host (one fill on the device)."""
    if isinstance(x, (int, np.integer)):
        return torch.full((B,), host_i32(x), dtype=torch.int32,
                          device=device)
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
def _field_tables(cfg: SystemConfig, device: torch.device):
    """(skel (2, VRES, HRES) int8, even parity's then odd's, mask_end
    (VRES,) int32, video_rows) on `device`: K1's field mode's constants,
    copied once (a copy from host memory in every step would stall the host
    until the device drained).  The skeleton writes a prefix of every row
    (its blanked rows whole, a picture row up to av_beg), mask_end[r]
    samples of row r."""
    skel_even, skel_odd, mask = build_skeletons(cfg)
    mask_end = mask.sum(axis=1).astype(np.int32)
    if not (mask == (np.arange(cfg.hres) < mask_end[:, None])).all():
        raise AssertionError(f"{cfg.name}: the skeleton's mask is not a "
                             "prefix of each row")
    return tuple(torch.as_tensor(a, device=device) for a in (
        np.stack([skel_even, skel_odd]), mask_end, video_rows_mask(cfg)))


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
    do_bloom: the CRT_DO_BLOOM destination sizing.  `analog` is only
    read: analog' is a new tensor."""
    analog, ccf, _ = _modulate_ntsc(
        cfg, analog, img, None, 0, field=field, frame=frame, hue=hue,
        as_color=as_color, xoffset=xoffset, yoffset=yoffset,
        black_point=black_point, white_point=white_point, raw=raw,
        do_bloom=do_bloom)
    return analog, ccf


def _modulate_ntsc(cfg, analog, img, randstate, do_aberration, *, field,
                   frame, hue, as_color, xoffset, yoffset, black_point,
                   white_point, raw, do_bloom):
    """modulate_rgb, and with a randstate modulate_vhs's head switching:
    one crt_rand draw a frame (where do_aberration) picks the bottom rows
    that lose their sync tips, and the ccf export is zeroed.  Returns
    (analog', ccf', randstate' or None)."""
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

    with profiling.span("modulate.field"):
        inv_phase = (field == frame).to(torch.int32)      # crt_ntsc.c:199
        if cfg.chroma_pattern == CHROMA_CHECKERED:
            ph = 1 - 2 * (inv_phase & 1)                  # CC_PHASE
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

        # the burst's samples (B, burst_len) (crt_ntsc.c:243-250)
        t = torch.arange(cfg.burst_len, device=dev) + cfg.cb_beg
        cb_idx = (t[None, :] + flip[:, None]) % CC
        burst = ((cfg.blank_level + torch.gather(ccburst, 1, cb_idx)
                  * cfg.burst_level) >> 5).to(torch.int8)

        if randstate is None:
            # iccf export: last burst write per phase class (crt_ntsc.c:249,
            # 325-329)
            icc_idx = (k.long() + flip[:, None]) % CC
            iccf = (cfg.blank_level + torch.gather(ccburst, 1, icc_idx)
                    * cfg.burst_level) >> 5
            ccf = (iccf << 7)[:, None, :].expand(B, cfg.cc_vper,
                                                 CC).contiguous()
            kill = None
        else:
            # head switching: 6..17 killed bottom rows (crt_ntscvhs.c:234-
            # 238); a zeroed export (:330-335)
            do_ab = _b(do_aberration, B, dev) != 0
            rs = _b(randstate, B, dev)
            rs_next = lcg.crt_rand_step(rs)
            kill = torch.where(
                do_ab, (crem(lcg.crt_rand_out(rs_next), 12) - 8) + 14, 0)
            randstate = torch.where(do_ab, rs_next, rs)
            ccf = torch.zeros((B, cfg.cc_vper, CC), dtype=torch.int32,
                              device=dev)

    # --- active video, and every other byte of the field --------------------
    with profiling.span("modulate.encode"):
        y_idx = torch.arange(desth, dtype=torch.int32, device=dev)[None, :]
        field_offset = cdiv(cdiv(field * h + desth, desth), 2)[:, None]
        # C reads one row past the image at the bottom (UB); clamp to the
        # last
        sy = ((y_idx * h) // desth + field_offset).clamp(max=h - 1)

        per_row = lambda m: (m * ph[:, None])[:, None].expand(  # noqa: E731
            B, desth, CC).contiguous()
        rows = (img.to(torch.uint8).contiguous(), sy.contiguous(),
                per_row(ccmodI), per_row(ccmodQ),
                cdiv(cfg.white_level * white_point, 100),
                cfg.black_level + black_point)
        analog = _write_field(cfg, rows, analog, field, burst[:, None], kill,
                              xo=xo, yo=yo, destw=destw)
        return analog, ccf, randstate


def _write_field(cfg: SystemConfig, rows, analog, parity, burst, kill, *,
                 xo: int, yo: int, destw: int) -> torch.Tensor:
    """The RGB encoders' new field from K1's arguments `rows` (image, source
    rows, per-row carrier tables, gain, base), the caller's field, each
    frame's parity, its burst (B, P, burst_len) by row class r % P and VHS's
    kill (or None): K1's field mode in one launch; under the line split, or
    at a placement the field mode does not take, K1's block split by line
    and then the passes (encode.assemble_field)."""
    frame_args = (analog, *_field_tables(cfg, analog.device), parity, burst,
                  kill)
    kw = dict(xo=xo, yo=yo, cb_beg=cfg.cb_beg, bw_beg=cfg.bw_beg,
              blank=cfg.blank_level)
    if spatial.active() or not (0 <= xo < cfg.hres and yo >= 0):
        ire = _encode_lines(*rows, coefs=_iir_coefs(cfg),
                            xo_mod=xo % cfg.cc_samples, destw=destw)
        return encode.assemble_field(analog, ire, *frame_args[1:], **kw)
    return graphs.eager(encode.encode_field, *rows, *frame_args,
                        coefs=_iir_coefs(cfg), destw=destw, **kw)


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
    return _modulate_ntsc(
        cfg, analog, img, randstate, do_aberration, field=field,
        frame=frame, hue=hue, as_color=as_color, xoffset=xoffset,
        yoffset=yoffset, black_point=black_point, white_point=white_point,
        raw=raw, do_bloom=do_bloom)


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


def _vper_rows(cfg: SystemConfig, img, sy, modI, modQ, black_point,
               white_point, yo: int):
    """K1's arguments with each picture row's table picked by its field
    row's vertical class (y + yo) % VP."""
    phr = (torch.arange(sy.shape[1], device=sy.device) + yo) % cfg.cc_vper
    return (img.to(torch.uint8).contiguous(), sy.contiguous(),
            modI[:, phr].contiguous(), modQ[:, phr].contiguous(),
            cdiv(cfg.white_level * white_point, 100),
            cfg.black_level + black_point)


def _encode_vper(cfg: SystemConfig, analog, img, sy, modI, modQ,
                 black_point, white_point, xo: int, yo: int, destw: int,
                 coefs) -> torch.Tensor:
    """K1's block over _vper_rows, then the store at (yo, xo)."""
    ire = _encode_lines(*_vper_rows(cfg, img, sy, modI, modQ, black_point,
                                    white_point, yo), coefs=coefs,
                        xo_mod=xo % cfg.cc_samples, destw=destw)
    with profiling.span("modulate.store"):
        return fastpath.store_active(analog, ire, xo, yo)


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
    with profiling.span("modulate.field"):
        ccburst, ccmodI, ccmodQ = _vper_tables(
            cfg, _b(dot_crawl_offset, B, dev), hue[:, None, None],
            cfg.hue_offset - step, cfg.q_offset)
        on = (_b(as_color, B, dev) != 0)[:, None, None]
        ccburst, ccmodI, ccmodQ = (torch.where(on, t, 0)
                                   for t in (ccburst, ccmodI, ccmodQ))

        # iccf[(n+3) % VP][k] is written from class n % VP (crt_snes.c:239)
        src = (torch.arange(VP, device=dev) - 3) % VP
        ccf = ((cfg.blank_level + ccburst[:, src] * cfg.burst_level)
               >> 5) << 7
        # the burst's samples by vertical class: field row n takes class
        # n % VP
        burst = _burst_rows(ccburst, cfg, 0, VP)

    with profiling.span("modulate.encode"):
        y_idx = torch.arange(desth, dtype=torch.int32, device=dev)[None, :]
        if cfg.interlace_offset:
            field_offset = cdiv(cdiv(field * h + desth, desth), 2)[:, None]
        else:
            field_offset = torch.zeros((B, 1), dtype=torch.int32,
                                       device=dev)
        sy = ((y_idx * h) // desth + field_offset).clamp(max=h - 1)
        rows = _vper_rows(cfg, img, sy, ccmodI, ccmodQ, black_point,
                          white_point, yo)
        analog = _write_field(cfg, rows, analog, field, burst, None, xo=xo,
                              yo=yo, destw=destw)
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

    with profiling.span("modulate.field"):
        ccburst, ccmodI, ccmodQ = _vper_tables(
            cfg, _b(dot_crawl_offset, B, dev), 0, hue[:, None, None] + 123,
            -90)
        ccf = ((cfg.blank_level + ccburst * cfg.burst_level) >> 5) << 7

    with profiling.span("modulate.encode"):
        y_idx = torch.arange(desth, dtype=torch.int32, device=dev)[None, :]
        sy = ((y_idx * h) // desth).clamp(0, h - 1).expand(B, desth)
        analog = graphs.eager(_nesrgb_field, cfg, img, ccburst, sy, ccmodI,
                              ccmodQ, _b(black_point, B, dev),
                              _b(white_point, B, dev), xo=xo, yo=yo,
                              destw=destw)
        return analog, ccf


def _nesrgb_field(cfg: SystemConfig, img, ccburst, sy, modI, modQ,
                  black_point, white_point, *, xo: int, yo: int,
                  destw: int) -> torch.Tensor:
    """modulate_nesrgb's new field: the NES skeleton, the burst on the
    picture rows, K1's block (no bandlimiting) stored at (yo, xo)."""
    desth = sy.shape[1]
    with profiling.span("modulate.skeleton"):
        analog = _nes_skeleton(cfg, img.device).expand(ccburst.shape[0], -1,
                                                       -1).clone()
        analog[:, yo:yo + desth, cfg.cb_beg:cfg.cb_beg + cfg.burst_len] = \
            _burst_rows(ccburst, cfg, yo, desth)
    return _encode_vper(cfg, analog, img, sy, modI, modQ, black_point,
                        white_point, xo, yo, destw, None)


# ---------------------------------------------------------------------------
# NES: square-wave synthesis from PPU pixel indices (crt_nes.c)
# ---------------------------------------------------------------------------


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
    with profiling.span("modulate.encode"):
        return graphs.eager(
            _nes_field, analog, ppu, nes.square_table(dev),
            _b(dot_crawl_offset, B, dev), _b(black_point, B, dev),
            _b(white_point, B, dev), _b(border_color, B, dev),
            _b(hue, B, dev), nes.burst_sines(dev), xo=xo, yo=yo,
            destw=destw, desth=desth, draw_border=draw_border,
            box=(cfg.top, cfg.bot + 3, cfg.lav_beg), vp=cfg.cc_vper,
            skeleton=(cfg.sync_beg, cfg.bw_beg, 259, 327 * H // 341,
                      cfg.sync_level, cfg.blank_level),
            burst_box=(brow0, brows, cfg.cb_beg, cfg.burst_len),
            cc=cfg.cc_samples, vert_step=cfg.vert_step,
            burst_level=cfg.burst_level, black_level=cfg.black_level,
            keep=(1,))


def _nes_field(like: torch.Tensor, *args, out=None, **kw):
    """K13 into a new field shaped as `like`, whose bytes are not read; its
    ccf export into out[1] where `out` is given (graphs.eager's keep)."""
    if out is not None:
        kw["ccf"] = out[1]
    return nes.nes_square(torch.empty_like(like), *args, **kw)
