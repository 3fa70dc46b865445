"""Demodulator: sampled analog composite signals -> RGB, like a CRT would.

Counterpart of ``ntsc_crt_tpu/models/demodulate.py`` (crt_demodulate,
crt_core.c:291-666), batch-first, for 4- and 5-sample chroma systems, with
the reference's decode build variants: the 3-band or convolution EQ
(USE_CONVOLUTION), bloom (CRT_DO_BLOOM) and fixed sync (CRT_DO_VSYNC /
CRT_DO_HSYNC = 0).  Each stage keeps one formulation, the plain one:

1. **Noise injection** — the serial LCG in closed form (ops/lcg.py) in
   kernel K11, or on the VHS presets the crt_rand tracking noise: K11 over
   region A, the serial region-B march in kernel K5, and kernel K12's draws
   over regions B and C from K5's entry states.
2. **VSYNC recovery** — running sums over the candidate rows and the first
   crossing below the threshold (crt_core.c:369-397); with fixed vsync only
   the field parity, from the clean signal.
3. **Per-line sequential state** — the hsync chase (kernel K3, or pinned
   to 0 with fixed hsync), the burst gather and the ccf carrier EMA (kernel
   K4), then the decode waves (4-sample IQ extraction, or the 5-sample
   hue-rotated tables); with bloom the line sums and their energy
   EMA (kernel bloom_line_width) give each line its width.  No line is
   copied out of the noisy field: each reader takes a line's first field
   row and reads the field in place (fastpath.line_samples).
4. **Line decode** — alignment, Y/I/Q, EQ and scan conversion in kernel K2,
   the one stage split by line over a spatial group of cards
   (parallel/spatial.py); the others run whole on the frame's card.
5. **Row placement** — kernel K6 where every line covers the same number
   of rows and the knobs are host ints; otherwise K6's general mode: each
   output row takes the last line that covers it, blended with the
   previous frame if asked (crt_core.c:552-664).

Under a profiler each stage records its span (``utils/profiling.py``
``span``): ``ntsc.demodulate.noise``, ``.vsync``, ``.line_scan``, with
bloom ``.bloom`` (the line widths and the rotated wave tables), ``.decode``
and ``.place``.  `PLACEMENTS` counts the row placements by the path each
took.

K11 and the row placement are calls through ``graphs.eager``: under a CUDA
graph of the step (models/graphs.py) they stay eager, K11 because it reads
the modulator's fresh field (it writes the noisy field into the graph's
buffer), the placement because it reads the caller's previous output and
returns a fresh one.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Union

import numpy as np
import torch

from ntsc_crt_tpu_torch.models import graphs
from ntsc_crt_tpu_torch.models.systems import SystemConfig
from ntsc_crt_tpu_torch.ops import fastpath, filters, lcg
from ntsc_crt_tpu_torch.ops.fixedpoint import (cdiv, crem, np_sincos14,
                                               posmod, sincos14)
from ntsc_crt_tpu_torch.ops.kernels import ccf, decode, hsync, place, vhs
from ntsc_crt_tpu_torch.ops.kernels import noise as noise_kernels
from ntsc_crt_tpu_torch.models.modulate import _b
from ntsc_crt_tpu_torch.parallel import spatial
from ntsc_crt_tpu_torch.utils import profiling

Knob = Union[int, torch.Tensor]
# _place_rows calls by the path each took: "uniform" (K6), "uniform_bloom"
# (K6's bloom mode) or "general" (K6's general mode, on the CPU
# _place_rows_general); counted in the call, which graphs.eager makes on
# every replay too
PLACEMENTS: collections.Counter = collections.Counter()


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
    """crt_init's per-cc_samples EQ setup (crt_core.c:277-287)."""
    k = cfg.khz2l
    gains = {4: (8192, 9175), 5: (12192, 7775)}
    if cfg.cc_samples not in gains:
        raise ValueError(f"{cfg.name}: cc_samples must be 4 or 5")
    y = filters.init_eq(k(1500), k(3000), cfg.hres, 65536,
                        *gains[cfg.cc_samples])
    i = filters.init_eq(k(80), k(1150), cfg.hres, 65536, 65536, 1311)
    q = filters.init_eq(k(80), k(1000), cfg.hres, 65536, 65536, 0)
    return y, i, q


# ---------------------------------------------------------------------------
# Noise injection
# ---------------------------------------------------------------------------


def _i32_table(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint32 host table as its int32 bit patterns on `device`."""
    return torch.as_tensor(np.ascontiguousarray(a, np.uint32).view(np.int32),
                           device=device)


@functools.lru_cache(maxsize=8)
def _noise_tables(cfg: SystemConfig, device: torch.device):
    """K11's factors of the LCG over the field: sample i's state is
    A^(i+1) * rn + B * (A^i + ... + 1) (mod 2^32), int32 (N,) each."""
    apow, csum = lcg._lcg_tables(cfg.input_size, lcg.LCG_A, lcg.LCG_B)
    return _i32_table(apow, device), _i32_table(csum, device)


def _inject_noise(cfg: SystemConfig, analog2d: torch.Tensor, rn: torch.Tensor,
                  noise: torch.Tensor):
    """crt_core.c:346-367, batched, in kernel K11: analog2d int8 (B, V, H),
    contiguous; rn and noise int32 (B,).  Returns (noisy int8 (B, V, H),
    rn' int32 (B,))."""
    apow, csum = _noise_tables(cfg, analog2d.device)
    out, rn_out = graphs.eager(
        noise_kernels.inject_noise, analog2d.view(analog2d.shape[0], -1),
        apow, csum, rn, noise, shift=16, ga=lcg.LCG_A, gc=lcg.LCG_B,
        keep=(0, 1))
    return out.view(analog2d.shape), rn_out


def _vhs_regions(cfg: SystemConfig):
    """(n0, nB, nC): region A is samples i < n0, where cond1
    `i > N - H*(6 + rand()%20)` can never pass (2 calls a sample); B the
    next 19*H samples, where it may (the serial part); C the last 6H - 1,
    where it always does (3 calls a sample)."""
    N, H = cfg.input_size, cfg.hres
    n0 = N - 25 * H + 1
    nB = 19 * H
    return n0, nB, N - n0 - nB


@functools.lru_cache(maxsize=8)
def _vhs_tables(cfg: SystemConfig, device: torch.device):
    """The VHS noise's constant tables on `device`, int32: region A's
    first-call stream, every second crt_rand state from the head state
    (K11's apow / csum, n0 each); region C's three-call stream from its
    entry state (a3, c3, nC each); and the band sinusoid `cs >> 8` for
    band_line 10..17 over regions B+C (crt_core.c:353-356), (8, nB + nC)."""
    N, H = cfg.input_size, cfg.hres
    n0, nB, nC = _vhs_regions(cfg)
    apow, csum = lcg._lcg_tables(2 * n0, lcg.RAND_A, lcg.RAND_B)
    apow3, csum3 = lcg._lcg_tables(3 * nC, lcg.RAND_A, lcg.RAND_B)
    a3 = np.concatenate([np.ones(1, np.uint32), apow3[2::3]])[:nC]  # A^{3k}
    c3 = np.concatenate([np.zeros(1, np.uint32), csum3[2::3]])[:nC]
    iBC = np.arange(n0, N, dtype=np.int64)
    cs = np.stack([np_sincos14(iBC * bl // H * 8192 // 180)[1] >> 8
                   for bl in range(10, 18)])
    return dict(apowA=_i32_table(apow[::2], device),
                csumA=_i32_table(csum[::2], device),
                a3=_i32_table(a3, device), c3=_i32_table(c3, device),
                cs=torch.as_tensor(cs.astype(np.int32), device=device))


def _inject_noise_vhs(cfg: SystemConfig, analog_flat: torch.Tensor,
                      randstate: torch.Tensor, noise: torch.Tensor):
    """VHS tracking noise (crt_core.c:343-366 under CRT_VHS_NOISE): a
    sinusoidal band wobbles over the last ~16 lines, driven by crt_rand.
    analog_flat int8 (B, N), contiguous; randstate and noise int32 (B,).
    Returns (noisy int8 (B, N), randstate' int32 (B,), rn' = the last rand
    value int32 (B,), crt_core.c:359,367).

    The rand() calls per sample depend on the draws (C's && short circuit),
    so the stream is serial; it splits three ways (see _vhs_regions): A is
    kernel K11 over the stream's first calls, B the serial march of kernel
    K5, and kernel K12 draws every noise value of B and C from the entry
    states K5 emits (C's in closed form from B's last)."""
    n0, nB, nC = _vhs_regions(cfg)
    tab = _vhs_tables(cfg, analog_flat.device)
    head_st = lcg.crt_rand_step(randstate)                # call 0: band line
    band_line = (crem(lcg.crt_rand_out(head_st), 8) - 4) + 14   # 10..17
    # region A: sample k's first call is crt_rand state 2k + 1 from head_st,
    # its byte bits 17..24 of the state; its second call ends the region
    out, lastA = graphs.eager(
        noise_kernels.inject_noise, analog_flat, tab["apowA"], tab["csumA"],
        head_st, noise, shift=17, ga=vhs.A2, gc=vhs.C2, keep=(0, 1))
    stA = lcg.crt_rand_step(lastA)
    entB = vhs.vhs_region_b_entries(stA, n_steps=nB, H=cfg.hres)
    return noise_kernels.vhs_noise_bc(out, entB, tab["a3"], tab["c3"],
                                      tab["cs"], band_line, noise, H=cfg.hres)


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


def _line_scan(cfg: SystemConfig, inp2d, hsync0, ccf0, vsync, hue, hue_sn,
               hue_cs, saturation, outh: int, v_fac: int, field_px,
               do_hsync: bool = True):
    """Per-line sequential pass: hsync chase, ccf EMA and the decode waves
    (crt_core.c:409-536).  inp2d int8 (B, V, H); carries (B, ...); hue the
    monitor hue (B,).  Returns (hsync', ccf', (xpos, ypos, beg, end,
    active, waveI, waveQ) per line), ypos the field row (top + l + vsync
    + 3) mod V that line l's decode starts on (ynudge=+3).
    do_hsync=False is the CRT_DO_HSYNC=0 build: no chase, hsync pinned."""
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

    # line l's samples, read in place: field row (top + l + vsync) mod V,
    # continued into the following row (flat-indexing reads; at the bottom
    # the reference reads out of bounds — UB — and this wraps to the top).
    # The chase's pad covers the furthest read: the burst window at the
    # largest hsync and the hsync search window.
    PAD = max(cfg.cb_beg + cfg.burst_len, cfg.sync_beg + 2 * W) + 2 * W
    row_l = posmod(lines[None, :] + vsync[:, None], V)   # (B, L)

    if do_hsync:
        hsync_l = hsync.hsync_chase(
            inp2d, row_l, active_l.contiguous(), hsync0.contiguous(),
            pad=PAD, W=W, c0=cfg.sync_beg - W,
            thresh=cfg.hsync_thresh * cfg.sync_level)
    else:
        # crt_core.c:446-448: every processed line pins v->hsync = 0
        ever = torch.cumsum(active_l.to(torch.int32), dim=1) > 0
        hsync_l = torch.where(ever, 0, hsync0[:, None])
    hsync_f = hsync_l[:, L - 1]

    xpos_l = posmod(cfg.av_beg + hsync_l - 3, H)          # xnudge=-3
    ypos_l = posmod(lines[None, :] + vsync[:, None] + 3, V)  # ynudge=+3
    vper_l = crem(ypos_l, cfg.cc_vper)                    # (B, L)

    # burst window of every line (crt_core.c:458-466)
    if CC == 4:
        bbase = (hsync_l & ~3) + cfg.cb_beg
    else:
        bbase = hsync_l - crem(hsync_l, CC) + cfg.cb_beg
    bvals = fastpath.line_samples(
        inp2d, row_l, torch.arange(cfg.burst_len, device=dev),
        offset=bbase).to(torch.int32)                     # (B, L, burst_len)
    m = cfg.burst_len // CC
    # class k is burst column (k - cb_beg) mod CC: a rotation, which a list
    # index would copy to the card through a stream synchronize
    per_cls = torch.roll(bvals.reshape(B, L, m, CC), cfg.cb_beg % CC, dims=-1)
    ccf_f, ccr_l = ccf.ccf_ema(per_cls.contiguous(), vper_l.contiguous(),
                               active_l.contiguous(), ccf0.contiguous())

    # decode waves (B, L, CC) for I and Q
    phasealign = posmod(hsync_l, CC)

    def pick(off):
        idx = crem(phasealign + off, CC).long()[..., None]
        return torch.gather(ccr_l, 2, idx)[..., 0]

    if CC == 4:  # 4-sample IQ extraction (crt_core.c:471-479)
        dci = pick(1) - pick(3)
        dcq = pick(2) - pick(0)
        hs = hue_sn[:, None]
        hc = hue_cs[:, None]
        w0 = ((dci * hc - dcq * hs) >> 4) * saturation[:, None]
        w1 = ((dcq * hc + dci * hs) >> 4) * saturation[:, None]
        waveI = torch.stack([w0, w1, -w0, -w1], dim=2)
        waveQ = torch.roll(waveI, -3, dims=-1)             # crt_core.c:541-542
    else:  # 5-sample variant (crt_core.c:480-509)
        off180, off90 = CC // 2, CC // 4
        dci = pick(off90) - cdiv(pick(off90 + off180)
                                 + pick(off90 + off180 + 1), 2)
        dcq = pick(off180) - pick(0)
        # wave tables rotated by the hue
        ang = (crem(hue, 360)[:, None]
               + torch.arange(CC, dtype=torch.int32, device=dev) * (360 // CC))
        snI, csI = sincos14(cdiv(ang * 8192, 180))
        snQ, csQ = sincos14(cdiv((ang + 90) * 8192, 180))
        sat = saturation[:, None, None]
        dci, dcq = dci[..., None], dcq[..., None]
        waveI = ((dci * csI[:, None] + dcq * snI[:, None]) >> 15) * sat
        waveQ = ((dci * csQ[:, None] + dcq * snQ[:, None]) >> 15) * sat
    return hsync_f, ccf_f, (xpos_l, ypos_l, beg_l, end_l, active_l, waveI,
                            waveQ)


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
    randstate=None,           # (B,) crt_rand state, read on VHS presets
    v_fac: int = 0,
    eq_mode: str = "threeband",
    do_bloom: bool = False,
    do_vsync: bool = True,
    do_hsync: bool = True,
) -> tuple[torch.Tensor, dict]:
    """One decode pass.  Returns (rgb uint8 (B, outh, outw, 3), new state
    dict with keys hsync/vsync/ccf/rn/randstate; randstate comes back as
    given where the preset draws no VHS noise).  eq_mode "threeband" or
    "conv4".."conv7" (USE_CONVOLUTION, 4-sample chroma only); do_bloom
    (CRT_DO_BLOOM); do_vsync/do_hsync=False (CRT_DO_VSYNC/CRT_DO_HSYNC=0)."""
    if eq_mode == "threeband":
        coefs = _eq_coefs(cfg)
    elif (eq_mode.startswith("conv") and eq_mode[4:].isdigit()
          and int(eq_mode[4:]) in filters._CONV_EQ_KERNELS):
        if cfg.cc_samples != 4:  # crt_core.c:90
            raise ValueError(f"{cfg.name}: the convolution EQ needs "
                             "4-sample chroma")
        coefs = ("conv", int(eq_mode[4:]))
    else:
        raise ValueError(f"eq_mode must be 'threeband' or 'conv4'..'conv7', "
                         f"got {eq_mode!r}")
    B, outh, outw = out_prev.shape[0], out_prev.shape[1], out_prev.shape[2]
    dev = analog.device
    L, AV, CC = cfg.lines, cfg.av_len, cfg.cc_samples
    noise = _b(noise, B, dev)

    bright = _b(mon.brightness, B, dev) - (
        cfg.black_level + _b(mon.black_point, B, dev))
    hue_ang = (crem(_b(mon.hue, B, dev), 360) + 33) * 8192
    sn, cs = sincos14(cdiv(hue_ang, 180))
    hue_sn, hue_cs = sn >> 11, cs >> 11                   # crt_core.c:318-320
    saturation = _b(mon.saturation, B, dev)

    with profiling.span("demodulate.noise"):
        if cfg.vhs_noise:
            inp_flat, randstate, rn_new = _inject_noise_vhs(
                cfg, analog.view(B, -1), _b(randstate, B, dev), noise)
            inp2d = inp_flat.reshape(analog.shape)
        else:
            inp2d, rn_new = _inject_noise(cfg, analog, _b(rn, B, dev), noise)
    with profiling.span("demodulate.vsync"):
        if do_vsync:
            vsync_new, field = _find_vsync(cfg, inp2d, _b(vsync, B, dev))
        else:
            # CRT_DO_VSYNC=0 (crt_core.c:323-341): the field parity comes
            # from the clean signal and the vsync position is pinned to -3
            _, field = _find_vsync(cfg, analog, _b(vsync, B, dev))
            vsync_new = torch.full((B,), -3, dtype=torch.int32, device=dev)

    with profiling.span("demodulate.line_scan"):
        ratio = ((outh << 16) // cfg.lines + 32768) >> 16
        field_px = field * (ratio // 2)
        hsync_new, ccf_new, outs = _line_scan(
            cfg, inp2d, _b(hsync, B, dev), ccf.to(torch.int32), vsync_new,
            _b(mon.hue, B, dev), hue_sn, hue_cs, saturation, outh, v_fac,
            field_px, do_hsync=do_hsync)
        xpos_l, ypos_l, beg_l, end_l, active_l, wvI_l, wvQ_l = outs

    # line l reads field rows ypos and ypos + 1 (mod V)
    shifts, bloom, drawn = xpos_l, {}, None
    if do_bloom:
        with profiling.span("demodulate.bloom"):
            dx_l, scan_l = _bloom_lines(cfg, inp2d, ypos_l, xpos_l, noise,
                                        outw)
            lidx_l = scan_l >> 12
            shifts = xpos_l + lidx_l          # the EQ starts at scanL >> 12
            # the carrier phase at that start: tables rotated by lidx mod CC
            rot = (torch.arange(CC, device=dev)
                   + (lidx_l % CC)[..., None]) % CC
            wvI_l = torch.gather(wvI_l, 2, rot)
            wvQ_l = torch.gather(wvQ_l, 2, rot)
            bloom = dict(bloom_dx=dx_l.contiguous(),
                         bloom_lidx=lidx_l.contiguous())
            drawn = dict(bloom_dx=bloom["bloom_dx"],
                         bloom_scan=scan_l.contiguous(), av_len=AV)
    # K2, split by line over the active spatial group: a line may read any
    # field row, so every card takes the whole field
    with profiling.span("demodulate.decode"):
        rgb = spatial.shard_lines_call(
            decode.decode_rows, inp2d, ypos_l.contiguous(),
            shifts.contiguous(), wvI_l.contiguous(), wvQ_l.contiguous(),
            bright[:, None].expand(B, L).contiguous(),
            _b(mon.contrast, B, dev)[:, None].expand(B, L).contiguous(),
            whole=(0,), coefs=coefs, av_len=AV, outw=outw, **bloom)
    with profiling.span("demodulate.place"):
        out_new = graphs.eager(_place_rows, rgb, out_prev, beg_l, end_l,
                               active_l, mon.blend, mon.scanlines, outh,
                               bloom=drawn, field_px=field_px, v_fac=v_fac)
    return out_new, dict(hsync=hsync_new, vsync=vsync_new, ccf=ccf_new,
                         rn=rn_new, randstate=randstate)


def _bloom_lines(cfg: SystemConfig, inp2d, ypos_l, xpos_l, noise,
                 outw: int):
    """Beam-energy bloom (crt_core.c:512-532): each line's sample sum drives
    an energy EMA that sets the drawn line's width; kernel
    bloom_line_width forms both.  inp2d int8 (B, V, H): line l reads field
    row ypos_l[l] and, where the [xpos, xpos + AV) window spills, the next
    (mod V).  Returns (dx, scan_l) int32 (B, L): each line's pixel step and
    its first sample in 1/4096 (the EQ starts at scan_l >> 12; pixel p is
    drawn iff scan_l + p * dx < (AV - 1) << 12, bloom_drawn)."""
    AV = cfg.av_len
    max_e = (128 + cdiv(noise, 2)) * AV                   # (B,)
    prev_e = decode.bloom_line_width(inp2d, ypos_l.contiguous(),
                                     xpos_l.contiguous(), max_e.contiguous(),
                                     av_len=AV)
    line_w = (AV * 112 // 128) + (prev_e >> 9)
    dx = (line_w << 12) // outw
    scan_l = ((AV // 2) - (line_w >> 1) + 8) << 12
    return dx, scan_l


def bloom_drawn(bloom_dx, bloom_scan, av_len: int, outw: int):
    """bool (B, L, outw): the pixels inside each bloom line's drawn width
    (crt_core.c:555 loop bound), in wrapping int32."""
    p = torch.arange(outw, dtype=torch.int32, device=bloom_dx.device)
    return bloom_scan[..., None] + p * bloom_dx[..., None] < ((av_len - 1)
                                                              << 12)


def _place_rows(rgb, out_prev, beg_l, end_l, active_l, blend, scanlines,
                outh: int, *, bloom=None, field_px=None,
                v_fac: int = 0) -> torch.Tensor:
    """The reference's sequential row writes (store at `beg`, duplicate up to
    `end - scanlines`, 50/50 blend against the previous contents;
    crt_core.c:552-664).

    Kernel K6 takes the uniform case — JAX's gate (demodulate.py:1275-1279):
    blend and scanlines host ints, (outh + v_fac) % L == 0 and 0 <=
    scanlines < ratio = (outh + v_fac) // L — when also outh == ratio * L;
    bloom's lines (`bloom`: K6's bloom_dx, bloom_scan and av_len) in its
    bloom mode, where JAX's gate sends them to the general path.
    Otherwise K6's general mode, place.place_rows_general: on a CPU
    tensor _place_rows_general with bloom's `valid` plane."""
    B, L = rgb.shape[0], rgb.shape[1]
    host = (int, np.integer)
    if (field_px is not None and isinstance(blend, host)
            and isinstance(scanlines, host) and (outh + v_fac) % L == 0):
        ratio = (outh + v_fac) // L
        if 0 <= scanlines < ratio and outh == ratio * L:
            fp = ((((outh << 16) // L) + 32768) >> 16) // 2
            PLACEMENTS["uniform" if bloom is None else "uniform_bloom"] += 1
            return place.place_rows_uniform(
                rgb, out_prev, field_px.contiguous(), blend=bool(blend),
                scanlines=int(scanlines), ratio=ratio, fp=fp,
                **(bloom or {}))
    PLACEMENTS["general"] += 1

    def knob(x):
        return x if isinstance(x, host) else _b(x, B, rgb.device)
    return place.place_rows_general(
        rgb, out_prev, beg_l.contiguous(), end_l.contiguous(),
        active_l.contiguous(), blend=knob(blend), scanlines=knob(scanlines),
        **(bloom or {}))


def _place_rows_general(rgb, out_prev, beg_l, end_l, active_l, blend,
                        scanlines, outh: int, *, valid=None) -> torch.Tensor:
    """One per-output-row gather: each row takes the last line that covers
    it.  "Last line wins" equals the C semantics whenever line begs strictly
    increase — true iff outh + v_fac >= CRT_LINES (e.g. 480 >= 240).  valid
    (bool (B, L, outw), bloom): a pixel outside its line's drawn width keeps
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
    # a blend known to be off on the host skips the blend
    blend_on = torch.is_tensor(blend) or np.any(blend)
    if blend_on or valid is not None:
        beg_sel = torch.gather(beg_l, 1, lsel.long())
        old_at_beg = fastpath.select_rows_batched(out_prev,
                                                  beg_sel.clamp(0, outh - 1))
    if blend_on:
        blended = (content >> 1) + (old_at_beg >> 1)      # crt_core.c:608
        on = _b(blend, B, dev) != 0
        content = torch.where(on[:, None, None, None], blended, content)
    if valid is not None:
        vsel = fastpath.select_rows_batched(valid, lsel)  # (B, outh, outw)
        content = torch.where(vsel[..., None], content, old_at_beg)
    return torch.where(exists[..., None, None], content, out_prev)
