"""Frozen: the port's frame step in the bloom build (``pipeline.step(...,
do_bloom=True)`` of ``ntsc_crt_tpu_torch/models``) on the plain versions,
as it stood when the bloom cell was defined: NTSC's encoder drawing the
bloom build's smaller picture (crt_ntsc.c:148-173), then the decoder with
each line's drawn width from the energy EMA (crt_core.c:512-555).

The encoder, the noise, the vsync search, the line scan and the stacked
row placement are the frozen reference's; this module adds the line
widths, the rotated carrier tables, K2's bloom mode and the placement of
the drawn pixels."""

from __future__ import annotations

import numpy as np
import torch

from crt_bench.reference import demodulate as _dem
from crt_bench.reference import kernels as _ref_kernels
from crt_bench.reference import modulate as _mod
from crt_bench.reference.demodulate import MonitorParams
from crt_bench.reference.fixedpoint import cdiv, crem, sincos14
from crt_bench.reference.modulate import _b
from crt_bench.reference.pipeline import CRTState
from crt_bench.reference.systems import SystemConfig
from crt_bench.reference_bloom import kernels


def bloom_lines(cfg: SystemConfig, pairs, xpos_l, noise, outw: int):
    """Each line's pixel step dx and first sample scan_l in 1/4096, int32
    (B, L) each, from the line widths the energy EMA sets
    (crt_core.c:512-532)."""
    AV = cfg.av_len
    max_e = (128 + cdiv(noise, 2)) * AV                   # (B,)
    prev_e = kernels.bloom_line_width_plain(pairs, xpos_l, max_e, av_len=AV)
    line_w = (AV * 112 // 128) + (prev_e >> 9)
    dx = (line_w << 12) // outw
    scan_l = ((AV // 2) - (line_w >> 1) + 8) << 12
    return dx, scan_l


def _place_rows(rgb, out_prev, beg_l, end_l, active_l, blend, scanlines,
                outh: int, *, field_px, bloom_dx, bloom_scan, av_len: int):
    """K6's stacked form in its bloom mode where every line covers the same
    rows and the knobs are host ints (the port's gate); otherwise the
    general placement with the drawn-pixel plane."""
    L = rgb.shape[1]
    host = (int, np.integer)
    if (isinstance(blend, host) and isinstance(scanlines, host)
            and outh % L == 0 and 0 <= scanlines < outh // L):
        ratio = outh // L
        fp = ((((outh << 16) // L) + 32768) >> 16) // 2
        return _ref_kernels.place_rows_uniform_plain(
            rgb, out_prev, field_px.contiguous(), blend=bool(blend),
            scanlines=int(scanlines), ratio=ratio, fp=fp, bloom_dx=bloom_dx,
            bloom_scan=bloom_scan, av_len=av_len)
    valid = kernels.bloom_drawn(bloom_dx, bloom_scan, av_len, rgb.shape[2])
    return kernels.place_rows_general(rgb, out_prev, beg_l, end_l, active_l,
                                      blend, scanlines, outh, valid=valid)


def demodulate_core(cfg: SystemConfig, analog, out_prev, hsync, vsync, ccf,
                    rn, noise, mon: MonitorParams, *, randstate,
                    eq_float: bool = False):
    """One decode pass of the bloom build, 3-band EQ, sync recovery on.
    Returns (rgb uint8 (B, outh, outw, 3), the new state's hsync / vsync /
    ccf / rn / randstate; randstate as given).  eq_float: the benchmark's
    control (decode_rows_bloom_plain)."""
    coefs = _dem._eq_coefs(cfg)
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

    inp2d, rn_new = _dem._inject_noise(cfg, analog, _b(rn, B, dev), noise)
    vsync_new, field = _dem._find_vsync(cfg, inp2d, _b(vsync, B, dev))
    ratio = ((outh << 16) // cfg.lines + 32768) >> 16
    field_px = field * (ratio // 2)
    hsync_new, ccf_new, outs, rolled4 = _dem._line_scan(
        cfg, inp2d, _b(hsync, B, dev), ccf.to(torch.int32), vsync_new,
        _b(mon.hue, B, dev), hue_sn, hue_cs, saturation, outh, 0, field_px)
    xpos_l, beg_l, end_l, active_l, wvI_l, wvQ_l = outs
    # line l reads field rows l + 3 and l + 4 of rolled4 (ynudge=+3)
    pairs = torch.cat([rolled4[:, 3:3 + L], rolled4[:, 4:4 + L]], dim=2)

    dx_l, scan_l = bloom_lines(cfg, pairs, xpos_l, noise, outw)
    lidx_l = scan_l >> 12
    shifts = xpos_l + lidx_l              # the EQ starts at scanL >> 12
    # the carrier phase at that start: tables rotated by lidx mod CC
    rot = (torch.arange(CC, device=dev) + (lidx_l % CC)[..., None]) % CC
    rgb = kernels.decode_rows_bloom_plain(
        pairs, shifts, torch.gather(wvI_l, 2, rot),
        torch.gather(wvQ_l, 2, rot), bright[:, None].expand(B, L),
        _b(mon.contrast, B, dev)[:, None].expand(B, L), coefs=coefs,
        av_len=AV, outw=outw, bloom_dx=dx_l, bloom_lidx=lidx_l,
        eq_float=eq_float)
    out_new = _place_rows(rgb, out_prev, beg_l, end_l, active_l, mon.blend,
                          mon.scanlines, outh, field_px=field_px,
                          bloom_dx=dx_l, bloom_scan=scan_l, av_len=AV)
    return out_new, dict(hsync=hsync_new, vsync=vsync_new, ccf=ccf_new,
                         rn=rn_new, randstate=randstate)


def step(cfg: SystemConfig, state: CRTState, img: torch.Tensor, *, field,
         frame, noise=0, mon: MonitorParams, do_bloom: bool = True,
         eq_float: bool = False) -> CRTState:
    """modulate + demodulate of the bloom build, one frame a slot, on NTSC's
    encoder (crt_ntsc.c).  field and frame are ints or int32 (B,) tensors.
    do_bloom: the build, which this reference computes only with bloom on.
    eq_float: the benchmark's control."""
    if not do_bloom:
        raise ValueError("the bloom reference computes the bloom build only")
    if cfg.vhs_noise:
        raise ValueError(f"{cfg.name}: the bloom reference takes NTSC's "
                         "encoder and noise")
    analog, ccf = _mod.modulate_rgb(
        cfg, state.analog, img, field=field, frame=frame, hue=0,
        black_point=mon.black_point, white_point=mon.white_point,
        do_bloom=True)
    state = state._replace(analog=analog, ccf=ccf)
    out, new = demodulate_core(
        cfg, state.analog, state.out, state.hsync, state.vsync, state.ccf,
        state.rn, noise, mon, randstate=state.randstate, eq_float=eq_float)
    return state._replace(out=out, **new)
