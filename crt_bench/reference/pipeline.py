"""Frozen: the port's CRT state and frame step, and the frame sequences of
the drivers the benchmark drives.

A copy of the plain path of ``ntsc_crt_tpu_torch/models/pipeline.py``
(step), ``models/video.py`` (the converter's parities, the phosphor fade)
and ``apps/live.py`` (the live loop's knobs).  The states the reference
starts from it builds itself: ``init_slots`` is crt_init with the batch's
per-slot noise seeds (rn = 194 + slot, randstate = 1 + slot).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crt_bench.reference import demodulate as _dem
from crt_bench.reference import modulate as _mod
from crt_bench.reference.demodulate import MonitorParams
from crt_bench.reference.systems import SystemConfig


class CRTState(NamedTuple):
    """Persistent cross-frame decoder/encoder state (crt_core.h:74-92),
    batch-first."""
    analog: torch.Tensor      # int8 (B, VRES, HRES) — modulated signal
    out: torch.Tensor         # uint8 (B, outh, outw, 3) — canonical RGB
    ccf: torch.Tensor         # int32 (B, cc_vper, cc_samples) — carrier EMA
    hsync: torch.Tensor       # int32 (B,)
    vsync: torch.Tensor       # int32 (B,)
    rn: torch.Tensor          # int32 (B,) — noise LCG state
    randstate: torch.Tensor   # int32 (B,) — crt_rand state (VHS paths)


def init_slots(cfg: SystemConfig, slots, outw: int, outh: int,
               device="cpu") -> CRTState:
    """Fresh zeroed states of the given batch slots (crt_init,
    crt_core.c:269, with the batch's decorrelated seeds)."""
    s = torch.as_tensor(slots, dtype=torch.int32, device=device)
    B = s.shape[0]

    def zeros(shape, dtype):
        return torch.zeros((B,) + shape, dtype=dtype, device=device)

    return CRTState(
        analog=zeros((cfg.vres, cfg.hres), torch.int8),
        out=zeros((outh, outw, 3), torch.uint8),
        ccf=zeros((cfg.cc_vper, cfg.cc_samples), torch.int32),
        hsync=zeros((), torch.int32), vsync=zeros((), torch.int32),
        rn=194 + s, randstate=1 + s)


def modulate(cfg: SystemConfig, state: CRTState, img: torch.Tensor, *,
             field, frame, dot_crawl_offset, mon: MonitorParams,
             do_aberration=0) -> CRTState:
    """The encoder of the preset's family: NTSC-VHS (crt_ntscvhs.c) or NES
    (crt_nes.c, the optimized build, no border)."""
    kw = dict(hue=0, black_point=mon.black_point,
              white_point=mon.white_point)
    if cfg.name.startswith("NTSCVHS"):
        analog, ccf, randstate = _mod.modulate_vhs(
            cfg, state.analog, img, state.randstate, field=field,
            frame=frame, do_aberration=do_aberration, **kw)
        # hsync resets each frame so only the bottom warps (crt_ntscvhs.c:258)
        return state._replace(analog=analog, ccf=ccf, randstate=randstate,
                              hsync=torch.zeros_like(state.hsync))
    if cfg.name == "NES":
        analog, ccf = _mod.modulate_nes(
            cfg, state.analog, img, dot_crawl_offset=dot_crawl_offset, **kw)
        return state._replace(analog=analog, ccf=ccf)
    if cfg.name in ("NTSC", "NTSC_RAINBOW"):
        analog, ccf = _mod.modulate_rgb(cfg, state.analog, img, field=field,
                                        frame=frame, **kw)
        return state._replace(analog=analog, ccf=ccf)
    raise ValueError(f"{cfg.name}: no encoder in the reference")


def step(cfg: SystemConfig, state: CRTState, img: torch.Tensor, *, field,
         frame, dot_crawl_offset=0, noise=0, mon: MonitorParams,
         do_aberration=0, eq_float: bool = False) -> CRTState:
    """modulate + demodulate, one frame a slot.  field, frame and
    dot_crawl_offset are ints or int32 (B,) tensors.  eq_float: the
    benchmark's control (demodulate_core)."""
    state = modulate(cfg, state, img, field=field, frame=frame,
                     dot_crawl_offset=dot_crawl_offset, mon=mon,
                     do_aberration=do_aberration)
    out, new = _dem.demodulate_core(
        cfg, state.analog, state.out, state.hsync, state.vsync, state.ccf,
        state.rn, noise, mon, randstate=state.randstate, eq_float=eq_float)
    return state._replace(out=out, **new)


def converter_parity(n: int, progressive: bool = False) -> tuple[int, int]:
    """(field, frame) of frame n of the video converter
    (extra/video_convert.c:261-267): field ^= 1 each frame, frame ^= 1
    after every even-indexed frame; a period of 4."""
    if progressive:
        return 0, 0
    return n & 1, ((n + 1) >> 1) & 1


def live_knobs(cfg: SystemConfig, n: int) -> tuple[int, int, int]:
    """(field, frame, dot_crawl_offset) of display frame n (0-based) of
    the live loop from its start (displaycb, crt_main.c:454-497): the dot
    crawl advances before each frame, frame flips before each frame drawn
    at field 0, field flips after each frame unless progressive."""
    vper = max(cfg.cc_vper, 1)
    dco = (n + 1) % vper if cfg.cc_vper > 1 else 0
    if cfg.progressive:
        return 0, (n + 1) & 1, dco
    # fields alternate 0, 1, 0, ...; frame flips at each field-0 frame
    return n & 1, ((n >> 1) + 1) & 1, dco


def fade_phosphors(out: torch.Tensor) -> torch.Tensor:
    """Persistence emulation over the output buffer (crt_main.c:437-452):
    per channel c -> (c>>1)+(c>>2)+(c>>3)+(c>>4)."""
    c = out.to(torch.int32)
    return ((c >> 1) + (c >> 2) + (c >> 3) + (c >> 4)).to(torch.uint8)
