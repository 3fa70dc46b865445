"""CRT state and the modulate -> demodulate frame step.

Counterpart of ``ntsc_crt_tpu/models/pipeline.py``.  The reference's whole
runtime state is `struct CRT` (crt_core.h:74-92); here it is a NamedTuple of
tensors threaded through plain functions that return a new state.  The
compute cores are batch-first: a single-frame state (analog (VRES, HRES)) is
lifted to a batch of one and back.

Every preset runs, dispatched to its encoder family like the reference's
CRT_SYSTEM compile switch (crt_core.h:38-59), with the reference's build
variants as keywords (eq_mode, do_bloom, do_vsync, do_hsync; NES:
draw_border, border_color, optimized).  State lives on the CUDA card unless
the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ntsc_crt_tpu_torch.models import demodulate as _dem
from ntsc_crt_tpu_torch.models import modulate as _mod
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import SystemConfig
from ntsc_crt_tpu_torch.utils import profiling


class CRTState(NamedTuple):
    """Persistent cross-frame decoder/encoder state (crt_core.h:74-92)."""
    analog: torch.Tensor      # int8 [B,] VRES, HRES — modulated signal
    out: torch.Tensor         # uint8 [B,] outh, outw, 3 — canonical RGB
    ccf: torch.Tensor         # int32 [B,] cc_vper, cc_samples — carrier EMA
    hsync: torch.Tensor       # int32 [B]
    vsync: torch.Tensor       # int32 [B]
    rn: torch.Tensor          # int32 [B] — noise LCG state
    randstate: torch.Tensor   # int32 [B] — crt_rand state (VHS paths)


def _map(state: CRTState, fn) -> CRTState:
    return CRTState(*(fn(x) for x in state))


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, and raises
    where there is none — the port never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def crt_init(cfg: SystemConfig, outw: int, outh: int, rand_seed: int = 1,
             batch: Optional[int] = None, device=None) -> CRTState:
    """Fresh zeroed state; rn seeded to 194 like crt_init (crt_core.c:269).
    batch=None gives a single-frame state (no leading batch dim).
    device=None puts it on the CUDA card."""
    device = resolve_device(device)
    lead = () if batch is None else (batch,)

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    return CRTState(
        analog=full((cfg.vres, cfg.hres), 0, torch.int8),
        out=full((outh, outw, 3), 0, torch.uint8),
        ccf=full((cfg.cc_vper, cfg.cc_samples), 0, torch.int32),
        hsync=full((), 0, torch.int32),
        vsync=full((), 0, torch.int32),
        rn=full((), 194, torch.int32),
        randstate=full((), rand_seed, torch.int32),
    )


def crt_resize(cfg: SystemConfig, state: CRTState, outw: int,
               outh: int) -> CRTState:
    """Change the output geometry, keeping all signal state
    (crt_resize, crt_core.c:241-248)."""
    lead = tuple(state.analog.shape[:-2])
    return state._replace(out=torch.zeros(
        lead + (outh, outw, 3), dtype=torch.uint8, device=state.out.device))


def init_batch(cfg: SystemConfig, batch: int, outw: int, outh: int,
               device=None) -> CRTState:
    """A batch of per-slot states with decorrelated noise streams
    (parallel/mesh.py:53-65): rn = 194 + slot, randstate = 1 + slot.
    device=None puts them on the CUDA card."""
    device = resolve_device(device)
    states = crt_init(cfg, outw, outh, batch=batch, device=device)
    return states._replace(
        rn=torch.arange(194, 194 + batch, dtype=torch.int32, device=device),
        randstate=torch.arange(1, 1 + batch, dtype=torch.int32,
                               device=device))


def _lift(state: CRTState, img):
    """(state, img, batched?) with a guaranteed leading batch dim."""
    if state.analog.ndim == 3:
        return state, img, True
    return (_map(state, lambda x: x[None]),
            None if img is None else img[None], False)


def _unlift(state: CRTState, batched: bool) -> CRTState:
    return state if batched else _map(state, lambda x: x[0])


def modulate(cfg: SystemConfig, state: CRTState, img: torch.Tensor, *,
             field=0, frame=0, hue=0, as_color=1, xoffset: int = 0,
             yoffset: int = 0, black_point=0, white_point=100,
             raw: bool = False, dot_crawl_offset=0, do_aberration=0,
             do_bloom: bool = False, border_color=0,
             draw_border: bool = False, optimized: bool = True) -> CRTState:
    """Encode one frame (or a batch) into the analog buffer, through the
    preset's encoder family (JAX pipeline.py:92-127).  img: uint8
    ([B,] h, w, 3) on the state's device, or uint16 ([B,] h, w) PPU pixels
    for NES.  Each keyword reaches the encoders that read it, as in the
    reference: do_aberration the VHS presets; dot_crawl_offset SNES,
    TEMPLATE, PV1K, NES and NESRGB; border_color, draw_border (NES_BORDER)
    and optimized (NES_OPTIMIZED) NES; do_bloom (CRT_DO_BLOOM, which shrinks
    the drawn picture), raw, field, frame and as_color the RGB encoders but
    NESRGB."""
    with profiling.span("modulate"):
        state, img, batched = _lift(state, img)
        kw = dict(hue=hue, xoffset=xoffset, yoffset=yoffset,
                  black_point=black_point, white_point=white_point)
        rgb_kw = dict(kw, field=field, frame=frame, as_color=as_color,
                      raw=raw, do_bloom=do_bloom)
        if cfg.name.startswith("NTSCVHS"):
            analog, ccf, randstate = _mod.modulate_vhs(
                cfg, state.analog, img, state.randstate,
                do_aberration=do_aberration, **rgb_kw)
            # hsync resets each frame so only the bottom warps
            # (crt_ntscvhs.c:258)
            state = state._replace(randstate=randstate,
                                   hsync=torch.zeros_like(state.hsync))
        elif cfg.name == "NES":
            analog, ccf = _mod.modulate_nes(
                cfg, state.analog, img, dot_crawl_offset=dot_crawl_offset,
                border_color=border_color, draw_border=draw_border,
                optimized=optimized, **kw)
        elif cfg.name == "NESRGB":
            analog, ccf = _mod.modulate_nesrgb(
                cfg, state.analog, img, dot_crawl_offset=dot_crawl_offset,
                **kw)
        elif cfg.cc_vper > 1:                             # SNES/TEMPLATE/PV1K
            analog, ccf = _mod.modulate_vper(
                cfg, state.analog, img, dot_crawl_offset=dot_crawl_offset,
                **rgb_kw)
        else:                                             # NTSC, NTSC_RAINBOW
            analog, ccf = _mod.modulate_rgb(cfg, state.analog, img,
                                            **rgb_kw)
        return _unlift(state._replace(analog=analog, ccf=ccf), batched)


def demodulate(cfg: SystemConfig, state: CRTState, noise=0,
               mon: Optional[MonitorParams] = None, *,
               v_fac: int = 0, eq_mode: str = "threeband",
               do_bloom: bool = False, do_vsync: bool = True,
               do_hsync: bool = True) -> CRTState:
    """Decode the analog buffer into the output image (crt_demodulate).
    eq_mode: "threeband" or "conv7"/"conv6"/"conv5"/"conv4" for the
    reference's USE_CONVOLUTION builds; do_bloom the CRT_DO_BLOOM build;
    do_vsync/do_hsync=False the CRT_DO_VSYNC/CRT_DO_HSYNC=0 builds (fixed
    sync positions, crt_core.h:71-72)."""
    mon = mon or MonitorParams()
    with profiling.span("demodulate"):
        state, _, batched = _lift(state, None)
        out, new = _dem.demodulate_core(
            cfg, state.analog, state.out, state.hsync, state.vsync,
            state.ccf, state.rn, noise, mon, randstate=state.randstate,
            v_fac=v_fac, eq_mode=eq_mode, do_bloom=do_bloom,
            do_vsync=do_vsync, do_hsync=do_hsync)
        state = state._replace(out=out, **new)
        return _unlift(state, batched)


def step(cfg: SystemConfig, state: CRTState, img: torch.Tensor, *,
         field=0, frame=0, hue=0, noise=0,
         mon: Optional[MonitorParams] = None, as_color=1, raw: bool = False,
         dot_crawl_offset=0, do_aberration=0, v_fac: int = 0,
         do_bloom: bool = False, eq_mode: str = "threeband",
         do_vsync: bool = True, do_hsync: bool = True, border_color=0,
         draw_border: bool = False, optimized: bool = True) -> CRTState:
    """modulate + demodulate: one full frame through the composite path.
    black_point/white_point are read by both the encoder and the decoder in
    the reference (crt_ntsc.c:311,318; crt_core.c:305), so they come from
    `mon`.  The reference's compile-time build variants are keywords:
    do_bloom (CRT_DO_BLOOM, crt_core.h:70), eq_mode (USE_CONVOLUTION,
    crt_core.c:85-147), do_vsync/do_hsync (crt_core.h:71-72),
    draw_border/border_color (NES_BORDER, crt_nes.c:69), optimized
    (NES_OPTIMIZED, crt_nes.c:63)."""
    mon = mon or MonitorParams()
    with profiling.span("step"):
        state = modulate(cfg, state, img, field=field, frame=frame, hue=hue,
                         as_color=as_color, black_point=mon.black_point,
                         white_point=mon.white_point, raw=raw,
                         dot_crawl_offset=dot_crawl_offset,
                         do_aberration=do_aberration, do_bloom=do_bloom,
                         border_color=border_color, draw_border=draw_border,
                         optimized=optimized)
        return demodulate(cfg, state, noise=noise, mon=mon, v_fac=v_fac,
                          eq_mode=eq_mode, do_bloom=do_bloom,
                          do_vsync=do_vsync, do_hsync=do_hsync)


def step_batch(cfg: SystemConfig, states: CRTState, imgs: torch.Tensor,
               fields, frames, dcos, *, noise=0,
               mon: Optional[MonitorParams] = None,
               do_aberration=0, **step_kw) -> CRTState:
    """The full step over a frame batch — make_batched_step
    (parallel/mesh.py:68-102) without sharding or donation; dcos are the
    dot-crawl offsets; step_kw (do_bloom, eq_mode, do_vsync, do_hsync,
    v_fac, the NES keywords) forward to step."""
    return step(cfg, states, imgs, field=fields, frame=frames, noise=noise,
                mon=mon, dot_crawl_offset=dcos, do_aberration=do_aberration,
                **step_kw)
