"""CRT state and the modulate -> demodulate frame step.

Counterpart of ``ntsc_crt_tpu/models/pipeline.py``.  The reference's whole
runtime state is `struct CRT` (crt_core.h:74-92); here it is a NamedTuple of
tensors threaded through plain functions that return a new state.  The
compute cores are batch-first: a single-frame state (analog (VRES, HRES)) is
lifted to a batch of one and back.

Only the NTSC encoder family with the default three-band decode is ported;
every other preset or build variant raises NotImplementedError naming its
ROADMAP item.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ntsc_crt_tpu.models.systems import SystemConfig
from ntsc_crt_tpu_torch.models import demodulate as _dem
from ntsc_crt_tpu_torch.models import modulate as _mod
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams


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


def crt_init(cfg: SystemConfig, outw: int, outh: int, rand_seed: int = 1,
             batch: Optional[int] = None, device="cpu") -> CRTState:
    """Fresh zeroed state; rn seeded to 194 like crt_init (crt_core.c:269).
    batch=None gives a single-frame state (no leading batch dim)."""
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
               device="cpu") -> CRTState:
    """A batch of per-slot states with decorrelated noise streams
    (parallel/mesh.py:53-65): rn = 194 + slot, randstate = 1 + slot."""
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
             raw: bool = False) -> CRTState:
    """Encode one frame (or a batch) into the analog buffer.  img: uint8
    ([B,] h, w, 3) on the state's device."""
    if cfg.name != "NTSC":
        raise NotImplementedError(
            f"{cfg.name}: only the NTSC encoder is ported "
            "(ROADMAP Queue 1, M7 and M8)")
    state, img, batched = _lift(state, img)
    analog, ccf = _mod.modulate_rgb(
        cfg, state.analog, img, field=field, frame=frame, hue=hue,
        as_color=as_color, xoffset=xoffset, yoffset=yoffset,
        black_point=black_point, white_point=white_point, raw=raw)
    return _unlift(state._replace(analog=analog, ccf=ccf), batched)


def demodulate(cfg: SystemConfig, state: CRTState, noise=0,
               mon: Optional[MonitorParams] = None, *,
               v_fac: int = 0) -> CRTState:
    """Decode the analog buffer into the output image (crt_demodulate)."""
    mon = mon or MonitorParams()
    state, _, batched = _lift(state, None)
    out, new = _dem.demodulate_core(
        cfg, state.analog, state.out, state.hsync, state.vsync, state.ccf,
        state.rn, noise, mon, v_fac=v_fac)
    state = state._replace(out=out, **new)
    return _unlift(state, batched)


def step(cfg: SystemConfig, state: CRTState, img: torch.Tensor, *,
         field=0, frame=0, hue=0, noise=0,
         mon: Optional[MonitorParams] = None, as_color=1, raw: bool = False,
         v_fac: int = 0) -> CRTState:
    """modulate + demodulate: one full frame through the composite path.
    black_point/white_point are read by both the encoder and the decoder in
    the reference (crt_ntsc.c:311,318; crt_core.c:305), so they come from
    `mon`."""
    mon = mon or MonitorParams()
    state = modulate(cfg, state, img, field=field, frame=frame, hue=hue,
                     as_color=as_color, black_point=mon.black_point,
                     white_point=mon.white_point, raw=raw)
    return demodulate(cfg, state, noise=noise, mon=mon, v_fac=v_fac)


def step_batch(cfg: SystemConfig, states: CRTState, imgs: torch.Tensor,
               fields, frames, dcos, *, noise=0,
               mon: Optional[MonitorParams] = None) -> CRTState:
    """The full step over a frame batch — make_batched_step
    (parallel/mesh.py:68-102) without sharding or donation.  dcos (the
    dot-crawl offsets) only reach NES-family encoders, which are not
    ported."""
    del dcos
    return step(cfg, states, imgs, field=fields, frame=frames, noise=noise,
                mon=mon)
