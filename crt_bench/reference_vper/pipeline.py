"""Frozen: the port's frame step (``pipeline.step`` of
``ntsc_crt_tpu_torch/models``) on SNES, TEMPLATE and PV1K, on the plain
versions, as it stood when the PV1K cell was defined: the vper encoder
(``reference_vper.modulate``), then the frozen reference's decoder
(``crt_bench/reference/demodulate.py``), whose 5-sample branch
(crt_core.c:480-509) PV1K drives."""

from __future__ import annotations

import torch

from crt_bench.reference import demodulate as _dem
from crt_bench.reference.demodulate import MonitorParams
from crt_bench.reference.pipeline import CRTState
from crt_bench.reference.systems import SystemConfig
from crt_bench.reference_vper import modulate as _mod


def step(cfg: SystemConfig, state: CRTState, img: torch.Tensor, *, field,
         frame, dot_crawl_offset=0, noise=0, mon: MonitorParams,
         eq_float: bool = False) -> CRTState:
    """modulate + demodulate, one frame a slot.  field, frame and
    dot_crawl_offset are ints or int32 (B,) tensors.  eq_float: the
    benchmark's control (demodulate_core)."""
    analog, ccf = _mod.modulate_vper(
        cfg, state.analog, img, field=field, frame=frame,
        dot_crawl_offset=dot_crawl_offset, black_point=mon.black_point,
        white_point=mon.white_point)
    state = state._replace(analog=analog, ccf=ccf)
    out, new = _dem.demodulate_core(
        cfg, state.analog, state.out, state.hsync, state.vsync, state.ccf,
        state.rn, noise, mon, randstate=state.randstate, eq_float=eq_float)
    return state._replace(out=out, **new)
