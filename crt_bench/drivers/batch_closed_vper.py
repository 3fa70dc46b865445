"""``batch_closed`` on the encoders with a carrier table a vertical phase
class (SNES, TEMPLATE, PV1K): the same closed loop over a batch of
independent clips, ``pipeline.step_batch`` with every slot's dot-crawl
offset 0, the same traffic parameters, set-up, window, traced steps and
captures; the checked steps are replayed by the vper encoder's reference
(``crt_bench/reference_vper``), for which the frozen reference of
``batch_closed`` has no encoder.
"""

from __future__ import annotations

import torch

from crt_bench.drivers.batch_closed import (  # noqa: F401
    more, release, setup, window)
from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor
from crt_bench.reference_vper import pipeline as ref_vper


def replay(ctx) -> list:
    """Every checked step at once, one reference batch row a slot's step,
    on the run's device once the program's state is freed."""
    c, S = ctx.conf, ctx.state
    rcfg = ref_systems.SYSTEMS[c["system"]]
    outw, outh = c["output"]["width"], c["output"]["height"]
    befores, imgs, fields, frames, afters = [], [], [], [], []
    for cap in ctx.captures:
        befores.append(cap["before"] if cap["before"] is not None else
                       ref.init_slots(rcfg, S["slots"], outw, outh))
        imgs.append(cap["imgs"])
        fr = [ref.converter_parity((cap["n"] + S["offsets"][s]) % 4)
              for s in S["slots"]]
        fields += [f for f, _ in fr]
        frames += [f for _, f in fr]
        afters.append(cap["after"])
    dev = ctx.device
    state = ref.CRTState(*(torch.cat(x).to(dev) for x in zip(*befores)))
    got = ref_vper.step(
        rcfg, state, torch.cat(imgs).to(dev),
        field=torch.tensor(fields, dtype=torch.int32, device=dev),
        frame=torch.tensor(frames, dtype=torch.int32, device=dev),
        dot_crawl_offset=0, noise=c["noise"],
        mon=RefMonitor(**c["monitor"]), **c["step"])
    got = [x.cpu() for x in got]
    prog = [torch.cat(x) for x in zip(*afters)]
    return [(name, p, r) for name, p, r in zip(ref.CRTState._fields, prog,
                                                got)]
