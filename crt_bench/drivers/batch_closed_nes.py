"""``batch_closed`` on the NES build: the same closed loop over a batch of
independent streams, ``pipeline.step_batch`` advancing every slot one
frame a call, with the same traffic parameters, window, traced steps and
captures.  Two things differ:

* the pool holds (B, h, w) uint16 NES PPU frames made on the card from the
  seed, 9 bits a pixel;
* each slot follows the live loop's knob sequence
  (``crt_bench.reference.pipeline.live_knobs``: field, frame and dot-crawl
  offset, a period of 6 on NES) from an offset of its own in 0..5, so that
  every step holds both frame parities and all three dot-crawl phases,
  handed to ``step_batch`` as (B,) tensors.

The checked steps are replayed by the reference's NES step with each
slot's own knobs.  ``check_slots`` and ``release`` are ``batch_closed``'s;
its ``window`` and ``more`` step through its own step, whose parities
repeat every 4 steps, so this module's step and the two loops around it
are written here as they are there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crt_bench import stats, trace
from crt_bench.drivers.batch_closed import check_slots, release  # noqa: F401
from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor

PERIOD = 6      # the live loop's knobs on NES: frame period 2, dot crawl 3


def knobs(rcfg, n: int, offsets) -> np.ndarray:
    """(field, frame, dot_crawl_offset) of every slot at step n, int32 (3,
    B): slot s at frame n + offsets[s] of the live loop."""
    return np.array([ref.live_knobs(rcfg, n + int(o)) for o in offsets],
                    np.int32).T


def setup(ctx) -> None:
    t, c, sut, dev = ctx.traffic, ctx.conf, ctx.sut, ctx.device
    B = t["batch"]
    rcfg = ref_systems.SYSTEMS[c["system"]]
    g = torch.Generator(device=dev)
    g.manual_seed(ctx.seed)
    inp = c["input"]
    shape = (B, inp["height"], inp["width"])
    # int16 draws below 2**bits, read as uint16: the same bits
    pool = [torch.randint(0, 1 << inp["bits"], shape, generator=g,
                          device=dev, dtype=torch.int16).view(torch.uint16)
            for _ in range(t["pool"])]
    offsets = ctx.rng.integers(0, PERIOD, B)
    slots = check_slots(ctx.rng, B, t["check"]["slots"])
    ctx.state.update(
        cfg=sut.system(c["system"]), pool=pool, offsets=offsets, slots=slots,
        knobs=torch.as_tensor(np.stack([knobs(rcfg, p, offsets)
                                        for p in range(PERIOD)]),
                              device=dev),
        idx=torch.as_tensor(slots, device=dev),
        states=sut.init_batch(sut.system(c["system"]), B,
                              c["output"]["width"], c["output"]["height"],
                              dev),
        mon=sut.monitor(**c["monitor"]),
        kw=dict(noise=c["noise"], **c["step"]), n=0)
    for i in range(t["warmup_steps"]):
        _step(ctx, capture=i == 0)


def _step(ctx, capture: bool) -> None:
    S = ctx.state
    n, st, idx = S["n"], S["states"], S["idx"]
    before = (tuple(x.index_select(0, idx) for x in st)
              if capture and n > 0 else None)
    field, frame, dco = S["knobs"][n % PERIOD]
    st = ctx.sut.step_batch(S["cfg"], st, S["pool"][n % len(S["pool"])],
                            field, frame, dco, mon=S["mon"], **S["kw"])
    if capture:
        ctx.captures.append(dict(n=n, before=before, after=tuple(
            x.index_select(0, idx) for x in st)))
    S["states"], S["n"] = st, n + 1


def window(ctx, seconds: float) -> dict:
    """Steps until `seconds` have passed and every checked step has run;
    the rate counts every frame of the window over all of its time."""
    chk = ctx.traffic["check"]
    picks = set(ctx.rng.choice(chk["within"], chk["steps"], replace=False)
                .tolist())
    trace.sync(ctx.device)
    t0 = time.perf_counter()
    marks = []
    while (time.perf_counter() - t0 < seconds
           or len(marks) < chk["within"]):
        i = len(marks)
        marks.append(time.perf_counter())
        _step(ctx, capture=i in picks)
    trace.sync(ctx.device)
    t1 = time.perf_counter()
    frames = len(marks) * ctx.traffic["batch"]
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    return dict(attempted=frames, spans=list(zip(marks, marks[1:] + [t1])),
                per_step=1,
                e2e=dict(batch_frames_per_s=stats.rate(frames, t1 - t0),
                         batch_peak_mem_gib=peak / 2**30))


def more(ctx, n: int) -> list:
    """n more steps as the window takes them; their start times."""
    marks = []
    for _ in range(n):
        marks.append(time.perf_counter())
        _step(ctx, capture=False)
    return marks


def replay(ctx) -> list:
    """Every checked step at once, one reference batch row a slot's step,
    on the run's device once the program's state is freed."""
    c, S = ctx.conf, ctx.state
    rcfg = ref_systems.SYSTEMS[c["system"]]
    outw, outh = c["output"]["width"], c["output"]["height"]
    offsets = [S["offsets"][s] for s in S["slots"]]
    befores, imgs, knob, afters = [], [], [], []
    for cap in ctx.captures:
        befores.append(cap["before"] if cap["before"] is not None else
                       ref.init_slots(rcfg, S["slots"], outw, outh))
        imgs.append(cap["imgs"])
        knob.append(knobs(rcfg, cap["n"], offsets))
        afters.append(cap["after"])
    dev = ctx.device
    field, frame, dco = torch.as_tensor(np.concatenate(knob, axis=1),
                                        device=dev)
    state = ref.CRTState(*(torch.cat(x).to(dev) for x in zip(*befores)))
    got = ref.step(rcfg, state, torch.cat(imgs).to(dev), field=field,
                   frame=frame, dot_crawl_offset=dco, noise=c["noise"],
                   mon=RefMonitor(**c["monitor"]), **c["step"])
    got = [x.cpu() for x in got]
    prog = [torch.cat(x) for x in zip(*afters)]
    return [(name, p, r) for name, p, r in zip(ref.CRTState._fields, prog,
                                                got)]
