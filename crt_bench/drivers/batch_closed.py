"""Closed loop over a batch of independent clips: each
``pipeline.step_batch`` call advances every slot one frame, the next call
issued as soon as the last returns; outputs stay on the card.

Traffic parameters: ``batch`` slots; ``pool`` input batches made on the
card from the seed and used in turn; ``warmup_steps``; ``trace_steps``
traced after the window; ``issue_samples`` steps timed from an idle device
after those; ``check``: ``slots`` checked (one from each equal part of
the batch, even and odd slots in turn) at ``steps`` window steps drawn
from the first ``within``, replayed by the reference on the run's device.
Each slot's field/frame parity follows the video converter's sequence
from an offset of its own, so every step holds both parities.  The first
set-up step is checked from the initial state, which the reference builds
itself; a window step from the state the program held before it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crt_bench import stats, trace
from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor


def check_slots(rng: np.random.Generator, batch: int, k: int) -> list[int]:
    """One slot from each of k equal parts of the batch, of even index in
    even parts and odd in odd ones, so that any half of the batch, by
    halves or by parity, holds a checked slot."""
    out = []
    for i in range(k):
        lo, hi = i * batch // k, (i + 1) * batch // k
        cand = [s for s in range(lo, hi) if s % 2 == i % 2] or [lo]
        out.append(int(rng.choice(cand)))
    return out


def setup(ctx) -> None:
    t, c, sut, dev = ctx.traffic, ctx.conf, ctx.sut, ctx.device
    B = t["batch"]
    cfg = sut.system(c["system"])
    g = torch.Generator(device=dev)
    g.manual_seed(ctx.seed)
    h, w = c["input"]["height"], c["input"]["width"]
    pool = [torch.randint(0, 256, (B, h, w, 3), generator=g, device=dev,
                          dtype=torch.uint8) for _ in range(t["pool"])]
    offsets = ctx.rng.integers(0, 4, B)
    # (4, 2, B): field and frame of each slot at steps 0, 1, 2, 3 mod 4
    par = np.array([[ref.converter_parity((p + o) % 4) for o in offsets]
                    for p in range(4)], np.int32).transpose(0, 2, 1)
    slots = check_slots(ctx.rng, B, t["check"]["slots"])
    ctx.state.update(
        cfg=cfg, pool=pool, offsets=offsets, slots=slots,
        par=torch.as_tensor(par, device=dev),
        idx=torch.as_tensor(slots, device=dev),
        dcos=torch.zeros(B, dtype=torch.int32, device=dev),
        states=sut.init_batch(cfg, B, c["output"]["width"],
                              c["output"]["height"], dev),
        mon=sut.monitor(**c["monitor"]),
        kw=dict(noise=c["noise"], **c["step"]), n=0)
    for i in range(t["warmup_steps"]):
        _step(ctx, capture=i == 0)


def _step(ctx, capture: bool) -> None:
    S = ctx.state
    n, st, idx = S["n"], S["states"], S["idx"]
    before = (tuple(x.index_select(0, idx) for x in st)
              if capture and n > 0 else None)
    p = S["par"][n % 4]
    st = ctx.sut.step_batch(S["cfg"], st, S["pool"][n % len(S["pool"])],
                            p[0], p[1], S["dcos"], mon=S["mon"], **S["kw"])
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


def release(ctx) -> None:
    """Keep on the host what the check needs; drop the program's state."""
    S = ctx.state
    idx = S["idx"]
    for cap in ctx.captures:
        cap["imgs"] = S["pool"][cap["n"] % len(S["pool"])].index_select(
            0, idx).cpu()
        for k in ("before", "after"):
            if cap[k] is not None:
                cap[k] = tuple(x.cpu() for x in cap[k])
    keep = {k: S[k] for k in ("slots", "offsets")}
    S.clear()
    S.update(keep)


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
    got = ref.step(rcfg, state, torch.cat(imgs).to(dev),
                   field=torch.tensor(fields, dtype=torch.int32, device=dev),
                   frame=torch.tensor(frames, dtype=torch.int32, device=dev),
                   noise=c["noise"], mon=RefMonitor(**c["monitor"]),
                   **c["step"])
    got = [x.cpu() for x in got]
    prog = [torch.cat(x) for x in zip(*afters)]
    return [(name, p, r) for name, p, r in zip(ref.CRTState._fields, prog,
                                                got)]
