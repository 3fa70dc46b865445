"""Closed loop of one video stream converted in order: chunks of ``chunk``
frames go from host memory to the card, through ``video.video_exact``
with the state carried over from the chunk before, and back to host
memory; the next chunk is sent when the last is back.  No file I/O.

Traffic parameters: ``chunk``; ``pool`` seeded frames made in host memory
at set-up, used in turn (a multiple of ``chunk``); ``warmup_chunks``;
``trace_steps`` chunks traced after the window; ``issue_samples`` chunks
whose frames are timed from an idle device after those; ``check``:
``chunks`` window chunks drawn from the first ``within``.  The first
set-up chunk is checked from the initial state, which the reference
builds itself; a window chunk from the state the program carried into
it, every frame of the chunk and the state after it.
"""

from __future__ import annotations

import time

import torch

from crt_bench import stats, trace
from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor


def setup(ctx) -> None:
    t, c, sut = ctx.traffic, ctx.conf, ctx.sut
    if t["pool"] % t["chunk"]:
        raise ValueError("the pool must hold whole chunks")
    cfg = sut.system(c["system"])
    g = torch.Generator()
    g.manual_seed(ctx.seed)
    inp = c["input"]
    pool = torch.randint(0, 256, (t["pool"], inp["height"], inp["width"], 3),
                         generator=g, dtype=torch.uint8)
    ctx.state.update(
        cfg=cfg, pool=pool, c=0, mon=sut.monitor(**c["monitor"]),
        state=sut.crt_init(cfg, c["output"]["width"], c["output"]["height"],
                           ctx.device))
    for i in range(t["warmup_chunks"]):
        _chunk(ctx, capture=i == 0)


def _chunk(ctx, capture: bool) -> None:
    S, T = ctx.state, ctx.traffic["chunk"]
    c = S["c"]
    lo = (c * T) % len(S["pool"])
    host_in = S["pool"][lo:lo + T]
    before = (tuple(x.clone() for x in S["state"])
              if capture and c > 0 else None)
    frames = host_in.to(ctx.device)
    state, outs = ctx.sut.video_exact(S["cfg"], S["state"], frames,
                                      noise=ctx.conf["noise"], mon=S["mon"],
                                      **ctx.conf["step"])
    host_out = outs.cpu()
    if capture:
        ctx.captures.append(dict(n=c * T, before=before, frames=host_in,
                                 host=host_out,
                                 after=tuple(x.clone() for x in state)))
    S["state"], S["c"] = state, c + 1


def window(ctx, seconds: float) -> dict:
    """Chunks until `seconds` have passed and every checked chunk has run;
    the rate counts every frame back in host memory over the window."""
    chk, T = ctx.traffic["check"], ctx.traffic["chunk"]
    picks = set(ctx.rng.choice(chk["within"], chk["chunks"], replace=False)
                .tolist())
    trace.sync(ctx.device)
    t0 = time.perf_counter()
    marks = []
    while (time.perf_counter() - t0 < seconds
           or len(marks) < chk["within"]):
        i = len(marks)
        marks.append(time.perf_counter())
        _chunk(ctx, capture=i in picks)
    t1 = time.perf_counter()
    n = len(marks) * T
    return dict(attempted=n, spans=list(zip(marks, marks[1:] + [t1])),
                per_step=T,
                e2e=dict(video_frames_per_s=stats.rate(n, t1 - t0)))


def more(ctx, n: int) -> list:
    """n more chunks as the window takes them; their start times."""
    marks = []
    for _ in range(n):
        marks.append(time.perf_counter())
        _chunk(ctx, capture=False)
    return marks


def release(ctx) -> None:
    for cap in ctx.captures:
        for k in ("before", "after"):
            if cap[k] is not None:
                cap[k] = tuple(x.cpu() for x in cap[k])
    ctx.state.clear()


def replay(ctx) -> list:
    """Every checked chunk at once, one reference batch row a chunk,
    stepped frame by frame with the converter's parities."""
    c, T = ctx.conf, ctx.traffic["chunk"]
    rcfg = ref_systems.SYSTEMS[c["system"]]
    outw, outh = c["output"]["width"], c["output"]["height"]
    caps = ctx.captures
    state = ref.CRTState(*(torch.cat(x) for x in zip(*(
        ref.init_slots(rcfg, [0], outw, outh) if cap["before"] is None
        else tuple(x[None] for x in cap["before"]) for cap in caps))))
    mon = RefMonitor(**c["monitor"])
    outs = []
    for i in range(T):
        fr = [ref.converter_parity(cap["n"] + i, rcfg.progressive)
              for cap in caps]
        state = ref.step(
            rcfg, state, torch.stack([cap["frames"][i] for cap in caps]),
            field=torch.tensor([f for f, _ in fr], dtype=torch.int32),
            frame=torch.tensor([f for _, f in fr], dtype=torch.int32),
            dot_crawl_offset=torch.tensor(
                [(cap["n"] + i) % max(rcfg.cc_vper, 1) for cap in caps],
                dtype=torch.int32),
            noise=c["noise"], mon=mon, **c["step"])
        outs.append(state.out)
    prog = [torch.stack(x) for x in zip(*(cap["after"] for cap in caps))]
    return ([(name, p, r) for name, p, r in zip(ref.CRTState._fields, prog,
                                                 state)]
            + [("host_frames", torch.stack([cap["host"] for cap in caps]),
                torch.stack(outs, dim=1))])
