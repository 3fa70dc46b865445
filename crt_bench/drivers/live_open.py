"""Open loop of one live stream: a frame is due every 1 / ``rate_hz`` s,
each handed to ``LiveSession.tick``, which returns the whole output frame
on the host.  A frame is sent at its due time or, when the one before
ended late, at once; its latency runs from its due time to its return.

Traffic parameters: ``rate_hz``; ``pool`` seeded frames made on the host
at set-up, used in turn (each tick gets a new array object);
``warmup_ticks``; ``trace_steps`` ticks traced after the window, one
after another; ``issue_samples`` ticks timed from an idle device after
those; ``check``:
``ticks`` window frames drawn from the whole window.  The configuration's
``live`` knobs go to the session.  The first set-up tick is checked from
the initial state, which the reference builds itself; a window tick from
the state the session held before it, the phosphor fade included.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from crt_bench import stats, trace
from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor


def _pool(ctx) -> np.ndarray:
    inp = ctx.conf["input"]
    shape = (ctx.traffic["pool"], inp["height"], inp["width"])
    if inp["kind"] == "ppu":
        return ctx.rng.integers(0, 1 << inp["bits"], shape).astype(np.uint16)
    return ctx.rng.integers(0, 256, shape + (3,)).astype(np.uint8)


def setup(ctx) -> None:
    c, sut = ctx.conf, ctx.sut
    cfg = sut.system(c["system"])
    ctx.state.update(
        pool=_pool(ctx), n=0,
        session=sut.live_session(cfg, c["output"]["width"],
                                 c["output"]["height"], ctx.device,
                                 **c["live"]))
    for i in range(ctx.traffic["warmup_ticks"]):
        _tick(ctx, capture=i == 0)


def _tick(ctx, capture: bool) -> None:
    S = ctx.state
    n, sess = S["n"], S["session"]
    before = (tuple(x.clone() for x in sess.state)
              if capture and n > 0 else None)
    frame = sess.tick(S["pool"][n % len(S["pool"])])
    if capture:
        ctx.captures.append(dict(n=n, before=before, host=frame,
                                 after=tuple(x.clone() for x in sess.state)))
    S["n"] = n + 1


def window(ctx, seconds: float) -> dict:
    t = ctx.traffic
    n = max(1, round(t["rate_hz"] * seconds))
    picks = set(ctx.rng.choice(n, min(t["check"]["ticks"], n),
                               replace=False).tolist())

    def serve(i: int) -> None:
        _tick(ctx, capture=i in picks)

    trace.sync(ctx.device)
    due, done = stats.open_loop(n, 1.0 / t["rate_hz"], serve,
                                time.perf_counter, time.sleep,
                                time.perf_counter())
    lat_ms = [(d - u) * 1e3 for u, d in zip(due, done)]
    print("live: frame ms p50 %.3f p90 %.3f p95 %.3f p99 %.3f max %.3f; "
          "%d of %d frames sent late" % (
              *(stats.percentile(lat_ms, q) for q in (50, 90, 95, 99, 100)),
              sum(d > u2 for d, u2 in zip(done, due[1:])), n),
          file=sys.stderr)
    return dict(attempted=n, spans=list(zip(due, done)), per_step=1,
                e2e=dict(live_frame_ms_p95=stats.percentile(lat_ms, 95)))


def more(ctx, n: int) -> list:
    """n more ticks, one after another; their start times."""
    marks = []
    for _ in range(n):
        marks.append(time.perf_counter())
        _tick(ctx, capture=False)
    return marks


def release(ctx) -> None:
    for cap in ctx.captures:
        for k in ("before", "after"):
            if cap[k] is not None:
                cap[k] = tuple(x.cpu() for x in cap[k])
    pool = ctx.state["pool"]
    ctx.state.clear()
    ctx.state["pool"] = pool


def replay(ctx) -> list:
    """Every checked tick at once, one reference batch row a tick."""
    c = ctx.conf
    follows = dict(fadephos=True, optimized=True, draw_border=False)
    if any(c["live"].get(k, v) != v for k, v in follows.items()) or \
            set(c["live"]) - set(follows) - {"noise"}:
        raise ValueError(f"the reference's live tick follows {follows} and "
                         f"a noise knob, not {c['live']}")
    rcfg = ref_systems.SYSTEMS[c["system"]]
    outw, outh = c["output"]["width"], c["output"]["height"]
    pool = ctx.state["pool"]
    befores, knobs, imgs = [], [], []
    for cap in ctx.captures:
        b = cap["before"]
        befores.append(ref.init_slots(rcfg, [0], outw, outh) if b is None
                       else tuple(x[None] for x in b))
        knobs.append(ref.live_knobs(rcfg, cap["n"]))
        imgs.append(torch.from_numpy(pool[cap["n"] % len(pool)]))
    state = ref.CRTState(*(torch.cat(x) for x in zip(*befores)))
    state = state._replace(out=ref.fade_phosphors(state.out))
    field, frame, dco = (torch.tensor(k, dtype=torch.int32)
                         for k in zip(*knobs))
    got = ref.step(rcfg, state, torch.stack(imgs), field=field, frame=frame,
                   dot_crawl_offset=dco, noise=c["live"].get("noise", 0),
                   mon=RefMonitor())
    prog = [torch.stack(x) for x in zip(*(cap["after"]
                                          for cap in ctx.captures))]
    host = torch.stack([torch.from_numpy(np.asarray(cap["host"]))
                        for cap in ctx.captures])
    return ([(name, p, r) for name, p, r in zip(ref.CRTState._fields, prog,
                                                 got)]
            + [("host_frame", host, got.out)])
