"""The port's own stage spans in a traced run: the ``ntsc.`` ranges that
``ntsc_crt_tpu_torch.utils.profiling.span`` records inside the step, the
device operations launched inside each, and the idle time by the span in
flight.

A per-layer reader is handed the Trace, whose device operations have lost
the correlation ids that tie each to its launch.  The profiler's events
are still held by the Probe that recorded them, a local of the harness's
frame that calls the reader (``harness.run_cell``), so ``program`` finds
that Probe up the call stack, checks that its window is the trace's, and
ties each device operation to its launch as ``trace.read`` does for the
harness's spans.  A trace without such a Probe (one made by hand), or a
program without the spans (one older than them), gives nothing to read.
"""

from __future__ import annotations

import sys
from typing import Optional

from crt_bench import stats, trace
from crt_bench.trace import Trace

PROGRAM_PREFIX = "ntsc."


def program_ops(events, window: tuple) -> dict:
    """Span name ("ntsc.demodulate.decode") -> [(name, start, end, caller)]
    of the device operations inside the window launched inside any range
    of that name, each tied to its launch by its correlation id, as
    trace.read builds Trace.launched_in for the harness's spans, and the
    call that launched it (_caller)."""
    from torch.autograd import DeviceType
    ws, we = window
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    launch = {e.id: e for e in cpu if e.name.startswith("cu")}
    launched = [(e, launch[e.id]) for e in events
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith((trace.SPAN_PREFIX,
                                           PROGRAM_PREFIX))
                and e.time_range.end > ws and e.time_range.start < we
                and e.id in launch]
    spans: dict = {}
    for e in cpu:
        if e.name.startswith(PROGRAM_PREFIX):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    out = {}
    for name, ranges in spans.items():
        rs = stats.union(ranges)
        out[name] = [(d.name, d.time_range.start, d.time_range.end,
                      _caller(d, c)) for d, c in launched
                     if any(s <= c.time_range.start <= t for s, t in rs)]
    return out


def _caller(dev, call) -> str:
    """The host op around a launch (torch's "aten::where"), or, where a
    span holds the launch itself (the port's own kernels), the kernel's
    name without its namespace and template arguments."""
    parent = call.cpu_parent
    if parent is not None and not parent.name.startswith(PROGRAM_PREFIX):
        return parent.name
    name = dev.name.removeprefix("void ").split("<")[0].split("::")[-1]
    return name.split("(")[0].strip()


def probe_of(tr: Trace):
    """The trace.Probe that recorded `tr`, found among the locals of the
    calling frames by its window, or None."""
    frame = sys._getframe(1)
    while frame is not None:
        for v in list(frame.f_locals.values()):
            if isinstance(v, trace.Probe) and v.prof is not None:
                window = [e for e in v.prof.events() if e.name == trace.WINDOW]
                if len(window) == 1 and (window[0].time_range.start,
                                         window[0].time_range.end) \
                        == tuple(tr.window):
                    return v
        frame = frame.f_back
    return None


def program(tr: Trace) -> dict:
    """program_ops of the Probe that recorded `tr` ({} where none is)."""
    probe = probe_of(tr)
    return {} if probe is None else program_ops(probe.prof.events(),
                                                tr.window)


def idle_by_span(tr: Trace) -> list:
    """[[span, s], ...]: the traced window's idle seconds (the gaps between
    the device's operations inside the steps' walls) summed by the
    innermost program span in flight on the host at each gap's start,
    "outside" where none is; most first."""
    spans = [(s, e, n) for n, s, e in tr.host_ops
             if n.startswith(PROGRAM_PREFIX)]
    out: dict = {}
    for s, e in stats.gaps(tr.busy(), tr.walls):
        inner = [(ss, n) for ss, se, n in spans if ss <= s < se]
        label = max(inner)[1] if inner else "outside"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return sorted(([n, v] for n, v in out.items()), key=lambda kv: -kv[1])


def program_span_device_ms(tr: Trace, name: str) -> Optional[float]:
    """Device ms a step of the operations launched inside the program's
    span `name`; printed with the span's idle ms a step and its device ms
    by launching call."""
    ops = program(tr).get(name)
    if not ops or tr.steps <= 0:
        return None
    by_caller: dict = {}
    for _, s, e, caller in ops:
        by_caller[caller] = by_caller.get(caller, 0.0) + (e - s)
    ms = tr.per_step(sum(by_caller.values())) / 1e3
    idle = dict(idle_by_span(tr)).get(name, 0.0)
    top = sorted(by_caller.items(), key=lambda kv: -kv[1])[:6]
    print(f"{name}: device {ms:.4f} ms a step, idle "
          f"{tr.per_step(idle) * 1e3:.4f} ms a step with it innermost; by "
          "launching call: " + ", ".join(
              f"{n} {tr.per_step(us) / 1e3:.4f}" for n, us in top),
          file=sys.stderr)
    return ms
