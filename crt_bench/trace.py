"""The traced run: torch.profiler over the traffic's steps right after the
window, the harness's spans around the port's entry points, and the Trace
that the per-layer readers (``crt_bench/metrics/<metric>.py``) read.

Device operations are the trace's CUDA events (kernels, copies, sets).
Each is tied to the host call that launched it by the CUDA runtime event
of the same correlation id, so a span's device time is that of the
operations launched inside it.  Profiler times are microseconds from the
trace's start; host clock readings (``time.perf_counter``) are mapped onto
them through the window span, which opens at a known clock reading.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from crt_bench import stats

WINDOW = "crt_bench.window"
SPAN_PREFIX = "crt_bench."


@dataclasses.dataclass
class Trace:
    """What a traced run saw.  Times in microseconds, profiler clock."""
    device: list          # (name, start, end) of each device operation
    launched_in: dict     # span name -> [(name, start, end)] launched inside
    spans: dict           # span name -> [(start, end)]
    walls: list           # the traced window steps' host intervals
    wall_s_per_step: Optional[float]  # host s a step in the window
    steps: int            # calls of the port's step inside the window
    issue_ms: list        # host ms of sampled step calls, device idle
    cell: dict            # the cell, its configuration and traffic
    host_ops: list        # (name, start, end) of host ops, for gap labels
    window: tuple         # (start, end) of the traced window

    def per_step(self, total: float) -> float:
        if self.steps <= 0:
            raise ValueError("no step inside the traced window")
        return total / self.steps

    def device_s(self, names: Optional[tuple] = None) -> float:
        """Device seconds of the operations whose name holds one of
        `names` (all operations if None), summed."""
        return sum(e - s for n, s, e in self.device
                   if names is None or any(k in n for k in names)) / 1e6

    def busy(self) -> list:
        return [(s, e) for _, s, e in self.device]


class Probe:
    """The profiler over the traced steps, the port's entry points inside
    spans meanwhile."""

    def __init__(self, targets: dict, device: torch.device):
        self.targets, self.device = targets, device
        self.prof = None
        self.t0 = self.t1 = None
        self._mark = None
        self._patch = None

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._patch = patched(self.targets, _span)
        self._patch.__enter__()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.t0 = time.perf_counter()

    def finish(self) -> None:
        sync(self.device)
        self.t1 = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self._patch.__exit__(None, None, None)
        self.prof.stop()


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def patched(targets: dict, wrap):
    """Replace each (module, attribute) of `targets` by wrap(name, fn) for
    the block: the port looks these names up on its modules at call time,
    so its own calls go through the replacement."""
    saved = [(mod, attr, getattr(mod, attr), name)
             for name, (mod, attr) in targets.items()]
    for mod, attr, fn, name in saved:
        setattr(mod, attr, wrap(name, fn))
    try:
        yield
    finally:
        for mod, attr, fn, _ in saved:
            setattr(mod, attr, fn)


def _span(name: str, fn):
    label = SPAN_PREFIX + name

    def call(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return call


def timed(samples: list, device: torch.device):
    """A wrapper for patched(): each call waits for the device to go idle,
    then its host time, call to return, goes into `samples` (ms)."""
    def wrap(name: str, fn):
        def call(*a, **k):
            sync(device)
            t = time.perf_counter()
            out = fn(*a, **k)
            samples.append((time.perf_counter() - t) * 1e3)
            return out
        return call
    return wrap


def read(probe: Probe, traced: list, untraced: list, per_step: int,
         issue_ms: list, cell: dict) -> Trace:
    """The Trace of a finished probe.  traced: the host clock intervals
    (s) of the traced steps; untraced: those of the window's steps;
    per_step: calls of the port's step a window step.  The window gives the
    wall a step takes with the profiler off, which the idle share is taken
    against: the profiler's own host work slows the traced steps."""
    from torch.autograd import DeviceType
    evs = probe.prof.events()
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    # the device's own events, without the record_function ranges the
    # profiler also draws on the device's timeline
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(SPAN_PREFIX)]
    window = [e for e in cpu if e.name == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    ws, we = window[0].time_range.start, window[0].time_range.end
    off = ws - probe.t0 * 1e6
    walls = [(s * 1e6 + off, e * 1e6 + off) for s, e in traced]
    wall_s_per_step = (stats.covered(untraced) / (len(untraced) * per_step)
                       if untraced else None)
    inside = [e for e in dev
              if e.time_range.end > ws and e.time_range.start < we]
    device = [(e.name, e.time_range.start, e.time_range.end) for e in inside]
    # the runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...) of each
    # device operation shares its correlation id
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith("cu")}
    spans = {}
    for e in cpu:
        if e.name.startswith(SPAN_PREFIX):
            spans.setdefault(e.name[len(SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    launched_in = {}
    for name, ranges in spans.items():
        rs = stats.union(ranges)
        launched_in[name] = [
            d for d, e in zip(device, inside)
            if e.id in launch and any(s <= launch[e.id] <= t for s, t in rs)]
    steps = sum(1 for s, e in spans.get("step", []) if ws <= s and e <= we)
    host_ops = [(e.name, e.time_range.start, e.time_range.end) for e in cpu
                if e.time_range.end > ws and e.time_range.start < we
                and e.name != WINDOW]
    return Trace(device=device, launched_in=launched_in, spans=spans,
                 walls=walls, wall_s_per_step=wall_s_per_step,
                 steps=steps, issue_ms=issue_ms, cell=cell,
                 host_ops=host_ops, window=(ws, we))


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps, each named by the innermost host op in flight at
    its start ("host" where none is)."""
    by_name: dict = {}
    for n, s, e in tr.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = []
    for s, e in stats.gaps(tr.busy(), tr.walls)[:top]:
        inner = [(os_, n) for n, os_, oe in tr.host_ops if os_ <= s < oe]
        label = max(inner)[1] if inner else "host"
        out.append([label, (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}
