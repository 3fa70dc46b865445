"""Stage spans, stage timers, CUDA-event kernel timing and torch.profiler
traces.

Counterpart of ``ntsc_crt_tpu/utils/profiling.py``.  The reference has no
profiling at all (crt_main.c:238 prints progress).  Here:

* ``span`` — a named range around a stage of the step, recorded only while
  a profiler runs (``ntsc.<name>``, nested as the calls nest);
* ``time_fn`` / ``profile_stages`` — host-clock seconds per call, the
  clock read after the device has finished (``torch.cuda.synchronize``);
* ``cuda_ms`` — a kernel's time between two CUDA events, as the host issues
  its calls or queued behind a spin kernel (the card's own time);
* ``profile_step`` — one call under torch.profiler: device operations, busy
  time and each port kernel's device time and launches;
* ``trace`` / ``kernel_breakdown`` / ``profile_kernels`` — a Chrome trace
  written under a directory, and the events of the newest one summed by
  name (open the file in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

DEFAULT_LOGDIR = os.path.join(tempfile.gettempdir(), "ntsc_trace")
# the categories of a Chrome trace's device events
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as the profiler range "ntsc.<name>"
    while a torch.profiler runs, and does nothing otherwise: entering a
    range costs host time even with no profiler running, the check a small
    part of it.  The range keeps no clock of its own.  It lies on
    the trace's timeline beside the device operations launched inside it,
    each tied to it by its launch's correlation id; its parent is the range
    it nests in (the event's ``cpu_parent``); it is written out with the
    trace (``trace``)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("ntsc." + name)
    return _NO_SPAN


def _sync(out) -> None:
    """Wait for the device work behind every CUDA tensor in `out` (a tensor,
    or a tuple or list of them such as a CRTState)."""
    if torch.is_tensor(out):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _sync(x)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kwargs) -> float:
    """Steady-state seconds per call of `fn`, the clock stopped once the
    device has produced the last result."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def _bench_inputs(cfg, batch: int, device):
    """Seeded 320x240 images (NES: 256x240 PPU pixels) and zero
    field/frame/dot-crawl vectors on `device`."""
    rng = np.random.RandomState(0)
    if cfg.kind == "nes":
        imgs = rng.randint(0, 512, (batch, 240, 256), np.uint16)
    else:
        imgs = rng.randint(0, 256, (batch, 240, 320, 3), np.uint8)
    z = torch.zeros(batch, dtype=torch.int32, device=device)
    return torch.as_tensor(imgs, device=device), z


def profile_stages(system: str = "NTSC", batch: int = 64, outw: int = 640,
                   outh: int = 480, noise: int = 12, iters: int = 10,
                   warmup: int = 2, device=None) -> Dict[str, float]:
    """ms per frame of each stage of the composite path and of the step.

      modulate    encoder only (RGB/PPU -> analog field)
      demodulate  decoder only (noise, sync, YIQ, scan conversion)
      step        modulate then demodulate, as step_batch runs them

    device=None means the CUDA card."""
    from ntsc_crt_tpu_torch.models import pipeline
    from ntsc_crt_tpu_torch.models.systems import SYSTEMS
    from ntsc_crt_tpu_torch.parallel import mesh

    device = pipeline.resolve_device(device)
    cfg = SYSTEMS[system]
    states = pipeline.init_batch(cfg, batch, outw, outh, device=device)
    imgs, z = _bench_inputs(cfg, batch, device)

    def mod(s):
        return pipeline.modulate(cfg, s, imgs, field=z, frame=z,
                                 dot_crawl_offset=z)

    def dem(s):
        return pipeline.demodulate(cfg, s, noise=noise)

    step = mesh.make_batched_step(cfg, noise=noise)
    kw = dict(iters=iters, warmup=warmup)
    res = {"modulate": time_fn(mod, states, **kw)}
    res["demodulate"] = time_fn(dem, mod(states), **kw)
    res["step"] = time_fn(step, states, imgs, z, z, z, **kw)
    return {k: v / batch * 1e3 for k, v in res.items()}


# the port's CUDA functions on the pipeline paths, as the profiler names
# them, and their kernels (K2's and K6's mode from their template
# arguments)
KERNEL_FUNCS = (("encode_rows_kernel", "encode_rows"),
                ("decode_rows_kernel", "decode_rows"),
                ("bloom_line_width_kernel", "bloom_line_width"),
                ("hsync_chase_kernel", "hsync_chase"),
                ("ccf_ema_kernel", "ccf_ema"),
                ("vhs_region_b_kernel", "vhs_region_b_entries"),
                ("inject_noise_kernel", "inject_noise"),
                ("vhs_noise_bc_kernel", "vhs_noise_bc"),
                ("place_rows_kernel", "place_rows_uniform"),
                ("nes_square_kernel", "nes_square"))


def kernel_of(event: str):
    """The kernel of a device event's name, or None."""
    for fn, name in KERNEL_FUNCS:
        if fn in event:
            if name == "decode_rows" and "Fir" in event:
                return "decode_rows_conv"
            bloom = "true" in event or "Lb1E" in event
            if name in ("decode_rows", "place_rows_uniform") and bloom:
                return f"{name}_bloom"
            return name
    return None


def device_ms(avg) -> float:
    """A key_averages() row's own device time, ms."""
    us = getattr(avg, "self_device_time_total", None)
    return (avg.self_cuda_time_total if us is None else us) / 1e3


def cuda_ms(fn, reps: int, spin: bool = False, sm_hz=None) -> float:
    """Mean time of fn() over `reps` calls between two CUDA events, after
    one warm-up.  spin=False times the calls as the host issues them: a
    kernel shorter than one call's host time reads the host's rate of
    launching it.  spin=True queues the calls behind a spin kernel that
    outlasts their host time, so the device runs them back to back and the
    time is the card's (a call that waits on the device still counts the
    host's time after the wait).  sm_hz: the SM clock that sizes the spin
    (2 GHz if not given)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # the spin: the warm-up's time with its device work for every call,
    # plus 1 ms, at most 50 ms (beyond that the host's share is small)
    spin_s = min(reps * (time.perf_counter() - t0) + 1e-3, 0.05)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(spin_s * (sm_hz or 2e9)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_step(fn):
    """(device operations, of which kernels, device busy ms, wall ms, the
    eight torch ops with the most host time, {kernel: (device ms,
    launches)} of the port's kernels) of one call of fn() under
    torch.profiler; counts 0 if the trace shows no device events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
    busy, end = 0.0, -1.0
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                 reverse=True)[:8]
    top = ", ".join(f"{a.key} {a.count}x {a.self_cpu_time_total / 1e3:.3f}"
                    for a in top)
    ours = {}
    for e in kernels:
        name = kernel_of(e.name)
        if name is not None:
            ms, n = ours.get(name, (0.0, 0))
            ours[name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                          n + 1)
    return len(evs), len(kernels), busy / 1e3, wall, top, ours


@contextlib.contextmanager
def trace(logdir: str = DEFAULT_LOGDIR):
    """torch.profiler around a code block (host ops, and the card's where
    there is one), written as `trace.<ns>.json` under `logdir` on exit.
    Yields the profiler.

        with profiling.trace(d):
            step(states, imgs, fields, frames, dcos)
        total_ms, rows = profiling.kernel_breakdown(d)
    """
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        str(Path(logdir) / f"trace.{time.time_ns()}.json"))


def kernel_breakdown(logdir: str = DEFAULT_LOGDIR, top: int = 16):
    """Sum the device's complete events (kernels, copies, sets) of the
    newest trace under `logdir` by name.

    Returns (total_ms, rows) with rows (name, ms, calls) sorted by time."""
    files = sorted(Path(logdir).glob("**/trace.*.json"),
                   key=lambda p: int(p.name.split(".")[1]))
    if not files:
        raise FileNotFoundError(f"no trace.*.json under {logdir}")
    with open(files[-1]) as f:
        events = json.load(f)["traceEvents"]
    dur = collections.Counter()
    calls = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e \
                and e.get("cat") in DEVICE_CATS:
            dur[e["name"]] += e["dur"]
            calls[e["name"]] += 1
    rows = [(n, d / 1e3, calls[n]) for n, d in dur.most_common(top)]
    return sum(dur.values()) / 1e3, rows


def profile_kernels(system: str = "NTSC", batch: int = 256, noise: int = 12,
                    steps: int = 3, logdir: str = DEFAULT_LOGDIR,
                    top: int = 16, device=None):
    """Run `steps` batched steps (640x480) under `trace` and sum their
    device events by kernel (see kernel_breakdown).  device=None means the
    CUDA card."""
    from ntsc_crt_tpu_torch.models import pipeline
    from ntsc_crt_tpu_torch.models.systems import SYSTEMS
    from ntsc_crt_tpu_torch.parallel import mesh

    device = pipeline.resolve_device(device)
    cfg = SYSTEMS[system]
    states = pipeline.init_batch(cfg, batch, 640, 480, device=device)
    step = mesh.make_batched_step(cfg, noise=noise)
    imgs, z = _bench_inputs(cfg, batch, device)
    states = step(states, imgs, z, z, z)          # warm
    _sync(states)
    with trace(logdir):
        for _ in range(steps):
            states = step(states, imgs, z, z, z)
    return kernel_breakdown(logdir, top=top)
