"""One run of one cell: find the cell's files by name, set it up, measure
its window, read its trace, check its answers against the reference, and
assemble the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``crt_bench/configs/<config>.json`` (the entry's ``file``);
* ``crt_bench/traffic/<traffic>.json``, whose ``driver`` names the loop
  in ``crt_bench/drivers/<driver>.py`` that reads it;
* ``crt_bench/metrics/<metric>.py``, whose ``read(trace)`` returns the
  metric or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Optional

import numpy as np
import torch

from crt_bench import check, stats, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "ntsc_crt_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver works with."""
    conf: dict            # the configuration file
    traffic: dict         # the traffic file
    seed: int
    device: torch.device
    sut: object           # the system under test (program.Port)
    rng: np.random.Generator
    captures: list = dataclasses.field(default_factory=list)
    state: dict = dataclasses.field(default_factory=dict)


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from its file, whatever characters its name holds."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    name = "crt_bench_file_" + "".join(c if c.isalnum() else "_"
                                       for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload, found by name."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    conf = load_json(ROOT / entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, conf, traffic


def driver(traffic: dict) -> ModuleType:
    return load_module(BENCH / "drivers" / f"{traffic['driver']}.py")


def reader(metric: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{metric}.py")


def metrics_of(spec: dict, workload: str, kind: str) -> list[dict]:
    """The end-to-end (kind "end_to_end") or per-layer ("per_layer")
    metrics a cell reports.  An end-to-end metric without a list of cells
    is every cell's; a per-layer metric lists its cells."""
    if kind == "end_to_end":
        return [m for m in spec["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m for m in spec["per_layer"] if workload in m["workloads"]]


def mem_peak(device: torch.device) -> int:
    """Peak bytes allocated on the card since the process started."""
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def banned_modules() -> list[str]:
    """Loaded modules of JAX, Flax or the JAX package, by the whole
    top-level name."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, sut=None,
             spec: Optional[dict] = None,
             traffic_over: Optional[dict] = None) -> dict:
    """One run.  Returns the result line as a dict, "checks" last.
    t_start: the host clock at process start (set-up runs from it).
    traffic_over: traffic parameters replaced (tests run small sizes)."""
    from crt_bench.program import Port
    spec = spec or load_spec()
    _, conf, traffic = cell_files(spec, workload)
    traffic = {**traffic, **(traffic_over or {})}
    sut = sut or Port()
    drv = driver(traffic)
    seed %= 2**63                 # any whole number; generators take these
    ctx = Ctx(conf, traffic, seed, device, sut, np.random.default_rng(seed))

    drv.setup(ctx)
    trace.sync(device)
    setup_s = time.perf_counter() - t_start
    res = drv.window(ctx, seconds)
    peak = mem_peak(device)
    out = {"attempted": res["attempted"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    if traced:
        # after the window, so that the window is an untraced run's
        probe = trace.Probe(sut.span_targets(), device)
        issue: list = []
        probe.begin()
        marks = drv.more(ctx, traffic["trace_steps"])
        probe.finish()
        with trace.patched({"step": sut.span_targets()["step"]},
                           trace.timed(issue, device)):
            drv.more(ctx, traffic["issue_samples"])
        tr = trace.read(probe, list(zip(marks, marks[1:] + [probe.t1])),
                        res["spans"], res["per_step"], issue,
                        dict(workload=workload, conf=conf, traffic=traffic))
        metrics = {}
        for m in metrics_of(spec, workload, "per_layer"):
            v = reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = stats.covered(stats.clip(tr.busy(), [tr.window]))
        device_info["busy_s"] = busy / 1e6
        device_info["window_s"] = (tr.window[1] - tr.window[0]) / 1e6
        out["breakdown"] = trace.breakdown(tr)
    else:
        values = dict(res["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(spec, workload, "end_to_end")}

    drv.release(ctx)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, fields, failed = check.judge(drv.replay(ctx))
    print(f"set-up {setup_s:.3f} s, reference check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    print("\n".join(check.lines(checks, fields)), file=sys.stderr,
          flush=True)
    correct = (failed == 0 and res["attempted"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out.update(correct=correct, failed=failed, metrics=metrics,
               device=device_info, checks=checks)
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks"]
    return {k: out[k] for k in order if k in out}
