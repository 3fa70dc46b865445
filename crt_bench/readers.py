"""What the per-layer metric files (``crt_bench/metrics/<metric>.py``)
read from a Trace.  Each returns None where the trace holds nothing to
read, and the harness then leaves the metric out of the line."""

from __future__ import annotations

import sys
from typing import Optional

from crt_bench import stats, work
from crt_bench.reference import systems as ref_systems
from crt_bench.trace import Trace

K1 = ("encode_rows_kernel",)
K2 = ("decode_rows_kernel",)


def issue_ms(tr: Trace) -> Optional[float]:
    """Mean host ms of a step call, the device idle at the call."""
    if not tr.issue_ms:
        return None
    return sum(tr.issue_ms) / len(tr.issue_ms)


def ops_per_step(tr: Trace) -> Optional[float]:
    """Device operations (kernels, copies, sets) a step."""
    if not tr.device or tr.steps <= 0:
        return None
    return tr.per_step(len(tr.device))


def span_device_ms(tr: Trace, span: str) -> Optional[float]:
    """Device ms a step of the operations launched inside a span."""
    ops = tr.launched_in.get(span)
    if not ops or tr.steps <= 0:
        return None
    return tr.per_step(sum(e - s for _, s, e in ops)) / 1e3


def idle_pct(tr: Trace) -> Optional[float]:
    """The share of a step's wall in which no device operation ran, in %:
    1 - (the union of the device's operations in the traced window, a
    step) / (the host seconds a step took after the trace, the profiler
    off).  In an open loop a step's wall runs from its due time to its
    return, so the pacing between frames does not count."""
    if not tr.device or tr.steps <= 0 or tr.wall_s_per_step is None:
        return None
    busy = stats.covered(stats.clip(tr.busy(), [tr.window])) / 1e6
    return 100.0 * (1.0 - busy / tr.steps / tr.wall_s_per_step)


def _shapes(tr: Trace):
    conf = tr.cell["conf"]
    return (ref_systems.SYSTEMS[conf["system"]], tr.cell["traffic"]["batch"],
            conf)


def roofline_pct(tr: Trace, kernel: str) -> Optional[float]:
    """The kernel's bound over its device time a step, in %: the bound is
    the larger of its bytes over the card's bandwidth and its int32 ops
    over the card's rate (crt_bench/work.py), from the cell's shapes."""
    names = {"encode_rows": K1, "decode_rows": K2}[kernel]
    if tr.steps <= 0 or tr.device_s(names) <= 0:
        return None
    cfg, B, conf = _shapes(tr)
    if kernel == "encode_rows":
        inp = conf["input"]
        nbytes, ops = work.encode_rows(
            B, inp["height"], inp["width"], (cfg.lines * 64500) >> 16,
            cfg.av_len, cfg.cc_samples, cfg.do_bandlimiting)
    else:
        nbytes, ops = work.decode_rows(B, cfg.lines, cfg.hres, cfg.av_len,
                                       conf["output"]["width"],
                                       cfg.cc_samples)
    bound, by = work.bound_s(nbytes, ops)
    took = tr.per_step(tr.device_s(names))
    print(f"{kernel}: bound {bound * 1e3:.4f} ms a step ({by}), device "
          f"{took * 1e3:.4f} ms a step", file=sys.stderr)
    return 100.0 * bound / took
