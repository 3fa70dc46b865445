"""What the NES cell's roofline metrics read from a Trace: K13's share of
its roofline, K13 picked by its device name, and the row placement's share
of its byte floor over the device time launched inside the port's
``ntsc.demodulate.place`` spans, whatever implements it; the work from
``crt_bench/work_nes.py``.  Each returns None where the trace holds
nothing to read."""

from __future__ import annotations

import sys
from typing import Optional

from crt_bench import spans, work, work_nes
from crt_bench.reference import systems as ref_systems
from crt_bench.trace import Trace

K13 = ("nes_square_kernel",)


def _report(tr: Trace, kernel: str, counts: tuple, took_s: float) -> float:
    """The bound over the device time a step, in %, printed."""
    bound, by = work.bound_s(*counts)
    print(f"{kernel}: bound {bound * 1e3:.4f} ms a step ({by}), device "
          f"{took_s * 1e3:.4f} ms a step", file=sys.stderr)
    return 100.0 * bound / took_s


def nes_square_roofline_pct(tr: Trace) -> Optional[float]:
    """K13's bound over its device time a step, in %."""
    if tr.steps <= 0 or tr.device_s(K13) <= 0:
        return None
    conf, B = tr.cell["conf"], tr.cell["traffic"]["batch"]
    inp = conf["input"]
    counts = work_nes.nes_square(ref_systems.SYSTEMS[conf["system"]], B,
                                 inp["height"], inp["width"])
    return _report(tr, "nes_square", counts, tr.per_step(tr.device_s(K13)))


def place_rows_roofline_pct(tr: Trace) -> Optional[float]:
    """The placement's byte floor over the device time a step of what the
    port launched inside ntsc.demodulate.place, in %."""
    ms = spans.program_span_device_ms(tr, "ntsc.demodulate.place")
    if not ms:
        return None
    conf, B = tr.cell["conf"], tr.cell["traffic"]["batch"]
    out = conf["output"]
    counts = work_nes.place_rows(
        B, ref_systems.SYSTEMS[conf["system"]].lines, out["width"],
        out["height"])
    return _report(tr, "place_rows", counts, ms / 1e3)
