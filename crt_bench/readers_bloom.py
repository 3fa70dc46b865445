"""What the bloom cells' roofline metrics read from a Trace: each bloom
kernel's share of its roofline, the kernel picked by its device name (K2's
and K6's bloom instantiations by their template argument), the work from
``crt_bench/work_bloom.py``.  Each returns None where the trace holds no
launch of its kernel."""

from __future__ import annotations

import sys
from typing import Optional

from crt_bench import work, work_bloom
from crt_bench.reference import systems as ref_systems
from crt_bench.trace import Trace

# kernel -> (the CUDA function's name, whether only its BLOOM = true
# instantiation counts)
KERNELS = {"decode_rows_bloom": ("decode_rows_kernel", True),
           "bloom_line_width": ("bloom_line_width_kernel", False),
           "place_rows_bloom": ("place_rows_kernel", True)}


def _is_bloom(name: str) -> bool:
    """A template instantiation with `true` among its arguments, as the
    profiler names it demangled or mangled (Lb1E)."""
    return "true" in name or "Lb1E" in name


def device_s(tr: Trace, kernel: str) -> float:
    """Device seconds of the kernel's launches in the traced window."""
    func, bloom_only = KERNELS[kernel]
    return sum(e - s for n, s, e in tr.device
               if func in n and (_is_bloom(n) or not bloom_only)) / 1e6


def work_of(tr: Trace, kernel: str) -> tuple[int, int]:
    """(bytes, int32 ops) a step of the kernel, from the cell's shapes."""
    conf, B = tr.cell["conf"], tr.cell["traffic"]["batch"]
    cfg = ref_systems.SYSTEMS[conf["system"]]
    outw, outh = conf["output"]["width"], conf["output"]["height"]
    if kernel == "decode_rows_bloom":
        return work_bloom.decode_rows_bloom(
            B, cfg.lines, cfg.hres, cfg.vres, cfg.av_len, outw,
            cfg.cc_samples, conf["noise"])
    if kernel == "bloom_line_width":
        return work_bloom.bloom_line_width(B, cfg.lines, cfg.av_len)
    mon = conf["monitor"]
    return work_bloom.place_rows_bloom(B, cfg.lines, outw, outh // cfg.lines,
                                       bool(mon["blend"]), mon["scanlines"])


def roofline_pct(tr: Trace, kernel: str) -> Optional[float]:
    """The kernel's bound over its device time a step, in %: the larger of
    its bytes over the card's bandwidth and its int32 ops over the card's
    rate (crt_bench/work.py)."""
    took = device_s(tr, kernel)
    if tr.steps <= 0 or took <= 0:
        return None
    bound, by = work.bound_s(*work_of(tr, kernel))
    took = tr.per_step(took)
    print(f"{kernel}: bound {bound * 1e3:.4f} ms a step ({by}), device "
          f"{took * 1e3:.4f} ms a step", file=sys.stderr)
    return 100.0 * bound / took
