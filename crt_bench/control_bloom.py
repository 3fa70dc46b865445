"""The control of the check that decides ``correct`` in the bloom build's
cells: the bloom reference (``crt_bench/reference_bloom``) put in the
program's place, its decoder's 3-band EQ marched in float32 without the
truncations the configuration states.  It drives a cell's own traffic at
the cell's own size and must come out not correct on every seed:

    python3 crt_bench/control_bloom.py --workload bloom_batch2048 \\
        --seconds <s> --seeds <n> [<n> ...]

Each seed prints one JSON line: the seed, ``correct`` and the numbers
compared.  Slow: the reference is plain torch.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from crt_bench.control import Control  # noqa: E402
from crt_bench.reference_bloom import pipeline as ref_bloom  # noqa: E402


class ControlBloom(Control):
    """Control with the bloom build's step."""

    def step_batch(self, cfg, states, imgs, fields, frames, dcos, *,
                   noise=0, mon=None, do_bloom=False):
        return ref_bloom.step(cfg, states, imgs, field=fields, frame=frames,
                              noise=noise, mon=mon, do_bloom=do_bloom,
                              eq_float=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from crt_bench import harness
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               torch.device(args.device), time.perf_counter(),
                               sut=ControlBloom())
        print(json.dumps(dict(seed=seed, correct=res["correct"],
                              failed=res["failed"], checks=res["checks"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
