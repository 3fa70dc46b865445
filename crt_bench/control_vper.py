"""The control of the check that decides ``correct`` in the cells of the
encoders with a carrier table a vertical phase class (PV1K): the vper
reference (``crt_bench/reference_vper``) put in the program's place, its
decoder's 3-band EQ marched in float32 without the truncations the
configuration states.  It drives a cell's own traffic at the cell's own
size and must come out not correct on every seed:

    python3 crt_bench/control_vper.py --workload pv1k_batch2048 \\
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
from crt_bench.reference_vper import pipeline as ref_vper  # noqa: E402


class ControlVper(Control):
    """Control with the vper encoder's step."""

    def step_batch(self, cfg, states, imgs, fields, frames, dcos, *,
                   noise=0, mon=None):
        return ref_vper.step(cfg, states, imgs, field=fields, frame=frames,
                             dot_crawl_offset=dcos, noise=noise, mon=mon,
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
                               sut=ControlVper())
        print(json.dumps(dict(seed=seed, correct=res["correct"],
                              failed=res["failed"], checks=res["checks"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
