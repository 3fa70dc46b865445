"""Run one cell of the benchmark once, on the card:

    python3 crt_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the card (name, count, power limit) on an early line, each number
the check compared beside its limit as the last lines of standard error,
and the result as one JSON object, the last line of standard output.
Exits with another code than 0, printing no result, where there is no
card or too few, or where JAX, Flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def card_line() -> str:
    """Name and power limit of each card, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return "; ".join(res.stdout.strip().splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from crt_bench import harness

    spec = harness.load_spec()
    chips = {c["name"]: c["chips"] for c in spec["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    print(f"card: {card_line()}; count {torch.cuda.device_count()}",
          flush=True)
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_START, spec=spec)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in the measuring process: {', '.join(banned)}",
              file=sys.stderr)
        return 4
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
