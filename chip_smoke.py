#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntsc_crt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build   — nvcc compiles ntsc_crt_tpu_torch/csrc/*.cu for sm_90a.
3. kernels — K1 encode_rows, K2 decode_rows, K3 hsync_chase against their
   plain torch versions on the card, on the inputs the main path hands them
   (NTSC, 640x480 output) at batch 1 and 64; exact equality, and each side's
   time from CUDA events.
4. goldens — tags NTSC and NTSC_b16 of tests/fixtures/device_parity_goldens
   .npz replayed through step / step_batch on the card, bit-exact.
5. main path — NTSC 640x480, noise 12, field/frame alternating: batch 1 from
   a 640x480 image (the live use) and batch 512 from 320x240 images (the
   throughput use).  Every kernel must launch during it, and the last step
   must equal the same step run on the CPU's plain path.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Every number is measured in this run.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

GOLDENS = (Path(__file__).resolve().parent / "tests" / "fixtures"
           / "device_parity_goldens.npz")
OUTW, OUTH = 640, 480
ORIGIN = {  # kernel -> (CUDA source, the Pallas kernel's pallas_call)
    "encode_rows": ("ntsc_crt_tpu_torch/csrc/encode.cu",
                    "ntsc_crt_tpu/ops/pallas/encode_fused.py:179"),
    "decode_rows": ("ntsc_crt_tpu_torch/csrc/decode.cu",
                    "ntsc_crt_tpu/ops/pallas/decode_fused.py:416"),
    "hsync_chase": ("ntsc_crt_tpu_torch/csrc/hsync.cu",
                    "ntsc_crt_tpu/ops/pallas/hsync_scan.py:318"),
}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def capture_kernel_inputs(torch, pipeline, cfg, B, dev):
    """The arguments each kernel wrapper receives on the second step of a
    batch-B run (a locked, non-trivial state), recorded by wrapping the
    wrappers for the length of that step."""
    from ntsc_crt_tpu_torch.ops.kernels import decode, encode, hsync
    rng = np.random.default_rng(B)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, 240, 320, 3),
                                        dtype=np.uint8), device=dev)
    st = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    st = pipeline.step_batch(cfg, st, imgs, zeros, zeros, zeros, noise=12)
    seen = {}
    originals = {}
    for mod, name in ((encode, "encode_rows"), (decode, "decode_rows"),
                      (hsync, "hsync_chase")):
        def rec(*a, _f=getattr(mod, name), _n=name, **k):
            seen[_n] = (a, k)
            return _f(*a, **k)
        originals[name] = (mod, getattr(mod, name))
        setattr(mod, name, rec)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    pipeline.step_batch(cfg, st, imgs, ones, ones, zeros, noise=12)
    for name, (mod, fn) in originals.items():
        setattr(mod, name, fn)
    return seen


def phase_kernels(torch, pipeline, cfg, dev):
    """Kernel vs plain version at batch 1 and 64; returns the table rows
    (times at batch 64)."""
    from ntsc_crt_tpu_torch.ops.kernels import decode, encode, hsync
    kernels = {"encode_rows": (encode.encode_rows, encode.encode_rows_plain),
               "decode_rows": (decode.decode_rows, decode.decode_rows_plain),
               "hsync_chase": (hsync.hsync_chase, hsync.hsync_chase_plain)}
    rows = {}
    for B in (1, 64):
        seen = capture_kernel_inputs(torch, pipeline, cfg, B, dev)
        for name, (kern, plain) in kernels.items():
            a, k = seen[name]
            got = kern(*a, **k)
            want = plain(*a, **k)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            if got.shape != want.shape or err != 0:
                raise SystemExit(f"{name} batch {B}: kernel differs from "
                                 f"plain (max |err| {err})")
            ms = cuda_ms(torch, lambda: kern(*a, **k), 20)
            plain_ms = cuda_ms(torch, lambda: plain(*a, **k), 2)
            print(f"kernel {name} batch {B} shape {tuple(got.shape)}: "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, max |err| {err}",
                  flush=True)
            rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rows


def phase_goldens(torch, pipeline, cfg, dev):
    ref = np.load(GOLDENS)
    img = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3),
                                           np.uint8)[0]
    st = pipeline.crt_init(cfg, 128, 96, device=dev)
    for f in (0, 1):
        st = pipeline.step(cfg, st, torch.as_tensor(img, device=dev),
                           field=f, frame=f, noise=7)
    runs = {"NTSC": st}
    B = 16
    imgs = torch.as_tensor(np.random.RandomState(0).randint(
        0, 256, (B, 60, 80, 3), np.uint8), device=dev)
    st = pipeline.init_batch(cfg, B, 128, 96, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    alt = torch.arange(B, dtype=torch.int32, device=dev) % 2
    st = pipeline.step_batch(cfg, st, imgs, zeros, zeros, zeros, noise=7)
    runs["NTSC_b16"] = pipeline.step_batch(cfg, st, imgs, alt, alt, zeros,
                                           noise=7)
    for tag, st in runs.items():
        for k, v in st._asdict().items():
            want = ref[f"{tag}/{k}"]
            got = v.cpu().numpy()
            if got.shape != want.shape or not np.array_equal(got, want):
                raise SystemExit(f"golden {tag}/{k} differs on the card")
        print(f"golden {tag}: all 7 state leaves bit-exact", flush=True)


def run_main_path(torch, pipeline, cfg, B, imgs, steps, dev):
    """`steps` timed steps from a warmed state; returns (ms per step, the
    state before the last step, the last step's args, the final state)."""
    st = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    slot = torch.arange(B, dtype=torch.int32, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)

    def args(i):
        return ((slot + i) % 2, ((slot + i) >> 1) % 2, zeros)

    for i in range(2):
        st = pipeline.step_batch(cfg, st, imgs, *args(i), noise=12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        prev = st
        st = pipeline.step_batch(cfg, st, imgs, *args(i), noise=12)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return ms, prev, args(steps - 1), st


def check_against_cpu(torch, pipeline, cfg, prev, imgs, args, got, n):
    """Re-run the last step for slots [0, n) on the CPU's plain path."""
    cpu = lambda t: t[:n].cpu()
    st = pipeline.CRTState(*(cpu(x) for x in prev))
    want = pipeline.step_batch(cfg, st, cpu(imgs), *(cpu(a) for a in args),
                               noise=12)
    for k, v in got._asdict().items():
        if not torch.equal(v[:n].cpu(), getattr(want, k)):
            raise SystemExit(f"main path leaf {k} differs from the CPU")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from ntsc_crt_tpu_torch import NTSC
    from ntsc_crt_tpu_torch.models import pipeline
    from ntsc_crt_tpu_torch.ops.kernels import build, decode, encode, hsync

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.last_build['seconds']:.2f} s) -> {build.last_build['path']}")
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. kernels vs plain versions
    table = phase_kernels(torch, pipeline, NTSC, dev)

    # 4. goldens
    phase_goldens(torch, pipeline, NTSC, dev)

    # 5. the main path, counted
    mods = {"encode_rows": encode, "decode_rows": decode,
            "hsync_chase": hsync}
    rng = np.random.default_rng(1234)
    img1 = torch.as_tensor(rng.integers(0, 256, (1, OUTH, OUTW, 3),
                                        dtype=np.uint8), device=dev)
    B = 512
    imgsB = torch.as_tensor(rng.integers(0, 256, (B, 240, 320, 3),
                                         dtype=np.uint8), device=dev)
    for m in mods.values():
        m.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    ms1, prev1, args1, st1 = run_main_path(torch, pipeline, NTSC, 1, img1,
                                           30, dev)
    mem1 = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    msB, prevB, argsB, stB = run_main_path(torch, pipeline, NTSC, B, imgsB,
                                           5, dev)
    memB = torch.cuda.max_memory_allocated(dev)
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    print(f"main path launches: {launches}", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"main path never launched {missing}")
    for k, st in (("batch 1", st1), (f"batch {B}", stB)):
        if tuple(st.out.shape[1:]) != (OUTH, OUTW, 3) or \
                st.out.dtype != torch.uint8:
            raise SystemExit(f"{k}: bad output {tuple(st.out.shape)}")
    check_against_cpu(torch, pipeline, NTSC, prev1, img1, args1, st1, 1)
    check_against_cpu(torch, pipeline, NTSC, prevB, imgsB, argsB, stB, 2)
    print("main path: last step equals the CPU plain path "
          "(batch 1; slots 0-1 of batch 512)")
    for b, ms, mem in ((1, ms1, mem1), (B, msB, memB)):
        print(f"NTSC 640x480 batch {b}: {ms / b:.4f} ms/frame, "
              f"{b * 1e3 / ms:.2f} frames/s, {ms:.3f} ms/step, peak "
              f"{mem / 2**20:.1f} MiB allocated  [{card}]", flush=True)

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=ORIGIN[k][0], replaces=ORIGIN[k][1],
             launches=launches[k], **table[k]) for k in mods]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
