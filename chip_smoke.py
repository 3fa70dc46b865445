#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntsc_crt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build   — nvcc compiles ntsc_crt_tpu_torch/csrc/*.cu for sm_90a, one
   process per source, all started together.
3. kernels — each kernel against its plain torch version on the card, on the
   inputs the main paths hand it at batch 1 and 64: K1 encode_rows, K2
   decode_rows and K3 hsync_chase from an NTSC step, K4 ccf_ema and K5
   vhs_region_b_entries from an NTSCVHS step (640x480 output).  Exact
   equality; each side's time from CUDA events; each kernel's bound from
   these inputs (see BOUNDS below).
4. goldens — tags NTSC, NTSC_b16, NTSCVHS and NTSCVHS_b16 of
   tests/fixtures/device_parity_goldens.npz replayed through step /
   step_batch on the card, bit-exact (NTSCVHS_b16: see JAX_VSYNC_PICK_SLOTS).
5. main paths — NTSC, then NTSCVHS (do_aberration 1), each 640x480, noise
   12, field/frame alternating: batch 1 from a 640x480 image (the live use)
   and batch 512 from 320x240 images (the throughput use).  The launch
   counts are zeroed just before each path and read just after it: every
   kernel of the path must have launched.  Each path's last step must equal
   the same step run on the CPU's plain path.  Then, for each path and batch,
   one step timed stage by stage (host clock around synchronized stages) and
   one step under torch.profiler (device launches and busy time).

BOUNDS: a kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and the int32
instructions it executes on these inputs (counted from its source; where
the work depends on the data, what this data needs) over the card's INT32
instruction rate, 132 SMs x 64 lanes x 1.98 GHz (H100 SXM).  For the serial kernels (K3,
K4, K5) the dependent chain of the longest entry is also priced at an
assumed 4 cycles per dependent integer instruction and 260 cycles per
dependent load that hits L2, at 1.98 GHz (`chain`).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Every number is measured in this run.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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
    "ccf_ema": ("ntsc_crt_tpu_torch/csrc/ccf.cu",
                "ntsc_crt_tpu/ops/pallas/ccf_scan.py:108"),
    "vhs_region_b_entries": ("ntsc_crt_tpu_torch/csrc/vhs.cu",
                             "ntsc_crt_tpu/ops/pallas/vhs_scan.py:98"),
}
# Slots of the NTSCVHS_b16 golden that hold the JAX package's cross-slot
# vsync pick (its demodulate.py:295 broadcasts the pick to (B, B) and takes
# every slot's line from slot 0's candidates).  The port decodes each slot
# on its own; those slots are held against the port's CPU plain path, which
# tests/test_torch_vhs.py holds against the JAX step run on the slot alone.
JAX_VSYNC_PICK_SLOTS = {"NTSCVHS_b16": [5]}

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3, NVIDIA data sheet
CLOCK_HZ = 1.98e9                    # H100 SXM boost clock
INT32_PER_S = 132 * 64 * CLOCK_HZ    # SMs x INT32 lanes a cycle x clock
DEP_CYCLES = 4                       # assumed: one dependent int instruction
LOAD_CYCLES = 260                    # assumed: one dependent load from L2


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
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


@contextlib.contextmanager
def patched(targets, wrap):
    """Replace each (module, name) attribute by wrap(name, original) for the
    length of the block; callers look the name up on the module at call
    time, so the pipeline goes through the replacement."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# --- the kernels: plain versions, bounds --------------------------------------


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def work_encode(a, k, out):
    """Per sample: resample index 2, RGB->YIQ 18, IIR 12, carrier 4, IRE 5,
    clamp 2 (csrc/encode.cu)."""
    per = 43 if k["coefs"] is not None else 31
    return nbytes(*a, out), out.numel() * per, None


def work_decode(a, k, out):
    """Per sample: Y/I/Q 5, three EQs of 50 each, output shifts 3; per pixel:
    lerp 17, YIQ->RGB, contrast and clamp 27 (csrc/decode.cu)."""
    B, L = a[1].shape
    return (nbytes(*a, out), B * L * (k["av_len"] * 158 + k["outw"] * 44),
            None)


def work_hsync(a, k, out):
    """Per window sample probed: load-add, compare, branch; per line 6.  The
    probes are this data's: up to the first hit of each line's window."""
    rows2, active, h0 = a
    HP = rows2.shape[2]
    tW = 2 * k["W"]
    prev = torch.cat([h0[:, None], out[:, :-1]], dim=1)   # estimate before
    x = (prev + k["c0"]).long()[..., None] + torch.arange(tW,
                                                          device=rows2.device)
    win = torch.gather(rows2, 2, x.clamp(0, HP - 1)).to(torch.int32)
    win = torch.where((x >= 0) & (x < HP), win, 0)
    hit = torch.cumsum(win, dim=2) <= k["thresh"]
    probes = torch.where(hit.any(2), hit.to(torch.int32).argmax(2) + 1, tW)
    ops = int(probes.sum()) * 3 + probes.numel() * 6
    chain = (LOAD_CYCLES + (2 * probes + 4) * DEP_CYCLES).sum(1).max()
    return nbytes(rows2, active, h0, out), ops, int(chain)


def work_ccf(a, k, out):
    """Per fold step: shared load, multiply, three for the truncating /128,
    add — five of them on the chain; per line and class 4 (select, write)."""
    per_cls, vper, active, ccf0 = a
    B, L, m, CC = per_cls.shape
    act = active.sum(1)
    ops = int(act.sum()) * m * CC * 6 + B * L * CC * 4
    chain = int(act.max()) * m * 5 * DEP_CYCLES + L * 3 * DEP_CYCLES
    return nbytes(*a, *out), ops, chain


def work_vhs(a, k, out):
    """Per step: two multiply-adds, shift, the % 20 as multiply-high, shift
    and multiply-subtract, the test's multiply-add, compare, select, store —
    ten, eight of them on the chain (csrc/vhs.cu)."""
    n, B = out.shape
    return nbytes(*a, out), n * B * 10, n * 8 * DEP_CYCLES


def bound(work):
    """(bound ms, "bytes" or "operations", chain ms or None)."""
    nb, ops, chain = work
    t_bytes, t_ops = nb / HBM_BYTES_PER_S, ops / INT32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            None if chain is None else chain / CLOCK_HZ * 1e3)


def kernel_modules():
    """name -> (wrapper's module, plain version, work counter)."""
    from ntsc_crt_tpu_torch.ops.kernels import ccf, decode, encode, hsync, vhs
    return {"encode_rows": (encode, encode.encode_rows_plain, work_encode),
            "decode_rows": (decode, decode.decode_rows_plain, work_decode),
            "hsync_chase": (hsync, hsync.hsync_chase_plain, work_hsync),
            "ccf_ema": (ccf, ccf.ccf_ema_plain, work_ccf),
            "vhs_region_b_entries": (vhs, vhs.vhs_region_b_entries_plain,
                                     work_vhs)}


def path_args(B, i, dev):
    """(fields, frames, dot-crawl offsets) of step i: alternating per slot."""
    slot = torch.arange(B, dtype=torch.int32, device=dev)
    return ((slot + i) % 2, ((slot + i) >> 1) % 2,
            torch.zeros(B, dtype=torch.int32, device=dev))


def capture_kernel_inputs(pipeline, cfg, B, names, dev, kw):
    """The arguments each named wrapper receives on the second step of a
    batch-B run (a locked, non-trivial state)."""
    mods = kernel_modules()
    rng = np.random.default_rng(B)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, 240, 320, 3),
                                        dtype=np.uint8), device=dev)
    st = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    st = pipeline.step_batch(cfg, st, imgs, *path_args(B, 0, dev), noise=12,
                             **kw)
    seen = {}

    def record(name, fn):
        def rec(*a, **k):
            seen[name] = (a, k)
            return fn(*a, **k)
        return rec

    with patched([(mods[n][0], n) for n in names], record):
        pipeline.step_batch(cfg, st, imgs, *path_args(B, 1, dev), noise=12,
                            **kw)
    return seen


def phase_kernels(pipeline, systems, dev):
    """Each kernel vs its plain version at batch 1 and 64.  Returns
    {name: {B: row}}."""
    mods = kernel_modules()
    groups = ((systems.NTSC, ("encode_rows", "decode_rows", "hsync_chase"),
               {}),
              (systems.NTSCVHS, ("ccf_ema", "vhs_region_b_entries"),
               {"do_aberration": 1}))
    rows = {name: {} for name in mods}
    for cfg, names, kw in groups:
        for B in (1, 64):
            seen = capture_kernel_inputs(pipeline, cfg, B, names, dev, kw)
            for name in names:
                mod, plain, work = mods[name]
                kern = getattr(mod, name)
                a, k = seen[name]
                got, want = kern(*a, **k), plain(*a, **k)
                torch.cuda.synchronize()
                got_t = got if isinstance(got, tuple) else (got,)
                want_t = want if isinstance(want, tuple) else (want,)
                err = max(int((g.to(torch.int64) - w.to(torch.int64))
                              .abs().max()) for g, w in zip(got_t, want_t))
                if [g.shape for g in got_t] != [w.shape for w in want_t] \
                        or err != 0:
                    raise SystemExit(f"{name} batch {B}: kernel differs "
                                     f"from plain (max |err| {err})")
                ms = cuda_ms(lambda: kern(*a, **k), 20)
                plain_ms = cuda_ms(lambda: plain(*a, **k), 1)
                bound_ms, bound_by, chain_ms = bound(work(a, k, got))
                chain = ("" if chain_ms is None
                         else f", chain {chain_ms:.4f} ms")
                print(f"kernel {name} batch {B} ({cfg.name}) shapes "
                      f"{[tuple(g.shape) for g in got_t]}: {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
                      f"({bound_by}){chain}, max |err| {err}", flush=True)
                rows[name][B] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
    return rows


# --- goldens ------------------------------------------------------------------


def golden_run(pipeline, cfg, B, dev):
    """The recipe of bench.py:198-235: two 320x240 frames at 128x96 (B = 1,
    unbatched state) or sixteen 80x60 slots through step_batch, noise 7;
    the second step toggles field/frame."""
    if B == 1:
        img = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3),
                                               np.uint8)[0]
        st = pipeline.crt_init(cfg, 128, 96, device=dev)
        for f in (0, 1):
            st = pipeline.step(cfg, st, torch.as_tensor(img, device=dev),
                               field=f, frame=f, noise=7)
        return st
    imgs = torch.as_tensor(np.random.RandomState(0).randint(
        0, 256, (B, 60, 80, 3), np.uint8), device=dev)
    st = pipeline.init_batch(cfg, B, 128, 96, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    alt = torch.arange(B, dtype=torch.int32, device=dev) % 2
    st = pipeline.step_batch(cfg, st, imgs, zeros, zeros, zeros, noise=7)
    return pipeline.step_batch(cfg, st, imgs, alt, alt, zeros, noise=7)


def phase_goldens(pipeline, systems, dev):
    ref = np.load(GOLDENS)
    runs = (("NTSC", systems.NTSC, 1), ("NTSC_b16", systems.NTSC, 16),
            ("NTSCVHS", systems.NTSCVHS, 1),
            ("NTSCVHS_b16", systems.NTSCVHS, 16))
    for tag, cfg, B in runs:
        st = golden_run(pipeline, cfg, B, dev)
        skip = JAX_VSYNC_PICK_SLOTS.get(tag, [])
        keep = [s for s in range(B) if s not in skip]
        for k, v in st._asdict().items():
            got = v.cpu().numpy()
            want = ref[f"{tag}/{k}"]
            if B > 1:
                got, want = got[keep], want[keep]
            if got.shape != want.shape or not np.array_equal(got, want):
                raise SystemExit(f"golden {tag}/{k} differs on the card")
        msg = f"golden {tag}: all 7 state leaves bit-exact"
        if skip:
            cpu = golden_run(pipeline, cfg, B, torch.device("cpu"))
            for k, v in st._asdict().items():
                if not torch.equal(v.cpu(), getattr(cpu, k)):
                    raise SystemExit(f"golden {tag}/{k}: card differs from "
                                     "the CPU plain path")
            msg += (f" in slots {keep[0]}-{keep[-1]} but {skip}; all "
                    f"{B} slots equal the CPU plain path; slots {skip} hold "
                    "the JAX package's cross-slot vsync pick")
        print(msg, flush=True)


# --- the main paths -----------------------------------------------------------


def run_main_path(pipeline, cfg, B, imgs, steps, dev, kw):
    """Two warm-up steps, then `steps` timed steps; returns (ms per step,
    the state before the last step, the last step's args, the final state,
    steps run)."""
    st = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    for i in range(2):
        st = pipeline.step_batch(cfg, st, imgs, *path_args(B, i, dev),
                                 noise=12, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        prev = st
        st = pipeline.step_batch(cfg, st, imgs, *path_args(B, i, dev),
                                 noise=12, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return ms, prev, path_args(B, steps - 1, dev), st, steps + 2


def check_against_cpu(pipeline, cfg, prev, imgs, args, got, n, kw):
    """Re-run the last step for slots [0, n) on the CPU's plain path."""
    cpu = lambda t: t[:n].cpu()  # noqa: E731
    st = pipeline.CRTState(*(cpu(x) for x in prev))
    want = pipeline.step_batch(cfg, st, cpu(imgs), *(cpu(a) for a in args),
                               noise=12, **kw)
    for k, v in got._asdict().items():
        if not torch.equal(v[:n].cpu(), getattr(want, k)):
            raise SystemExit(f"{cfg.name} main path leaf {k} differs from "
                             "the CPU")


def stage_times(pipeline, fn):
    """One call of fn() with each stage timed by the host clock around a
    synchronize on both sides.  Nested stages (a kernel inside the line
    scan) count inside their parent too."""
    from ntsc_crt_tpu_torch.models import demodulate as dem
    mods = kernel_modules()
    names = [(pipeline, "modulate")] + [(mods[n][0], n) for n in mods] + [
        (dem, n) for n in ("_inject_noise", "_inject_noise_vhs",
                           "_find_vsync", "_line_scan", "_place_rows")]
    times = {}

    def timed(name, fn_):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn_(*a, **k)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3
            return out
        return run

    with patched(names, timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times["step"] = (time.perf_counter() - t0) * 1e3
    return times


def profile_step(fn):
    """(device operations, of which kernels, device busy ms, wall ms, the
    eight torch ops with the most host time) of one call of fn() under
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
    return len(evs), len(kernels), busy / 1e3, wall, top


def phase_path(pipeline, cfg, kw, needed, card, dev):
    """One main path at batch 1 and 512; returns the launch counts."""
    mods = kernel_modules()
    rng = np.random.default_rng(1234)
    img1 = torch.as_tensor(rng.integers(0, 256, (1, OUTH, OUTW, 3),
                                        dtype=np.uint8), device=dev)
    B = 512
    imgsB = torch.as_tensor(rng.integers(0, 256, (B, 240, 320, 3),
                                         dtype=np.uint8), device=dev)
    for mod, _, _ in mods.values():
        mod.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    ms1, prev1, args1, st1, n1 = run_main_path(pipeline, cfg, 1, img1, 30,
                                               dev, kw)
    mem1 = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    msB, prevB, argsB, stB, nB = run_main_path(pipeline, cfg, B, imgsB, 5,
                                               dev, kw)
    memB = torch.cuda.max_memory_allocated(dev)
    launches = {name: mods[name][0].LAUNCHES for name in mods}
    print(f"{cfg.name} main path, {n1 + nB} steps: launches {launches}",
          flush=True)
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise SystemExit(f"{cfg.name} main path never launched {missing}")
    for k, st in (("batch 1", st1), (f"batch {B}", stB)):
        if tuple(st.out.shape[1:]) != (OUTH, OUTW, 3) or \
                st.out.dtype != torch.uint8:
            raise SystemExit(f"{cfg.name} {k}: bad output "
                             f"{tuple(st.out.shape)}")
    check_against_cpu(pipeline, cfg, prev1, img1, args1, st1, 1, kw)
    check_against_cpu(pipeline, cfg, prevB, imgsB, argsB, stB, 2, kw)
    print(f"{cfg.name} main path: last step equals the CPU plain path "
          "(batch 1; slots 0-1 of batch 512)")
    for b, ms, mem in ((1, ms1, mem1), (B, msB, memB)):
        print(f"{cfg.name} 640x480 batch {b}: {ms / b:.4f} ms/frame, "
              f"{b * 1e3 / ms:.2f} frames/s, {ms:.3f} ms/step, peak "
              f"{mem / 2**20:.1f} MiB allocated  [{card}]", flush=True)

    for b, st, imgs in ((1, st1, img1), (B, stB, imgsB)):
        def one():
            pipeline.step_batch(cfg, st, imgs, *path_args(b, 0, dev),
                                noise=12, **kw)
        t = stage_times(pipeline, one)
        print(f"{cfg.name} stages batch {b} (ms, host clock, synchronized): "
              + ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)
        ops, kern, busy, wall, top = profile_step(one)
        print(f"{cfg.name} profiled step batch {b}: {ops} device operations "
              f"({kern} kernels), device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall  [{card}]; most host time (ms): {top}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from ntsc_crt_tpu_torch.models import pipeline, systems
    from ntsc_crt_tpu_torch.ops.kernels import build

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
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # 3. kernels vs plain versions
    table = phase_kernels(pipeline, systems, dev)

    # 4. goldens
    phase_goldens(pipeline, systems, dev)

    # 5. the main paths, each counted on its own
    ntsc_needed = ("encode_rows", "decode_rows", "hsync_chase", "ccf_ema")
    phase_path(pipeline, systems.NTSC, {}, ntsc_needed, card, dev)
    launches = phase_path(pipeline, systems.NTSCVHS, {"do_aberration": 1},
                          tuple(ORIGIN), card, dev)

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=ORIGIN[k][0], replaces=ORIGIN[k][1],
             launches=launches[k],
             max_abs_err=max(r["max_abs_err"] for r in table[k].values()),
             ms=table[k][64]["ms"], plain_ms=table[k][64]["plain_ms"],
             bound_ms=table[k][64]["bound_ms"],
             bound_by=table[k][64]["bound_by"], library_ms=None)
        for k in ORIGIN]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
