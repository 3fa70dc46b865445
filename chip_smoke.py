#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntsc_crt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build   — nvcc compiles ntsc_crt_tpu_torch/csrc/*.cu for sm_90a, one
   process per source, all started together.
3. kernels — each kernel against its plain torch version on the card, on the
   inputs the main paths hand it at batch 1 and 64 (640x480 output): K1
   encode_rows, K2 decode_rows (3-band), K3 hsync_chase and K6
   place_rows_uniform from an NTSC step; K2 in conv mode from an NTSC
   eq_mode="conv7" step; K2 in bloom mode and bloom_line_width from an NTSC
   do_bloom step; K4 ccf_ema and K5 vhs_region_b_entries from an NTSCVHS
   step.  Exact equality; each side's time from CUDA events; each kernel's
   bound from these inputs (see BOUNDS below).
4. goldens — tags NTSC, NTSC_b16, NTSCVHS, NTSCVHS_b16, NTSC_bloom and
   NTSC_conv7 of tests/fixtures/device_parity_goldens.npz replayed through
   step / step_batch on the card, bit-exact (NTSCVHS_b16: see
   JAX_VSYNC_PICK_SLOTS).
5. main paths — NTSC, NTSCVHS (do_aberration 1), NTSC with do_bloom and
   NTSC with eq_mode="conv7", each 640x480, noise 12, field/frame
   alternating: batch 1 from a 640x480 image (the live use) and batch 512
   from 320x240 images (the throughput use).  The launch counts are zeroed
   just before each path and read just after it: every kernel of the path
   must have launched, and none that the path must not run.  Each path's
   last step must equal the same step run on the CPU's plain path.  Then,
   for each path and batch, one step timed stage by stage (host clock
   around synchronized stages) and one step under torch.profiler (device
   launches and busy time).
6. variants — one batch-2 step each of fixed sync (do_vsync and do_hsync
   False: K3 must not launch) and of the NTSC_RAINBOW preset, held to the
   CPU's plain path.

BOUNDS: a kernel's bound is the larger of the bytes it must move (each input
read once, each output written once; of K6's previous frame only the rows
this data needs) over 3.35 TB/s and the int32 instructions it executes on
these inputs (counted from its source; where the work depends on the data,
what this data needs) over the card's INT32 instruction rate, 132 SMs x 64
lanes x 1.98 GHz (H100 SXM).  For the serial kernels (K3,
K4, K5, bloom_line_width) the dependent chain of the longest entry is also
priced at an assumed 4 cycles per dependent integer instruction and 260
cycles per dependent load that hits L2, at 1.98 GHz (`chain`).

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
    "decode_rows_conv": ("ntsc_crt_tpu_torch/csrc/decode.cu",
                         "ntsc_crt_tpu/ops/pallas/decode_fused.py:416"),
    "decode_rows_bloom": ("ntsc_crt_tpu_torch/csrc/decode.cu",
                          "ntsc_crt_tpu/ops/pallas/decode_fused.py:416"),
    # no Pallas kernel: the JAX decoder runs this chain as a lax.scan
    "bloom_line_width": ("ntsc_crt_tpu_torch/csrc/decode.cu",
                         "ntsc_crt_tpu/models/demodulate.py:886"),
    "hsync_chase": ("ntsc_crt_tpu_torch/csrc/hsync.cu",
                    "ntsc_crt_tpu/ops/pallas/hsync_scan.py:318"),
    "ccf_ema": ("ntsc_crt_tpu_torch/csrc/ccf.cu",
                "ntsc_crt_tpu/ops/pallas/ccf_scan.py:108"),
    "vhs_region_b_entries": ("ntsc_crt_tpu_torch/csrc/vhs.cu",
                             "ntsc_crt_tpu/ops/pallas/vhs_scan.py:98"),
    "place_rows_uniform": ("ntsc_crt_tpu_torch/csrc/place.cu",
                           "ntsc_crt_tpu/ops/pallas/place_rows.py:255"),
}
BLOOM = {"do_bloom": True}
CONV7 = {"eq_mode": "conv7"}
VHS_KW = {"do_aberration": 1}
FIXED_SYNC = {"do_vsync": False, "do_hsync": False}
KERNEL_BATCHES = (1, 64)   # the kernel phase's batch sizes; the JSON line
#                            reports the last
MAIN_BATCH = 512           # the main paths' throughput batch
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


def eq_ops(coefs) -> int:
    """int32 instructions of one sample's three EQ steps: 50 each for the
    3-band chain, a multiply and an add a tap plus the shift for the FIR."""
    return 3 * (2 * coefs[1] if coefs[0] == "conv" else 50)


def work_decode(a, k, out):
    """Per sample: Y/I/Q 5, the three EQs (eq_ops), output shifts 3; per
    pixel: lerp 17, YIQ->RGB, contrast and clamp 27 (csrc/decode.cu).  In
    bloom mode a row marches only to the last pixel's right source (this
    data's dx), picks its wave phase (6 a sample) and tracks its sources
    (10 a pixel)."""
    from ntsc_crt_tpu_torch.ops.kernels import decode
    B, L = a[1].shape
    outw, av = k["outw"], k["av_len"]
    per_sample = 8 + eq_ops(k["coefs"])
    if k.get("bloom_dx") is None:
        return (nbytes(*a, out), B * L * (av * per_sample + outw * 44), None)
    n_eq = decode.eq_len(av, a[2].shape[2])
    last = ((k["bloom_dx"].long() * (outw - 1)) >> 12).clamp(min=0)
    samples = int(((last + 1).clamp(max=n_eq - 1) + 1).sum())
    return (nbytes(*a, out, k["bloom_dx"], k["bloom_lidx"]),
            samples * (per_sample + 6) + B * L * outw * 54, None)


def work_line_width(a, k, out):
    """Per line: the drive term (subtract, shift, a division by max_e of
    about 20), the multiply, the truncating /128 (3) and the add — five of
    them on the chain, and the store."""
    sums, _ = a
    B, L = sums.shape
    return nbytes(*a, out), B * L * 30, L * 5 * DEP_CYCLES


def work_place(a, k, out):
    """Per 16-byte chunk: the row's source picks and the keep test (about
    30), the blend 16 over four words.  Bytes: the lines, the field bits,
    the output, and only the previous rows this data needs — those kept
    (scanline gaps, the odd field's clips) and, with blend, each group's
    beg row."""
    rgb, old, field_px = a
    ratio, fp, sl = k["ratio"], k["fp"], k["scanlines"]
    B, L = rgb.shape[:2]
    fb = (field_px > 0).cpu()[:, None]                    # (B, 1)
    r = torch.arange(ratio * L)
    kk, j = r // ratio, r % ratio
    keep = torch.where(fb, (j - fp) % ratio, j) >= ratio - sl
    if fp:
        keep |= (j < fp) & (kk == 0) & fb
        keep |= (j > fp) & (j >= ratio - sl) & (kk == L - 1) & fb
    need = keep.clone()
    if k["blend"]:
        src = torch.where(fb & (j < fp), (kk - 1).clamp(min=0), kk)
        beg = ratio * src + torch.where(fb, fp, 0)
        need.scatter_(1, torch.where(keep, r, beg), True)
    old_bytes = int(need.sum()) * old[0, 0].numel()
    n = out.numel() // 16
    return (nbytes(rgb, field_px, out) + old_bytes,
            n * (30 + (16 if k["blend"] else 0)), None)


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


class Kernel:
    """One kernel: its wrapper (module attribute `wrapper`), launch counter
    (module attribute `counter`), plain version and work counter."""

    def __init__(self, mod, wrapper, counter, plain, work):
        self.mod, self.wrapper, self.counter = mod, wrapper, counter
        self.plain, self.work = plain, work

    @property
    def launches(self) -> int:
        return getattr(self.mod, self.counter)

    def reset(self) -> None:
        setattr(self.mod, self.counter, 0)


def kernel_modules():
    """name -> Kernel, for every kernel of ORIGIN."""
    from ntsc_crt_tpu_torch.ops.kernels import (ccf, decode, encode, hsync,
                                                place, vhs)
    dec = lambda counter: Kernel(decode, "decode_rows", counter,  # noqa: E731
                                 decode.decode_rows_plain, work_decode)
    return {
        "encode_rows": Kernel(encode, "encode_rows", "LAUNCHES",
                              encode.encode_rows_plain, work_encode),
        "decode_rows": dec("LAUNCHES"),
        "decode_rows_conv": dec("CONV_LAUNCHES"),
        "decode_rows_bloom": dec("BLOOM_LAUNCHES"),
        "bloom_line_width": Kernel(decode, "bloom_line_width",
                                   "LINE_WIDTH_LAUNCHES",
                                   decode.bloom_line_width_plain,
                                   work_line_width),
        "hsync_chase": Kernel(hsync, "hsync_chase", "LAUNCHES",
                              hsync.hsync_chase_plain, work_hsync),
        "ccf_ema": Kernel(ccf, "ccf_ema", "LAUNCHES", ccf.ccf_ema_plain,
                          work_ccf),
        "vhs_region_b_entries": Kernel(vhs, "vhs_region_b_entries",
                                       "LAUNCHES",
                                       vhs.vhs_region_b_entries_plain,
                                       work_vhs),
        "place_rows_uniform": Kernel(place, "place_rows_uniform", "LAUNCHES",
                                     place.place_rows_uniform_plain,
                                     work_place)}


def path_args(B, i, dev):
    """(fields, frames, dot-crawl offsets) of step i: alternating per slot."""
    slot = torch.arange(B, dtype=torch.int32, device=dev)
    return ((slot + i) % 2, ((slot + i) >> 1) % 2,
            torch.zeros(B, dtype=torch.int32, device=dev))


def capture_kernel_inputs(pipeline, cfg, B, names, dev, kw):
    """The arguments each named kernel's wrapper receives on the second
    step of a batch-B run (a locked, non-trivial state)."""
    mods = kernel_modules()
    rng = np.random.default_rng(B)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, 240, 320, 3),
                                        dtype=np.uint8), device=dev)
    st = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    st = pipeline.step_batch(cfg, st, imgs, *path_args(B, 0, dev), noise=12,
                             **kw)
    seen = {}

    def record(wrapper, fn):
        def rec(*a, **k):
            seen[wrapper] = (a, k)
            return fn(*a, **k)
        return rec

    targets = {(mods[n].mod, mods[n].wrapper) for n in names}
    with patched(sorted(targets, key=lambda t: t[1]), record):
        pipeline.step_batch(cfg, st, imgs, *path_args(B, 1, dev), noise=12,
                            **kw)
    return {n: seen[mods[n].wrapper] for n in names}


def phase_kernels(pipeline, systems, dev):
    """Each kernel vs its plain version at batch 1 and 64.  Returns
    {name: {B: row}}."""
    mods = kernel_modules()
    groups = ((systems.NTSC, ("encode_rows", "decode_rows", "hsync_chase",
                              "place_rows_uniform"), {}),
              (systems.NTSC, ("decode_rows_conv",), CONV7),
              (systems.NTSC, ("decode_rows_bloom", "bloom_line_width"),
               BLOOM),
              (systems.NTSCVHS, ("ccf_ema", "vhs_region_b_entries"), VHS_KW))
    rows = {name: {} for name in mods}
    for cfg, names, kw in groups:
        for B in KERNEL_BATCHES:
            seen = capture_kernel_inputs(pipeline, cfg, B, names, dev, kw)
            for name in names:
                mod, plain, work = mods[name].mod, mods[name].plain, \
                    mods[name].work
                kern = getattr(mod, mods[name].wrapper)
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


def golden_run(pipeline, cfg, B, dev, kw):
    """The recipe of bench.py:198-235: two 320x240 frames at 128x96 (B = 1,
    unbatched state) or sixteen 80x60 slots through step_batch, noise 7;
    the second step toggles field/frame; kw: the tag's build variant."""
    if B == 1:
        img = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3),
                                               np.uint8)[0]
        st = pipeline.crt_init(cfg, 128, 96, device=dev)
        for f in (0, 1):
            st = pipeline.step(cfg, st, torch.as_tensor(img, device=dev),
                               field=f, frame=f, noise=7, **kw)
        return st
    imgs = torch.as_tensor(np.random.RandomState(0).randint(
        0, 256, (B, 60, 80, 3), np.uint8), device=dev)
    st = pipeline.init_batch(cfg, B, 128, 96, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    alt = torch.arange(B, dtype=torch.int32, device=dev) % 2
    st = pipeline.step_batch(cfg, st, imgs, zeros, zeros, zeros, noise=7,
                             **kw)
    return pipeline.step_batch(cfg, st, imgs, alt, alt, zeros, noise=7, **kw)


def phase_goldens(pipeline, systems, dev):
    ref = np.load(GOLDENS)
    runs = (("NTSC", systems.NTSC, 1, {}),
            ("NTSC_b16", systems.NTSC, 16, {}),
            ("NTSCVHS", systems.NTSCVHS, 1, {}),
            ("NTSCVHS_b16", systems.NTSCVHS, 16, {}),
            ("NTSC_bloom", systems.NTSC, 1, BLOOM),
            ("NTSC_conv7", systems.NTSC, 1, CONV7))
    for tag, cfg, B, kw in runs:
        st = golden_run(pipeline, cfg, B, dev, kw)
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
            cpu = golden_run(pipeline, cfg, B, torch.device("cpu"), kw)
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
    wrappers = {(k.mod, k.wrapper) for k in kernel_modules().values()}
    names = [(pipeline, "modulate")] + sorted(wrappers,
                                              key=lambda t: t[1]) + [
        (dem, n) for n in ("_inject_noise", "_inject_noise_vhs",
                           "_find_vsync", "_line_scan", "_bloom_lines",
                           "_place_rows")]
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


def counted(label, needed, run):
    """run() with every launch count zeroed just before it and read just
    after; fails unless each kernel of `needed` launched and no other did.
    Returns (the counts, run's result)."""
    mods = kernel_modules()
    for k in mods.values():
        k.reset()
    result = run()
    launches = {name: k.launches for name, k in mods.items()}
    print(f"{label}: launches {launches}", flush=True)
    missing = [k for k in needed if launches[k] == 0]
    extra = [k for k, n in launches.items() if n and k not in needed]
    if missing or extra:
        raise SystemExit(f"{label}: never launched {missing}, launched "
                         f"{extra} that it must not run")
    return launches, result


def path_label(cfg, kw):
    return " ".join([cfg.name, *(f"{k}={v}" for k, v in kw.items())])


def phase_path(pipeline, cfg, kw, needed, card, dev, steps1=30, stepsB=5):
    """One main path at batch 1 and 512; returns the launch counts."""
    rng = np.random.default_rng(1234)
    img1 = torch.as_tensor(rng.integers(0, 256, (1, OUTH, OUTW, 3),
                                        dtype=np.uint8), device=dev)
    B = MAIN_BATCH
    imgsB = torch.as_tensor(rng.integers(0, 256, (B, 240, 320, 3),
                                         dtype=np.uint8), device=dev)
    label = path_label(cfg, kw)
    mem = []

    def both():
        torch.cuda.reset_peak_memory_stats(dev)
        r1 = run_main_path(pipeline, cfg, 1, img1, steps1, dev, kw)
        mem.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        rB = run_main_path(pipeline, cfg, B, imgsB, stepsB, dev, kw)
        mem.append(torch.cuda.max_memory_allocated(dev))
        return r1, rB

    launches, (r1, rB) = counted(
        f"{label} main path, {steps1 + stepsB + 4} steps", needed, both)
    (ms1, prev1, args1, st1, _), (msB, prevB, argsB, stB, _) = r1, rB
    for k, st in (("batch 1", st1), (f"batch {B}", stB)):
        if tuple(st.out.shape[1:]) != (OUTH, OUTW, 3) or \
                st.out.dtype != torch.uint8:
            raise SystemExit(f"{label} {k}: bad output "
                             f"{tuple(st.out.shape)}")
    check_against_cpu(pipeline, cfg, prev1, img1, args1, st1, 1, kw)
    check_against_cpu(pipeline, cfg, prevB, imgsB, argsB, stB, 2, kw)
    print(f"{label} main path: last step equals the CPU plain path "
          f"(batch 1; slots 0-1 of batch {B})")
    for b, ms, m in ((1, ms1, mem[0]), (B, msB, mem[1])):
        print(f"{label} 640x480 batch {b}: {ms / b:.4f} ms/frame, "
              f"{b * 1e3 / ms:.2f} frames/s, {ms:.3f} ms/step, peak "
              f"{m / 2**20:.1f} MiB allocated  [{card}]", flush=True)

    for b, st, imgs in ((1, st1, img1), (B, stB, imgsB)):
        def one():
            pipeline.step_batch(cfg, st, imgs, *path_args(b, 0, dev),
                                noise=12, **kw)
        t = stage_times(pipeline, one)
        print(f"{label} stages batch {b} (ms, host clock, synchronized): "
              + ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)
        ops, kern, busy, wall, top = profile_step(one)
        print(f"{label} profiled step batch {b}: {ops} device operations "
              f"({kern} kernels), device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall  [{card}]; most host time (ms): {top}", flush=True)
    return launches


def phase_variant(pipeline, cfg, kw, needed, dev):
    """One batch-2 step at 640x480 from a stepped state, counted, and held
    to the CPU's plain path."""
    B = 2
    imgs = torch.as_tensor(np.random.default_rng(7).integers(
        0, 256, (B, 240, 320, 3), dtype=np.uint8), device=dev)
    st = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    st = pipeline.step_batch(cfg, st, imgs, *path_args(B, 0, dev), noise=12,
                             **kw)
    args = path_args(B, 1, dev)
    label = f"{path_label(cfg, kw)} step"
    _, got = counted(label, needed, lambda: pipeline.step_batch(
        cfg, st, imgs, *args, noise=12, **kw))
    check_against_cpu(pipeline, cfg, st, imgs, args, got, B, kw)
    print(f"{label}: equals the CPU plain path (batch {B})", flush=True)


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

    # 5. the main paths, each counted on its own; a kernel's launches are
    # its counts summed over the paths
    common = ("encode_rows", "hsync_chase", "ccf_ema")
    paths = ((systems.NTSC, {}, common + ("decode_rows", "place_rows_uniform")),
             (systems.NTSCVHS, VHS_KW,
              common + ("decode_rows", "place_rows_uniform",
                        "vhs_region_b_entries")),
             (systems.NTSC, BLOOM,
              common + ("decode_rows_bloom", "bloom_line_width")),
             (systems.NTSC, CONV7,
              common + ("decode_rows_conv", "place_rows_uniform")))
    launches = dict.fromkeys(ORIGIN, 0)
    for cfg, kw, needed in paths:
        for k, n in phase_path(pipeline, cfg, kw, needed, card, dev).items():
            launches[k] += n

    # 6. the other variants: one step each
    phase_variant(pipeline, systems.NTSC, FIXED_SYNC,
                  ("encode_rows", "ccf_ema", "decode_rows",
                   "place_rows_uniform"), dev)
    phase_variant(pipeline, systems.NTSC_RAINBOW, {},
                  common + ("decode_rows", "place_rows_uniform"), dev)

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=ORIGIN[k][0], replaces=ORIGIN[k][1],
             launches=launches[k],
             max_abs_err=max(r["max_abs_err"] for r in table[k].values()),
             ms=table[k][KERNEL_BATCHES[-1]]["ms"],
             plain_ms=table[k][KERNEL_BATCHES[-1]]["plain_ms"],
             bound_ms=table[k][KERNEL_BATCHES[-1]]["bound_ms"],
             bound_by=table[k][KERNEL_BATCHES[-1]]["bound_by"],
             library_ms=None)
        for k in ORIGIN]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
