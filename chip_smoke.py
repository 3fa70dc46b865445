#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntsc_crt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build   — nvcc compiles ntsc_crt_tpu_torch/csrc/*.cu for sm_90a, one
   process per source, all started together.
3. op paths — the entry points of K7-K10, counted like the main paths (the
   counts zeroed just before, read just after, each kernel must launch):
   ops.filters.iir_lowpass on the NTSC encode's Y/I/Q rows (K7), the
   unfused decode chain scanconv.decode_rows_unfused on the NTSC decode's
   K2 inputs (K8 through ops.filters.eq_threeband, then K9), held to K2 at
   0 LSB, and the issue-rate probe's report (K10, what `python -m
   ntsc_crt_tpu_torch.ops.kernels.probe` prints).  The probe measures the
   cycles per dependent op that prices every chain below.
4. kernels — each kernel against its plain torch version on the card, on the
   inputs the paths hand it at batch 1 and 64 (640x480 output): K1
   encode_rows, K2 decode_rows (3-band), K3 hsync_chase, K4 ccf_ema and K6
   place_rows_uniform from an NTSC step; K2 in conv mode from an NTSC
   eq_mode="conv7" step; K2 in bloom mode and bloom_line_width from an NTSC
   do_bloom step; K4 ccf_ema and K5 vhs_region_b_entries from an NTSCVHS
   step; K1 with a carrier table a row, K2 on 5-sample chroma at 1920-sample
   lines, K3 and K4 (VP 5) from a PV1K step; K1 and K4 (VP 3) from a SNES
   step; K7 on the Y/I/Q rows of the NTSC and PV1K K1 inputs; K8 on the
   NTSC K2 inputs' Y/I/Q rows, K9 on K8's output, and the unfused chain
   against K2; K3 and K4 also at batch 512 on NTSC's and PV1K's inputs, K5
   on NTSCVHS's, bloom_line_width (its line sums included) on the bloom
   path's, K7 on NTSC's and PV1K's rows and K8 on NTSC's; K10's three
   patterns at the TPU probe's size.  Exact equality; each side's time from
   CUDA events (the kernel's also with its calls queued behind a spin
   kernel, see cuda_ms); each kernel's bound from these inputs (see BOUNDS
   below); beside K7's and K8's, the time of a device copy of their rows
   (y.copy_(x), behind the spin): the bytes' reachable floor.  Then K1-K5,
   bloom_line_width, K7 and K8 at small ragged shapes and edges
   (ragged_cases: partial warps and tiles, shifts before 0 and past H,
   every K2 mode, bloom rows that restart or meet the forced-zero sample;
   K3 estimates that wrap across H both ways, windows from below 0 and past
   the rows, W 6, 8 and 16, at batch 5 and 512; K4 at m 16, VP 5, CC 5 over
   ragged chunks and at one line; K5 at H 1, 7, 40 and 910 with bands cut
   short and steps past 19H from the seeds 0 and 2**32 - 1;
   bloom_line_width's windows from below 0, spilling, past 2H and wrapping
   int32, with max_e 0, -1 and 96256, rows whose chunks straddle the
   tensor's end, L past one 256-line pass; K7 and K8 at 1-65 rows and
   1-1487 samples around their lines and ring, every T mod 4, x on and off
   y's line grid, on full-range samples).  Then one NTSC batch-1 step under
   torch.cuda.set_sync_debug_mode: a synchronizing op inside the line scan
   fails the run, any outside is reported with its source line.
5. goldens — all 11 tags of tests/fixtures/device_parity_goldens.npz (NTSC,
   NTSC_b16, NTSCVHS, NTSCVHS_b16, NTSC_bloom, NTSC_conv7, PV1K, PV1K_b16,
   NES, SNES, NESRGB) replayed through step / step_batch on the card,
   bit-exact (NTSCVHS_b16: see JAX_VSYNC_PICK_SLOTS).
6. main paths — NTSC, NTSCVHS (do_aberration 1), NTSC with do_bloom, NTSC
   with eq_mode="conv7", PV1K and NES, each at 640x480 output, noise 12,
   field/frame and dot crawl changing per slot and step: batch 1 from a
   640x480 image (the live use) and batch 512 from 320x240 images (the
   throughput use); NES from 256x240 PPU pixels at both.  The launch counts
   are zeroed just before each path and read just after it: every kernel of
   the path must have launched, and none that the path must not run (K7-K10
   run on no pipeline path).  Each path's last step must equal the same
   step run on the CPU's plain path.  Then, for each path and batch, one
   step timed stage by stage (host clock around synchronized stages) and
   one step under torch.profiler (device launches and busy time, and each
   of the port's kernels' device time and launches in that step); at batch
   512 also the line scan's device operations (the rolled4 row select, the
   rows2 concatenation, the burst gather, K3, K4), each with its device
   time.
7. variants — one batch-2 step each of fixed sync (do_vsync and do_hsync
   False: K3 must not launch), NTSC_RAINBOW, SNES, TEMPLATE and NESRGB,
   held to the CPU's plain path.

BOUNDS: a kernel's bound is the larger of the bytes it must move (each input
read once, each output written once; of K6's previous frame only the rows
this data needs) over 3.35 TB/s and the int32 instructions it executes on
these inputs (source ops counted from its source; where the work depends on
the data, what this data needs) over the card's int32 source-op rate: the
probe's `peak` rate measured in phase 3 of this run at the full-card size (a
source op is often less than one SASS instruction, so this is above the
issue ceiling of 132 SMs x 128 lanes x clock; the data sheet gives no int32
rate).  For the serial kernels (K1, K2, K3, K4, K5, bloom_line_width, K7,
K8, K10) the dependent chain of the longest entry is also priced
(`chain`): the cycles per dependent source op that the probe measured in
this run (eq1, one warp a scheduler), 260 cycles per dependent load that
hits L2 (assumed), at the SM clock read during the probe; K5's line also
prices the parent design's chain (a thread's eight ops a step).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Every number is measured in this run.
"""

import contextlib
import json
import subprocess
import sys
import time
import warnings
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
    # no Pallas kernel: the JAX decoder forms the line sums and runs this
    # chain as a lax.scan
    "bloom_line_width": ("ntsc_crt_tpu_torch/csrc/bloom.cu",
                         "ntsc_crt_tpu/models/demodulate.py:886"),
    "hsync_chase": ("ntsc_crt_tpu_torch/csrc/hsync.cu",
                    "ntsc_crt_tpu/ops/pallas/hsync_scan.py:318"),
    "ccf_ema": ("ntsc_crt_tpu_torch/csrc/ccf.cu",
                "ntsc_crt_tpu/ops/pallas/ccf_scan.py:108"),
    "vhs_region_b_entries": ("ntsc_crt_tpu_torch/csrc/vhs.cu",
                             "ntsc_crt_tpu/ops/pallas/vhs_scan.py:98"),
    "place_rows_uniform": ("ntsc_crt_tpu_torch/csrc/place.cu",
                           "ntsc_crt_tpu/ops/pallas/place_rows.py:255"),
    "iir_lowpass_rows": ("ntsc_crt_tpu_torch/csrc/rowfilters.cu",
                         "ntsc_crt_tpu/ops/pallas/filters_pallas.py:173"),
    "eq_threeband_rows": ("ntsc_crt_tpu_torch/csrc/rowfilters.cu",
                          "ntsc_crt_tpu/ops/pallas/filters_pallas.py:163"),
    "scanconv_rows": ("ntsc_crt_tpu_torch/csrc/scanconv.cu",
                      "ntsc_crt_tpu/ops/pallas/scanconv_pallas.py:51"),
    "probe": ("ntsc_crt_tpu_torch/csrc/probe.cu",
              "ntsc_crt_tpu/ops/pallas/vpu_probe.py:101"),
}
BLOOM = {"do_bloom": True}
CONV7 = {"eq_mode": "conv7"}
VHS_KW = {"do_aberration": 1}
FIXED_SYNC = {"do_vsync": False, "do_hsync": False}
KERNEL_BATCHES = (1, 64)   # the kernel phase's batch sizes; the JSON line
#                            reports the last
MAIN_BATCH = 512           # the main paths' throughput batch
PROBE_BLOCKS, PROBE_ITERS = 64, 4096   # the TPU probe's default size
# Slots of the NTSCVHS_b16 golden that hold the JAX package's cross-slot
# vsync pick (its demodulate.py:295 broadcasts the pick to (B, B) and takes
# every slot's line from slot 0's candidates).  The port decodes each slot
# on its own; those slots are held against the port's CPU plain path, which
# tests/test_torch_vhs.py holds against the JAX step run on the slot alone.
JAX_VSYNC_PICK_SLOTS = {"NTSCVHS_b16": [5]}

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3, NVIDIA data sheet
LOAD_CYCLES = 260                    # assumed: one dependent load from L2
# measured by the probe in phase 3 of this run: cycles per dependent source
# op, the SM clock (Hz) read meanwhile, and the peak int32 source-op rate
MEASURED = {"dep_cycles": None, "sm_hz": None, "int32_per_s": None}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, spin: bool = False) -> float:
    """Mean time of fn() over `reps` calls between two CUDA events, after
    one warm-up.  spin=False times the calls as the host issues them (the
    JSON line's `ms`): a kernel shorter than one call's host time reads the
    host's rate of launching it.  spin=True queues the calls behind a spin
    kernel that outlasts their host time, so the device runs them back to
    back and the time is the card's (a call that waits on the device still
    counts the host's time after the wait)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # the spin: the warm-up's time with its device work for every call,
    # plus 1 ms, at most 50 ms (beyond that the host's share is small)
    spin_s = min(reps * (time.perf_counter() - t0) + 1e-3, 0.05)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(spin_s * (MEASURED["sm_hz"] or 2e9)))
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


def dep() -> float:
    """Cycles per dependent source op, as the probe measured it."""
    if MEASURED["dep_cycles"] is None:
        raise SystemExit("chain priced before the probe measured it")
    return MEASURED["dep_cycles"]


def work_encode(a, k, out):
    """Per sample: resample index 2, RGB->YIQ 18, IIR 12, carrier 4, IRE 5,
    clamp 2 (csrc/encode.cu).  Chain: a row's IIR, 4 dependent ops a sample
    (as K7's); without bandlimiting, one sample's depth (YIQ 3, carrier 2,
    IRE 4, clamp 2)."""
    band = k["coefs"] is not None
    chain = (4 * out.shape[2] if band else 11) * dep()
    return nbytes(*a, out), out.numel() * (43 if band else 31), chain


def eq_ops(coefs) -> int:
    """int32 instructions of one sample's three EQ steps: 50 each for the
    3-band chain, a multiply and an add a tap plus the shift for the FIR."""
    return 3 * (2 * coefs[1] if coefs[0] == "conv" else 50)


def work_decode(a, k, out):
    """Per sample: Y/I/Q 5, the three EQs (eq_ops), output shifts 3; per
    pixel: lerp 17, YIQ->RGB, contrast and clamp 27 (csrc/decode.cu).  In
    bloom mode a row marches only to the last pixel's right source (this
    data's dx), picks its wave phase (6 a sample) and tracks its sources
    (10 a pixel).  Chain: a row's 3-band EQ, 5 dependent ops a sample plus
    the 25 of the first output (as K8's), over av samples or, in bloom
    mode, the longest row's march; the FIR has no recurrence, so its chain
    is one sample's depth: demodulation 2, the FIR taps + 1, the output
    shift 1, the lerp 3, YIQ->RGB 3, contrast and clamp 5."""
    from ntsc_crt_tpu_torch.ops.kernels import decode
    B, L = a[1].shape
    outw, av = k["outw"], k["av_len"]
    per_sample = 8 + eq_ops(k["coefs"])
    conv = k["coefs"][0] == "conv"
    chain = lambda n: (k["coefs"][1] + 15 if conv  # noqa: E731
                       else 5 * n + 25) * dep()
    if k.get("bloom_dx") is None:
        return (nbytes(*a, out), B * L * (av * per_sample + outw * 44),
                chain(av))
    n_eq = decode.eq_len(av, a[2].shape[2])
    last = ((k["bloom_dx"].long() * (outw - 1)) >> 12).clamp(min=0)
    march = (last + 1).clamp(max=n_eq - 1) + 1
    return (nbytes(*a, out, k["bloom_dx"], k["bloom_lidx"]),
            int(march.sum()) * (per_sample + 6) + B * L * outw * 54,
            chain(int(march.max())))


def line_window_bytes(H, xpos, av):
    """The row bytes the lines' windows need: line l reads its row over
    [max(xpos, 0), min(xpos + av, H)) and the next row over [0, xpos + av -
    H) clipped to [0, H) (int32 wrap, as the kernel); a row counts the union
    of its own window and the spill into it once."""
    x = xpos.long()
    end = (x + av + 2**31) % 2**32 - 2**31                # int32 wrap
    a0 = x.clamp(min=0)
    a1 = torch.maximum(end.clamp(max=H), a0)
    spill = (end - H).clamp(0, H)
    prev = torch.cat([torch.zeros_like(spill[:, :1]), spill[:, :-1]], dim=1)
    both = (torch.minimum(a1, prev) - a0).clamp(min=0)    # window ∩ spill
    return int((a1 - a0 + prev - both).sum() + spill[:, -1].sum())


def work_line_width(a, k, out):
    """Bytes: the rows' bytes the windows need (line_window_bytes), xpos,
    max_e, the output.  Ops: a dp4a and a mask select a window word; per
    line the ranges 12, the warp reduction, the drive (subtract, shift, a
    division by max_e of about 20) and the chain's 5 (the multiply, the
    truncating /128 as three, the add).  Chain: the EMA's 5 a line, after
    the L / 16 lines its warp sums one after another (csrc/bloom.cu's 16
    warps a frame), each a load's latency."""
    rows, xpos, max_e = a
    B, L = xpos.shape
    win = line_window_bytes(rows.shape[2], xpos, k["av_len"])
    ops = (win // 4) * 2 + B * L * 40
    chain = L * 5 * dep() + -(-L // 16) * LOAD_CYCLES
    return win + nbytes(xpos, max_e, out), ops, chain


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
    """Bytes: the samples each active line's search needs, up to its first
    crossing (the kernel also stages each line's look-ahead span, which the
    function does not need), the flags, hsync0 and the output.  Ops: an add
    and a compare a probed sample, 6 a line.  Chain: 15 dependent ops an
    active line in csrc/hsync.cu (the window's offset 3, a shuffle, the
    funnel, two dp4a and their sum, the compare, the warp min, the move 2,
    the wrap 2, the flag), the load off it; a shuffle and the warp min take
    longer than the probe's dependent op."""
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
    probed = int(torch.where(active, probes, 0).sum())
    chain = int(active.sum(1).max()) * 15 * dep()
    return (probed + nbytes(active, h0, out),
            probed * 2 + probes.numel() * 6, chain)


def work_ccf(a, k, out):
    """Per fold step: the multiply, three for the truncating /128, the add;
    per line and class 4 (row select, activity select, write).  Chain: four
    a step (csrc/ccf.cu's SASS: IMAD, SHF, LEA.HI, LEA.HI.SX32 with the
    add) on each active line, and the first product and two selects on
    each line."""
    per_cls, vper, active, ccf0 = a
    B, L, m, CC = per_cls.shape
    act = active.sum(1)
    ops = int(act.sum()) * m * CC * 5 + B * L * CC * 4
    chain = (int(act.max()) * m * 4 + L * 3) * dep()
    return nbytes(*a, *out), ops, chain


def work_vhs(a, k, out):
    """Per step: two multiply-adds, shift, the % 20 as multiply-high, shift
    and multiply-subtract, the test's multiply-add, compare, select, store —
    ten, the function's own work whatever the design.  Chain (csrc/vhs.cu):
    a batch of ten 32-position windows waits on 86 dependent ops — the x
    jumps 10, a draw and its ballot 5, the window pick 10, a walk's 16
    steps of 3, the ten shuffles and the next position 13 — and an entry
    takes (its positions) / 320 batches, plus a restart at each of the 19
    band ends; its positions are 2 a step plus its three-call steps, read
    off the entry states.  The parent's one-thread march priced eight a
    step: returned beside it."""
    from ntsc_crt_tpu_torch.ops.kernels import vhs
    B, n = out.shape
    u = out.long() & 0xFFFFFFFF
    three = ((u[:, :-1] * vhs.A2 + vhs.C2) & 0xFFFFFFFF) != u[:, 1:]
    positions = 2 * n + int(three.sum(1).max())
    return nbytes(*a, out), n * B * 10, (positions // 320 + 20) * 86 * dep(), \
        n * 8 * dep()


def work_iir(a, k, out):
    """Per sample: sub, mul, shift, add, all four on the row's chain."""
    x, c = a
    R, T = x.shape
    return nbytes(x, c, out), R * T * 4, T * 4 * dep()


def work_eq3(a, k, out):
    """Per sample the 50 ops of the chain (eq3.cuh); each pole's own
    recurrence is 5 a step and the 8 poles pipeline, so a row's chain is
    5 a sample plus the 25 of the first output."""
    x = a[0]
    R, T = x.shape
    return nbytes(*a, out), R * T * 50, (5 * T + 25) * dep()


def work_scanconv(a, k, out):
    """Per pixel: the source and weights 5, the tail test, three lerps of 5,
    three channels of 9 (YIQ->RGB, contrast, clamp), the pack 4."""
    return nbytes(*a, out), out.numel() * 52, None


def work_probe(a, k, out):
    """The source-counted ops of the pattern (probe.ops_per_iter); its
    chain: an EQ iteration's 27 (probe.EQ1_CHAIN_OPS), a peak stream's 4."""
    from ntsc_crt_tpu_torch.ops.kernels import probe
    x, pattern = a
    iters = k["iters"]
    per = probe.EQ1_CHAIN_OPS if pattern != "peak" else 4
    return (nbytes(x, out), x.numel() * iters * probe.ops_per_iter(pattern),
            iters * per * dep())


def bound(work):
    """(bound ms, "bytes" or "operations", chain ms or None, the parent
    design's chain ms or None) from a work counter's (bytes, ops, chain
    cycles[, the parent design's chain cycles])."""
    nb, ops, chain, old = (*work, None)[:4]
    t_bytes, t_ops = nb / HBM_BYTES_PER_S, ops / MEASURED["int32_per_s"]
    ms = lambda c: (None if c is None  # noqa: E731
                    else c / MEASURED["sm_hz"] * 1e3)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ms(chain), ms(old))


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
                                                place, probe, rowfilters,
                                                scanconv, vhs)
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
                                     work_place),
        "iir_lowpass_rows": Kernel(rowfilters, "iir_lowpass_rows",
                                   "IIR_LAUNCHES",
                                   rowfilters.iir_lowpass_rows_plain,
                                   work_iir),
        "eq_threeband_rows": Kernel(rowfilters, "eq_threeband_rows",
                                    "EQ_LAUNCHES",
                                    rowfilters.eq_threeband_rows_plain,
                                    work_eq3),
        "scanconv_rows": Kernel(scanconv, "scanconv_rows", "LAUNCHES",
                                scanconv.scanconv_rows_plain, work_scanconv),
        "probe": Kernel(probe, "probe", "LAUNCHES", probe.probe_plain,
                        work_probe)}


def path_args(B, i, dev):
    """(fields, frames, dot-crawl offsets) of step i: changing per slot."""
    slot = torch.arange(B, dtype=torch.int32, device=dev)
    return ((slot + i) % 2, ((slot + i) >> 1) % 2, (slot + i) % 3)


def frames_for(cfg, B, h, w, seed, dev):
    """Seeded input frames: uint8 RGB (B, h, w, 3), or for NES uint16 PPU
    pixels (B, 240, 256) whatever the size asked."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "nes":
        return torch.as_tensor(rng.integers(0, 512, (B, 240, 256),
                                            dtype=np.uint16), device=dev)
    return torch.as_tensor(rng.integers(0, 256, (B, h, w, 3),
                                        dtype=np.uint8), device=dev)


def capture_kernel_inputs(pipeline, cfg, B, names, dev, kw):
    """The arguments each named kernel's wrapper receives on the second
    step of a batch-B run (a locked, non-trivial state)."""
    mods = kernel_modules()
    imgs = frames_for(cfg, B, 240, 320, B, dev)
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


def k7_args(a, k):
    """K7's rows from K1's arguments: every picture row's Y/I/Q after the
    resample (crt_ntsc.c:296-310), (B * desth * 3, destw), each row with its
    channel's IIR coefficient."""
    from ntsc_crt_tpu_torch.ops.kernels import encode
    img, sy = a[0], a[1]
    B, w, dev = img.shape[0], img.shape[2], img.device
    destw, coefs = k["destw"], k["coefs"]
    sx = (torch.arange(destw, device=dev) * w) // destw
    bi = torch.arange(B, device=dev)[:, None, None]
    pix = img[bi, sy.long()[:, :, None], sx].to(torch.int32)
    yiq = torch.stack(encode.rgb_to_yiq(pix), dim=-2)      # (B, desth, 3, w)
    c = torch.tensor(coefs, dtype=torch.int32, device=dev)
    return yiq, c


def k8_args(a, k):
    """K8's rows from K2's arguments: every line's Y/I/Q EQ input,
    (B * L * 3, av_len), each row with its channel's coefficients."""
    from ntsc_crt_tpu_torch.ops.kernels import scanconv
    rows, shifts, waveI, waveQ, bright = a[:5]
    stacked = scanconv.demod_rows(rows, shifts, waveI, waveQ, bright,
                                  row0=k["row0"], av_len=k["av_len"])
    R = stacked.shape[0] * stacked.shape[1]
    cs = [torch.tensor([c[j] for c in k["coefs"]], dtype=torch.int32,
                       device=rows.device).repeat(R) for j in range(5)]
    return (stacked.reshape(-1, k["av_len"]).contiguous(), *cs), {}


def k7_rows(a, k):
    """K7's arguments from K1's (k7_args): the Y/I/Q stack as (R, destw)
    rows, each with its channel's coefficient."""
    yiq, c = k7_args(a, k)
    x = yiq.reshape(-1, yiq.shape[-1]).contiguous()
    return (x, c.repeat(x.shape[0] // 3)), {}


# kernels that no path hands arguments of its own: name -> (the kernel whose
# captured arguments they are derived from, the derivation)
DERIVED = {"iir_lowpass_rows": ("encode_rows", k7_rows),
           "eq_threeband_rows": ("decode_rows", k8_args)}


def kernel_inputs(pipeline, cfg, B, names, dev, kw):
    """capture_kernel_inputs, with K7's and K8's arguments derived from the
    K1 and K2 arguments of the same step (DERIVED)."""
    src = sorted({DERIVED[n][0] if n in DERIVED else n for n in names})
    seen = capture_kernel_inputs(pipeline, cfg, B, src, dev, kw)
    return {n: DERIVED[n][1](*seen[DERIVED[n][0]]) if n in DERIVED
            else seen[n] for n in names}


def k9_args(eqd, a, k):
    """K9's rows from K8's output and K2's arguments: oy = eq << 4, oi/oq =
    eq >> 3 (crt_core.c:540), (B * L, av_len) each."""
    av = k["av_len"]
    e = eqd.reshape(-1, 3, av)
    return ((e[:, 0] << 4).contiguous(), (e[:, 1] >> 3).contiguous(),
            (e[:, 2] >> 3).contiguous(), a[5].reshape(-1).contiguous()), \
        dict(outw=k["outw"])


def check_kernel(name, label, B, a, k, rows):
    """The kernel against its plain version on the same inputs at 0 LSB,
    both timed; records and prints the row; returns the kernel's result."""
    kd = kernel_modules()[name]
    kern = getattr(kd.mod, kd.wrapper)
    got, want = kern(*a, **k), kd.plain(*a, **k)
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    if [g.shape for g in got_t] != [w.shape for w in want_t]:
        raise SystemExit(f"{name} {label} batch {B}: kernel shapes differ")
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got_t, want_t))
    if err != 0:
        raise SystemExit(f"{name} {label} batch {B}: kernel differs from "
                         f"plain (max |err| {err})")
    ms = cuda_ms(lambda: kern(*a, **k), 20)
    spin_ms = cuda_ms(lambda: kern(*a, **k), 20, spin=True)
    plain_ms = cuda_ms(lambda: kd.plain(*a, **k), 1)
    bound_ms, bound_by, chain_ms, old_ms = bound(kd.work(a, k, got))
    chain = "" if chain_ms is None else f", chain {chain_ms:.4f} ms"
    if old_ms is not None:
        chain += f" (the parent design's {old_ms:.4f} ms)"
    if name in DERIVED:   # the row filters: a device copy of the same bytes
        buf = torch.empty_like(a[0])
        copy_ms = cuda_ms(lambda: buf.copy_(a[0]), 20, spin=True)
        chain += f", copy floor {copy_ms:.4f} ms"
    print(f"kernel {name} batch {B} ({label}) shapes "
          f"{[tuple(g.shape) for g in got_t]}: {ms:.4f} ms (behind a spin "
          f"{spin_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}){chain}, max |err| {err}",
          flush=True)
    rows.setdefault(name, {})[(label, B)] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by)
    return got


def phase_kernels(pipeline, systems, dev):
    """Each kernel vs its plain version at batch 1 and 64, on the inputs
    each path hands it.  Returns {name: {(label, B): row}}, a kernel's
    first label being the one its JSON row reports."""
    from ntsc_crt_tpu_torch.ops.kernels import probe, scanconv
    groups = ((systems.NTSC, ("encode_rows", "decode_rows", "hsync_chase",
                              "ccf_ema", "place_rows_uniform"), {}),
              (systems.NTSC, ("decode_rows_conv",), CONV7),
              (systems.NTSC, ("decode_rows_bloom", "bloom_line_width"),
               BLOOM),
              (systems.NTSCVHS, ("ccf_ema", "vhs_region_b_entries"), VHS_KW),
              (systems.PV1K, ("encode_rows", "decode_rows", "hsync_chase",
                              "ccf_ema"), {}),
              (systems.SNES, ("encode_rows", "ccf_ema"), {}))
    rows = {}
    for cfg, names, kw in groups:
        label = path_label(cfg, kw)
        for B in KERNEL_BATCHES:
            seen = capture_kernel_inputs(pipeline, cfg, B, names, dev, kw)
            got = {n: check_kernel(n, label, B, *seen[n], rows)
                   for n in names}
            if "encode_rows" in names and cfg.do_bandlimiting:
                check_kernel("iir_lowpass_rows", label, B,
                             *k7_rows(*seen["encode_rows"]), rows)
            if "decode_rows" in names and cfg.cc_samples == 4:
                a, k = seen["decode_rows"]
                eqd = check_kernel("eq_threeband_rows", label, B,
                                   *k8_args(a, k), rows)
                check_kernel("scanconv_rows", label, B, *k9_args(eqd, a, k),
                             rows)
                unfused = scanconv.decode_rows_unfused(*a, **k)
                if not torch.equal(unfused, got["decode_rows"]):
                    raise SystemExit(f"{label} batch {B}: the unfused chain "
                                     "(K8, K9) differs from K2")
                print(f"unfused chain K8 -> K9 batch {B} ({label}): equals "
                      "K2 at 0 LSB", flush=True)
    phase_scan_kernels(pipeline, systems, dev, (MAIN_BATCH,), rows)
    x = probe.probe_input(PROBE_BLOCKS, dev)
    for pattern in ("eq3", "eq1", "peak"):
        check_kernel("probe", pattern, PROBE_BLOCKS, (x, pattern),
                     dict(iters=PROBE_ITERS), rows)
    return rows


def phase_scan_kernels(pipeline, systems, dev, batches, rows):
    """K3 and K4 on the inputs NTSC's and PV1K's line scans hand them, K5 on
    NTSCVHS's noise inputs, bloom_line_width on the bloom path's, K7 on the
    Y/I/Q rows of NTSC's and PV1K's K1 inputs and K8 on NTSC's K2 inputs'
    (DERIVED), each against its plain version at each batch of `batches`,
    timed and bounded as in phase_kernels."""
    groups = ((systems.NTSC, ("hsync_chase", "ccf_ema"), {}),
              (systems.PV1K, ("hsync_chase", "ccf_ema"), {}),
              (systems.NTSCVHS, ("vhs_region_b_entries",), VHS_KW),
              (systems.NTSC, ("bloom_line_width",), BLOOM),
              (systems.NTSC, ("iir_lowpass_rows", "eq_threeband_rows"), {}),
              (systems.PV1K, ("iir_lowpass_rows",), {}))
    for cfg, names, kw in groups:
        for B in batches:
            seen = kernel_inputs(pipeline, cfg, B, names, dev, kw)
            for n in names:
                check_kernel(n, path_label(cfg, kw), B, *seen[n], rows)


# (L, HP, H, W, c0, far) of K3 inputs whose estimate walks across H both
# ways: windows inside the rows, from below 0, past HP, W at the kernel's
# limit, and its one-lane path: estimates from outside [0, H) (hsync0 up to
# `far` lines of H off), W >= H (tests/test_torch_kernels.py K3_EDGES)
K3_EDGES = ((60, 128, 40, 8, 0, 0), (60, 128, 40, 6, 0, 0),
            (40, 128, 104, 8, 9, 0), (50, 48, 40, 8, -16, 0),
            (70, 30, 60, 6, -3, 0), (33, 200, 150, 16, 5, 0),
            (50, 64, 40, 8, 0, 3), (40, 64, 10, 12, 0, 0))
# (L, m, CC, VP) of K4 inputs: the kernel's limits over ragged chunks, SNES's
# rows, one line
K4_EDGES = ((37, 16, 5, 5), (240, 10, 4, 3), (1, 3, 2, 2))
# (H, n_steps) of K5 inputs: a band a step, the last band cut short by 5
# steps, 9 steps past 19H, NTSC's H cut short (as the CPU tests' K5_EDGES,
# tests/test_torch_kernels.py)
K5_EDGES = ((1, 19), (7, 19 * 7 - 5), (7, 19 * 7 + 9), (40, 19 * 40),
            (40, 19 * 40 - 5), (40, 19 * 40 + 9), (910, 19 * 910 - 5))
# (L, H, av, row0, extra rows) of bloom_line_width inputs: NTSC's rolled4,
# odd rows whose 16-byte chunks straddle rows and the tensor's end with L
# past the kernel's 256-line pass, windows wider than a row, one-byte rows
LINE_EDGES = ((240, 910, 753, 3, 3), (300, 61, 50, 1, 0), (7, 13, 30, 0, 0),
              (9, 1, 3, 0, 0))
# (R, T) of K7/K8 inputs at the edges of csrc/rowfilters.cu's ring (32 rows a
# warp, a 128-byte line of each a tile, 4 tiles a ring; 64-sample tiles in a
# design tried): one row, a warp short, full, one past, and two full warps
# and one past (a warp's first row shares a line with the last row of the
# warp before); a sample, short of, at and past one line, two, a ring and one
# past, NTSC's and PV1K's rows; every T mod 4 (tests/test_torch_kernels.py
# ROW_EDGES picks from this grid).  ROW_OFF_GRID: x one word off y's line
# grid, the kernels' 4-byte copy path.
ROW_EDGES = tuple((R, T) for R in (1, 31, 32, 33, 65)
                  for T in (1, 2, 31, 32, 33, 34, 63, 64, 65, 129, 257, 753,
                            1487))
ROW_OFF_GRID = ((1, 33), (33, 34), (65, 753), (70, 1487))


def ragged_cases(dev):
    """K1 and K2 inputs at shapes the paths never give, small: 111 rows (a
    warp's last 15 lanes idle), widths that are not multiples of a tile
    (K1's 64 or 60 samples, K2's 32 pixels) or of 4 bytes, an image wider
    than the line, shifts before 0 and past H, K2's conv4-conv7, and bloom
    rows whose source moves back (dx <= 0, or p*dx wrapping), clamps at
    n_eq - 1 or meets the forced-zero sample; K3 and K4 at their edges
    (K3_EDGES, K4_EDGES), K5 at small H, bands cut short and steps past 19H
    from the seeds 0 and 2**32 - 1 (K5_EDGES), bloom_line_width on windows
    from below 0, spilling, past 2H and wrapping, with max_e 0, -1 and
    96256 (LINE_EDGES); the last four at batch 5 and 512; K7 and K8 at the
    edges of their ring (ROW_EDGES) and with x off y's line grid
    (ROW_OFF_GRID), on full-range int32 samples, whose sums wrap.  Yields
    (kernel, label, args, kwargs)."""
    from ntsc_crt_tpu_torch.models import demodulate as dem
    from ntsc_crt_tpu_torch.models import systems
    from ntsc_crt_tpu_torch.ops import filters
    from ntsc_crt_tpu_torch.ops.kernels import decode
    rng = np.random.default_rng(5)
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v), device=dev)  # noqa
    i32 = lambda lo, hi, n: rng.integers(lo, hi, n).astype(np.int32)  # noqa
    ntsc = systems.NTSC
    iir = tuple(filters.init_iir(ntsc.l_freq, f)
                for f in (ntsc.y_freq, ntsc.i_freq, ntsc.q_freq))
    B, h, desth = 3, 29, 37
    for cc, w, destw, coefs in ((4, 20, 37, iir), (5, 1000, 753, iir),
                                (4, 320, 753, None), (4, 640, 640, iir)):
        a = (t(rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)),
             t(i32(0, h, (B, desth))), t(i32(-32, 33, (B, desth, cc))),
             t(i32(-32, 33, (B, desth, cc))), t(i32(50, 150, B)),
             t(i32(-20, 30, B)))
        yield ("encode_rows", f"cc {cc}, w {w}, destw {destw}"
               + ("" if coefs else ", no bandlimit"), a,
               dict(coefs=coefs, xo_mod=3 % cc, destw=destw))
    L, H, av, row0 = 37, 200, 150, 2
    three = dem._eq_coefs(ntsc)
    modes = ([("decode_rows", 4, three, 641), ("decode_rows", 5, three, 37),
              ("decode_rows", 4, three, 640)]
             + [("decode_rows_conv", 4, ("conv", taps), outw)
                for taps, outw in ((4, 641), (5, 37), (6, 640), (7, 641))]
             + [("decode_rows_bloom", 4, three, 641),
                ("decode_rows_bloom", 5, three, 37),
                ("decode_rows_bloom", 4, ("conv", 7), 640)])
    for name, cc, coefs, outw in modes:
        a = (t(rng.integers(-127, 128, (B, row0 + L + 1, H), dtype=np.int8)),
             t(i32(-40, 2 * H - 20, (B, L))),
             t(i32(-60000, 60000, (B, L, cc))),
             t(i32(-60000, 60000, (B, L, cc))), t(i32(-20, 20, (B, L))),
             t(i32(150, 200, (B, L))))
        k = dict(row0=row0, coefs=coefs, av_len=av, outw=outw)
        label = f"cc {cc}, outw {outw}" + (
            f", conv{coefs[1]}" if coefs[0] == "conv" else "")
        if name == "decode_rows_bloom":
            k.update({n: t(v) for n, v in
                      decode.bloom_steps(rng, B, L, av, outw, cc).items()})
        yield name, label, a, k
    for B in (5, MAIN_BATCH):  # 5: a part-full block of K3's four warps
        for L, HP, H, W, c0, far in K3_EDGES:
            kind = rng.integers(0, 4, (B, L))[..., None]
            cols = np.arange(HP)
            edge = rng.integers(0, HP, (B, L))[..., None]
            rows = rng.integers(-30, 60, (B, L, HP))
            rows = np.where((kind == 3) & (cols >= edge) & (cols < edge + 40),
                            -40, rows)
            rows = np.where(kind == 1, -100, np.where(kind == 2, 100, rows))
            act = rng.random((B, L)) > 0.2
            act[:, 5:15] = False
            yield ("hsync_chase", f"B {B}, L {L}, HP {HP}, H {H}, W {W}, "
                   f"c0 {c0}, hsync0 in [{-far * H}, {H + far * H})",
                   (t(rows.astype(np.int8)), t(act),
                    t(i32(-far * H, H + far * H, B))),
                   dict(W=W, c0=c0, thresh=-160, H=H))
        for L, m, cc, vp in K4_EDGES:
            lim = 1 << 30
            yield ("ccf_ema", f"B {B}, L {L}, m {m}, CC {cc}, VP {vp}",
                   (t(i32(-lim, lim, (B, L, m, cc))), t(i32(0, vp, (B, L))),
                    t(rng.random((B, L)) > 0.3),
                    t(i32(-lim, lim, (B, vp, cc)))), {})
        for H, n in K5_EDGES:
            st = rng.integers(0, 2**32, B, dtype=np.uint64)
            st[:2] = [0, 2**32 - 1]
            yield ("vhs_region_b_entries", f"B {B}, H {H}, n_steps {n}",
                   (t(st.astype(np.uint32).view(np.int32)),),
                   dict(n_steps=n, H=H))
        for L, H, av, row0, extra in LINE_EDGES:
            # windows inside the row, from below 0, spilling, past 2H, or
            # from any int32 (xpos + av wraps); max_e 0, -1, 96256
            kind = rng.integers(0, 5, (B, L))
            lo = np.array([0, -av - 5, H - av, 2 * H - av, -2**31])[kind]
            hi = np.array([max(H - av, 0) + 1, 0, H + 5, 3 * H, 2**31])[kind]
            max_e = rng.integers(-2**31, 2**31, B)
            max_e[:3] = [0, -1, 96256]
            yield ("bloom_line_width",
                   f"B {B}, L {L}, H {H}, av {av}, row0 {row0}",
                   (t(rng.integers(-128, 128, (B, row0 + L + 1 + extra, H),
                                   dtype=np.int8)),
                    t((lo + (rng.random((B, L)) * (hi - lo))).astype(
                        np.int64).astype(np.int32)),
                    t(max_e.astype(np.int32))), dict(row0=row0, av_len=av))
    sets = np.array([tuple(c) for c in three], np.int32)
    for R, T, off in ([(R, T, False) for R, T in ROW_EDGES]
                      + [(R, T, True) for R, T in ROW_OFF_GRID]):
        x = t(rng.integers(-2**31, 2**31, R * T + 1).astype(np.int32))
        x = x[1:] if off else x[:-1]        # the wrapper's y is line-aligned
        label = f"R {R}, T {T}" + (", x off the line grid" if off else "")
        x = x.view(R, T)
        yield "iir_lowpass_rows", label, (x, t(i32(0, 2048, R))), {}
        yield ("eq_threeband_rows", label,
               (x, *(t(v) for v in sets[rng.integers(0, 3, R)].T)), {})


def phase_ragged(dev):
    """K1-K5, bloom_line_width, K7 and K8 against their plain versions on the
    ragged_cases inputs, at 0 LSB (K2's through
    decode_rows_plain_any_shift: the shifts go below 0)."""
    from ntsc_crt_tpu_torch.ops.kernels import decode
    mods = kernel_modules()
    for name, label, a, k in ragged_cases(dev):
        kd = mods[name]
        got = getattr(kd.mod, kd.wrapper)(*a, **k)
        want = (decode.decode_rows_plain_any_shift(*a, **k)
                if name.startswith("decode_rows") else kd.plain(*a, **k))
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if [g.shape for g in got] != [w.shape for w in want] or err != 0:
            raise SystemExit(f"{name} ragged ({label}): kernel differs from "
                             f"plain (max |err| {err})")
        print(f"kernel {name} ragged ({label}) shape "
              f"{[tuple(g.shape) for g in got]}: equals plain at 0 LSB",
              flush=True)


def phase_ops(systems, dev):
    """The entry points of K7-K10, counted: the IIR op on the NTSC encode's
    Y/I/Q, the unfused decode chain on the NTSC decode's K2 inputs (held to
    K2), the probe's report.  Sets MEASURED from the probe.  Returns the
    launch counts."""
    from ntsc_crt_tpu_torch.models import pipeline
    from ntsc_crt_tpu_torch.ops import filters
    from ntsc_crt_tpu_torch.ops.kernels import (decode, probe, rowfilters,
                                                scanconv)
    B = KERNEL_BATCHES[-1]
    seen = capture_kernel_inputs(pipeline, systems.NTSC, B,
                                 ("encode_rows", "decode_rows"), dev, {})
    yiq, c = k7_args(*seen["encode_rows"])
    a, k = seen["decode_rows"]
    k2 = decode.decode_rows(*a, **k)                      # the yardstick
    out = {}

    def run():
        out["iir"] = filters.iir_lowpass(yiq, c)
        out["unfused"] = scanconv.decode_rows_unfused(*a, **k)
        out["probe"] = probe.report()
    launches, _ = counted(
        "op entry points (iir_lowpass, the unfused decode, the probe)",
        ("iir_lowpass_rows", "eq_threeband_rows", "scanconv_rows", "probe"),
        run)
    torch.cuda.synchronize()
    if not torch.equal(out["iir"], rowfilters.iir_lowpass_rows_plain(yiq,
                                                                      c)):
        raise SystemExit("filters.iir_lowpass differs from its plain march")
    if not torch.equal(out["unfused"], k2):
        raise SystemExit("the unfused decode chain differs from K2")
    print(f"op entry points: iir_lowpass on {tuple(yiq.shape)} equals the "
          f"plain march; the unfused decode at batch {B} equals K2 at 0 LSB",
          flush=True)
    set_rates(out["probe"])
    return launches


def set_rates(rep) -> None:
    """MEASURED from the probe's report, printed with it."""
    from ntsc_crt_tpu_torch.ops.kernels import probe
    probe.print_report(rep)
    MEASURED.update(dep_cycles=rep["dep_cycles"],
                    sm_hz=rep["latency"]["sm_mhz"] * 1e6,
                    int32_per_s=max(r["gops"] for r in rep["rows"]
                                    if r["pattern"] == "peak") * 1e9)
    print(f"bounds price int32 at {MEASURED['int32_per_s'] / 1e12:.2f} T "
          f"source ops/s and chains at {MEASURED['dep_cycles']:.3f} cycles a "
          f"dependent op, {MEASURED['sm_hz'] / 1e6:.0f} MHz", flush=True)


# entry point -> (kernel, preset, keywords) of the path whose inputs a
# design variant of that kernel is timed on (time_variants; K7's and K8's
# derived from K1's and K2's, DERIVED)
VARIANT_PATHS = {
    "ntsc_hsync_chase": ("hsync_chase", "NTSC", {}),
    "ntsc_ccf_ema": ("ccf_ema", "NTSC", {}),
    "ntsc_vhs_region_b_entries": ("vhs_region_b_entries", "NTSCVHS", VHS_KW),
    "ntsc_bloom_line_width": ("bloom_line_width", "NTSC", BLOOM),
    "ntsc_iir_lowpass_rows": ("iir_lowpass_rows", "NTSC", {}),
    "ntsc_eq_threeband_rows": ("eq_threeband_rows", "NTSC", {}),
}


def time_variants(sources, batches=(1, 64, MAIN_BATCH)) -> None:
    """Design runs, on the card: each CUDA source of `sources` — a copy of
    a kernel's csrc/*.cu with its design changed and its entry points kept —
    is built alone, launched through the package's own wrapper, held to the
    plain version at 0 LSB and timed and bounded as phase_kernels does, on
    the inputs the kernel's path (VARIANT_PATHS) hands it at each batch;
    every entry point of VARIANT_PATHS that a source defines is timed (a
    copy of csrc/rowfilters.cu: K7 and K8).  The inputs of each kernel and
    batch are captured once and shared by the variants:

        python3 -c "import chip_smoke as c; c.time_variants(['v.cu'])"
    """
    import ctypes
    import types

    from ntsc_crt_tpu_torch.models import pipeline, systems
    from ntsc_crt_tpu_torch.ops.kernels import build, probe
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    lib = build.library()
    set_rates(probe.report())
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    sos = [out / f"{Path(src).stem}.so" for src in sources]
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                               "-I", str(build.SRC_DIR), "-o", str(so),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, so in zip(sources, sos)]
    variants = []   # (source name, {entry point: function})
    for src, so, proc in zip(sources, sos, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{src}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {Path(src).name}: {line.strip()}")
        var = ctypes.CDLL(str(so))
        fns = {e: getattr(var, e) for e in VARIANT_PATHS if hasattr(var, e)}
        for e, fn in fns.items():
            fn.argtypes = [build._CTYPES[k] for k in build._SIGNATURES[e]]
            fn.restype = ctypes.c_int
        variants.append((Path(src).name, fns))
    rows = {}
    for entry, (name, preset, kw) in VARIANT_PATHS.items():
        users = [(n, fns) for n, fns in variants if entry in fns]
        cfg = getattr(systems, preset)
        for B in batches if users else ():
            a, k = kernel_inputs(pipeline, cfg, B, (name,), dev, kw)[name]
            for src, fns in users:
                build._lib = types.SimpleNamespace(**fns)
                try:
                    check_kernel(name, f"{path_label(cfg, kw)}, {src}", B, a,
                                 k, rows)
                finally:
                    build._lib = lib


# An identity march through the row filters' first ring (time_row_copies):
# each warp copies its 32 rows a tile of 32 samples at a time, 4 tiles a
# ring, by 4-byte cp.async in and 4-byte stores out, tile k of every row at
# the row's own sample 32k.
ROW_COPY_CU = r"""
#include <cuda_runtime.h>
#include "cp_async.cuh"
__global__ void __launch_bounds__(32) ring_copy(
        const int* __restrict__ x, int* __restrict__ y, long long R, int T) {
    constexpr int C = 32, S = 4;
    __shared__ int ring[S][32][C + 1];
    const int lane = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * 32;
    const int nrows = (int)min(32LL, R - row0), ntiles = (T + C - 1) / C;
    const int* src = x + row0 * T;
    int* dst = y + row0 * T;
    auto fill = [&](int k) {
        const int t = k * C + lane;
        if (k < ntiles)
            for (int r = 0; r < 32; ++r) {
                const bool in = t < T && r < nrows;
                cp_async4_zfill(&ring[k % S][r][lane],
                                in ? src + (long long)r * T + t : x, in);
            }
        cp_async_commit();
    };
    for (int k = 0; k < S - 1; ++k) fill(k);
    for (int k = 0; k < ntiles; ++k) {
        fill(k + S - 1);
        cp_async_wait<S - 1>();
        __syncwarp();
        const int t = k * C + lane;
        if (t < T)
            for (int r = 0; r < nrows; ++r)
                dst[(long long)r * T + t] = ring[k % S][r][lane];
        __syncwarp();
    }
}
extern "C" int row_copy(const void* x, void* y, int R, int T, void* st) {
    ring_copy<<<(R + 31) / 32, 32, 0, (cudaStream_t)st>>>(
        (const int*)x, (int*)y, R, T);
    return (int)cudaGetLastError();
}
"""


def time_row_copies(shapes=((46080, 753), (46080, 768))) -> None:
    """What a row segment's alignment costs, on the card, behind the spin:
    ROW_COPY_CU's ring copy (at odd T its row segments straddle two
    128-byte lines; at T = 768 each is one whole line) beside y.copy_(x)
    at each (R, T); then csrc/rowfilters.cu's K7 on NTSC's batch-64 rows
    with x, y or both one word off a 128-byte line (x off y's line grid
    takes its 4-byte copies; y off shifts every row's lines):

        python3 -c "import chip_smoke as c; c.time_row_copies()"
    """
    import ctypes

    from ntsc_crt_tpu_torch.ops.kernels import build, probe, rowfilters
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    set_rates(probe.report())
    out = build.BUILD_DIR / "row_copy"
    out.mkdir(parents=True, exist_ok=True)
    (out / "row_copy.cu").write_text(ROW_COPY_CU)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
                          str(build.SRC_DIR), "-o", str(out / "row_copy.so"),
                          str(out / "row_copy.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise SystemExit(f"row_copy.cu: nvcc failed\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(out / "row_copy.so")).row_copy
    fn.argtypes = [build._CTYPES[k] for k in "ppiip"]
    stream = build.stream(dev)
    gen = torch.Generator(device=dev).manual_seed(8)

    def show(label, x, y, run, want):
        run()
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise SystemExit(f"{label}: differs")
        ms = cuda_ms(run, 20, spin=True)
        print(f"{label}: {ms:.4f} ms, {2 * nbytes(x) / ms / 1e9:.3f} TB/s  "
              f"[{card}]", flush=True)

    for R, T in shapes:
        x = torch.randint(-2**31, 2**31 - 1, (R, T), dtype=torch.int32,
                          device=dev, generator=gen)
        y = torch.empty_like(x)
        show(f"y.copy_(x) {R} x {T}", x, y, lambda: y.copy_(x), x)
        show(f"ring copy {R} x {T}", x, y,
             lambda: fn(x.data_ptr(), y.data_ptr(), R, T, stream), x)
    R, T = 45312, 753
    x0 = torch.randint(-2**31, 2**31 - 1, (R, T), dtype=torch.int32,
                       device=dev, generator=gen)
    c = torch.randint(0, 2048, (R,), dtype=torch.int32, device=dev,
                      generator=gen)
    want = rowfilters.iir_lowpass_rows_plain(x0, c)

    def at(off):
        return torch.empty(R * T + 32, dtype=torch.int32,
                           device=dev)[off:off + R * T].view(R, T)

    for label, ox, oy in (("on the line grid", 0, 0),
                          ("x one word off", 1, 0), ("y one word off", 0, 1),
                          ("both one word off", 1, 1)):
        x, y = at(ox), at(oy)
        x.copy_(x0)
        show(f"K7 {R} x {T}, {label}", x, y,
             lambda: build.launch("ntsc_iir_lowpass_rows", x.data_ptr(),
                                  c.data_ptr(), y.data_ptr(), R, T, stream),
             want)


# --- goldens ------------------------------------------------------------------


def golden_run(pipeline, cfg, B, dev, kw):
    """The recipe of bench.py:198-235: two 320x240 frames (NES: 256x240 PPU
    pixels) at 128x96 (B = 1, unbatched state) or sixteen 80x60 slots
    through step_batch, noise 7; the second step toggles field/frame; kw:
    the tag's build variant."""
    if B == 1:
        rng = np.random.RandomState(0)
        img = (rng.randint(0, 512, (1, 240, 256), np.uint16)
               if cfg.kind == "nes"
               else rng.randint(0, 256, (1, 240, 320, 3), np.uint8))[0]
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
            ("NTSC_conv7", systems.NTSC, 1, CONV7),
            ("PV1K", systems.PV1K, 1, {}),
            ("PV1K_b16", systems.PV1K, 16, {}),
            ("NES", systems.NES, 1, {}),
            ("SNES", systems.SNES, 1, {}),
            ("NESRGB", systems.NESRGB, 1, {}))
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


# the port's CUDA functions on the pipeline paths, as the profiler names
# them, and their kernels (K2's mode from its template arguments)
KERNEL_FUNCS = (("encode_rows_kernel", "encode_rows"),
                ("decode_rows_kernel", "decode_rows"),
                ("bloom_line_width_kernel", "bloom_line_width"),
                ("hsync_chase_kernel", "hsync_chase"),
                ("ccf_ema_kernel", "ccf_ema"),
                ("vhs_region_b_kernel", "vhs_region_b_entries"),
                ("place_rows_kernel", "place_rows_uniform"))


def kernel_of(event: str):
    """The kernel of a device event's name, or None."""
    for fn, name in KERNEL_FUNCS:
        if fn in event:
            if name == "decode_rows" and "Fir" in event:
                return "decode_rows_conv"
            if name == "decode_rows" and ("true" in event or "Lb1E" in event):
                return "decode_rows_bloom"
            return name
    return None


def profile_step(fn):
    """(device operations, of which kernels, device busy ms, wall ms, the
    eight torch ops with the most host time, {kernel: (device ms,
    launches)} of the port's kernels) of one call of fn() under
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
    ours = {}
    for e in kernels:
        name = kernel_of(e.name)
        if name is not None:
            ms, n = ours.get(name, (0.0, 0))
            ours[name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                          n + 1)
    return len(evs), len(kernels), busy / 1e3, wall, top, ours


def device_ms(avg) -> float:
    """A key_averages() row's own device time, ms."""
    us = getattr(avg, "self_device_time_total", None)
    return (avg.self_cuda_time_total if us is None else us) / 1e3


def profile_line_scan(pipeline, cfg, st, imgs, B, kw, card):
    """The device operations of one step's line scan (models/demodulate.py
    _line_scan: the rolled4 row select, the rows2 concatenation, the burst
    gather and roll, K3, K4, the waves), each torch op with its own device
    time and each port kernel, from one call of _line_scan on the step's
    own arguments under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from ntsc_crt_tpu_torch.models import demodulate as dem
    dev = imgs.device
    seen = {}

    def record(name, fn):
        def rec(*a, **k):
            seen["args"] = (a, k)
            return fn(*a, **k)
        return rec

    with patched([(dem, "_line_scan")], record):
        pipeline.step_batch(cfg, st, imgs, *path_args(B, 0, dev), noise=12,
                            **kw)
    a, k = seen["args"]
    dem._line_scan(*a, **k)                               # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dem._line_scan(*a, **k)
        torch.cuda.synchronize()
    ops = [(a.key, a.count, device_ms(a)) for a in prof.key_averages()
           if a.key.startswith("aten::") and device_ms(a) > 0]
    ours = {}
    for e in prof.events():
        name = (kernel_of(e.name)
                if e.device_type == torch.autograd.DeviceType.CUDA else None)
        if name is not None:
            ms, n = ours.get(name, (0.0, 0))
            ours[name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                          n + 1)
    rows = sorted(ops, key=lambda r: -r[2]) + [
        (k, n, ms) for k, (ms, n) in ours.items()]
    print(f"{path_label(cfg, kw)} line scan batch {B}, device ms (calls): "
          + ", ".join(f"{k} {ms:.4f} ({n})" for k, n, ms in rows)
          + f"; in all {sum(r[2] for r in rows):.4f}  [{card}]", flush=True)


def phase_syncs(pipeline, systems, dev, gate=True):
    """One NTSC batch-1 step under torch.cuda.set_sync_debug_mode("warn"),
    each synchronizing op reported by the line of the port that called it;
    one inside the line scan fails the run unless `gate` is off (to run the
    script on a package from before the line scan lost its sync)."""
    import traceback

    from ntsc_crt_tpu_torch.models import demodulate as dem
    cfg = systems.NTSC
    img = frames_for(cfg, 1, OUTH, OUTW, 1234, dev)
    st = pipeline.init_batch(cfg, 1, OUTW, OUTH, device=dev)
    st = pipeline.step_batch(cfg, st, img, *path_args(1, 0, dev), noise=12)
    torch.cuda.synchronize()
    in_scan, found = [False], {False: set(), True: set()}

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost frame of the port, else of this script (a sync the
        # port did not ask for)
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if "ntsc_crt_tpu_torch" in f.filename]
        mine = [f for f in stack if f.filename == __file__]
        where = (port or mine or stack)[-1]
        found[in_scan[0]].add(
            f"{Path(where.filename).name}:{where.lineno}"
            + ("" if port else " (not the port's)"))

    def mark(name, fn):
        def run(*a, **k):
            in_scan[0] = True
            try:
                return fn(*a, **k)
            finally:
                in_scan[0] = False
        return run

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with patched([(dem, "_line_scan")], mark):
                pipeline.step_batch(cfg, st, img, *path_args(1, 1, dev),
                                    noise=12)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print("NTSC batch-1 step under set_sync_debug_mode: synchronizing ops "
          f"inside _line_scan at {', '.join(sorted(found[True])) or 'none'};"
          f" outside it at {', '.join(sorted(found[False])) or 'none'}",
          flush=True)
    if found[True] and gate:
        raise SystemExit("the line scan synchronizes the stream")


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


def phase_path(pipeline, cfg, kw, needed, card, dev, steps1=20, stepsB=5):
    """One main path at batch 1 and 512; returns the launch counts."""
    img1 = frames_for(cfg, 1, OUTH, OUTW, 1234, dev)
    B = MAIN_BATCH
    imgsB = frames_for(cfg, B, 240, 320, 1235, dev)
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
        ops, kern, busy, wall, top, ours = profile_step(one)
        print(f"{label} profiled step batch {b}: {ops} device operations "
              f"({kern} kernels), device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall  [{card}]; most host time (ms): {top}", flush=True)
        print(f"{label} profiled step batch {b}, the port's kernels (device "
              "ms, launches): " + (", ".join(
                  f"{k} {ms:.4f} ({n})" for k, (ms, n) in ours.items())
                  or "none in the trace"), flush=True)
    profile_line_scan(pipeline, cfg, stB, imgsB, B, kw, card)
    return launches


def phase_variant(pipeline, cfg, kw, needed, dev):
    """One batch-2 step at 640x480 from a stepped state, counted, and held
    to the CPU's plain path."""
    B = 2
    imgs = frames_for(cfg, B, 240, 320, 7, dev)
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

    # 3. the op entry points of K7-K10; the probe prices the chains below
    launches = dict.fromkeys(ORIGIN, 0)
    for k, n in phase_ops(systems, dev).items():
        launches[k] += n

    # 4. kernels vs plain versions, then K1-K4 at ragged shapes and edges
    table = phase_kernels(pipeline, systems, dev)
    phase_ragged(dev)

    # the line scan runs without a stream synchronize
    phase_syncs(pipeline, systems, dev)

    # 5. goldens
    phase_goldens(pipeline, systems, dev)

    # 6. the main paths, each counted on its own; a kernel's launches are
    # its counts summed over the paths and the op entry points
    common = ("hsync_chase", "ccf_ema", "decode_rows")
    rgb = common + ("encode_rows",)
    paths = ((systems.NTSC, {}, rgb + ("place_rows_uniform",)),
             (systems.NTSCVHS, VHS_KW,
              rgb + ("place_rows_uniform", "vhs_region_b_entries")),
             (systems.NTSC, BLOOM,
              ("encode_rows", "hsync_chase", "ccf_ema", "decode_rows_bloom",
               "bloom_line_width")),
             (systems.NTSC, CONV7,
              ("encode_rows", "hsync_chase", "ccf_ema", "decode_rows_conv",
               "place_rows_uniform")),
             (systems.PV1K, {}, rgb + ("place_rows_uniform",)),
             (systems.NES, {}, common + ("place_rows_uniform",)))
    for cfg, kw, needed in paths:
        for k, n in phase_path(pipeline, cfg, kw, needed, card, dev).items():
            launches[k] += n

    # 7. the other variants and encoder families: one step each
    phase_variant(pipeline, systems.NTSC, FIXED_SYNC,
                  ("encode_rows", "ccf_ema", "decode_rows",
                   "place_rows_uniform"), dev)
    for cfg in (systems.NTSC_RAINBOW, systems.SNES, systems.TEMPLATE,
                systems.NESRGB):
        phase_variant(pipeline, cfg, {}, rgb + ("place_rows_uniform",), dev)

    def reported(k):          # a kernel's first label, at the last batch
        label = next(iter(table[k]))[0]
        return table[k][(label, PROBE_BLOCKS if k == "probe"
                         else KERNEL_BATCHES[-1])]

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=ORIGIN[k][0], replaces=ORIGIN[k][1],
             launches=launches[k],
             max_abs_err=max(r["max_abs_err"] for r in table[k].values()),
             ms=reported(k)["ms"], plain_ms=reported(k)["plain_ms"],
             bound_ms=reported(k)["bound_ms"],
             bound_by=reported(k)["bound_by"], library_ms=None)
        for k in ORIGIN]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
