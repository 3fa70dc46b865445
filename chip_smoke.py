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
   inputs the paths hand it at batch 1 and 64 (640x480 output): K1's field
   mode encode_rows_field (the RGB encoders' whole field in one launch:
   held to K1's plain block and the passes around it), K2 decode_rows
   (3-band), K3 hsync_chase, K4 ccf_ema, K6
   place_rows_uniform and K11 inject_noise from an NTSC step; K2 in conv
   mode from an NTSC eq_mode="conv7" step; K2 in bloom mode,
   bloom_line_width and K6 in bloom mode from an NTSC do_bloom step; K4
   ccf_ema, K5
   vhs_region_b_entries, K11 over region A and K12 vhs_noise_bc from an
   NTSCVHS step; K1's field mode at 5-sample chroma with a carrier table a
   row and 5 burst classes, K2 on 5-sample chroma at 1920-sample lines, K3
   and K4 (VP 5) from a PV1K step; K1's field mode (3 burst classes) and K4
   (VP 3) from a SNES step; K1's block mode with a carrier table a row
   from a NESRGB step; K1's field mode from the NTSCVHS and bloom steps; K13 nes_square from a NES step, with and
   without draw_border (border_color 0x1FF, optimized=False); K11 on each
   of these paths' and on NES's noise inputs; K6's general mode
   place_rows_general from a NES step into LiveSession's 832x624 (off the
   uniform gate) at 1, 64 and 512;
   K7 on the Y/I/Q rows of the NTSC and PV1K K1 inputs; K8 on the NTSC K2
   inputs' Y/I/Q rows, K9 on K8's output, and the unfused chain against K2;
   K2 (each mode), K3 and bloom_line_width read their lines in place from
   the noisy field, a line on the field's last row continuing on its row
   0: each reports the share of its lines that start on the last row (the
   wrap), which must be above 0 on every NTSC path's inputs;
   K2 (each mode), K3 and K4 also at batch 512 on NTSC's (K3, K4: and
   PV1K's) inputs, K5 and K12 on
   NTSCVHS's, K13 on NES's, K11 on every main path's, bloom_line_width (its
   line sums included) and K6's bloom mode on the bloom path's, K7 on
   NTSC's and PV1K's rows
   and K8 on NTSC's; K10's three patterns at the TPU probe's size.  Exact
   equality;
   each side's time from CUDA events (the kernel's also with its calls
   queued behind a spin kernel, see cuda_ms); each kernel's bound from
   these inputs (see BOUNDS below); beside K7's and K8's, the time of a
   device copy of their rows
   (y.copy_(x), behind the spin): the bytes' reachable floor.  Then K1-K5,
   bloom_line_width, K7 and K8 at small ragged shapes and edges
   (ragged_cases: partial warps and tiles, shifts before 0 and past H,
   every K2 mode, bloom rows that restart or meet the forced-zero sample;
   K3 estimates that wrap across H both ways, windows from below 0 and past
   the rows, W 6, 8 and 16, at batch 5 and 512; K1's field mode on
   NTSC-VHS's and bloom's sizing with pictures that spill past the row end
   onto killed rows, clip at the field's end or start left of the kill's
   columns, on PV1K's geometry (5-sample chroma, 5 burst classes) centred
   and spilling and clipped, on SNES's spilling, at batch 1, 5 and 33
   (FIELD_EDGES); K4 at m 16, VP 5, CC 5 over
   ragged chunks and at one line; K5 at H 1, 7, 40 and 910 with bands cut
   short and steps past 19H from the seeds 0 and 2**32 - 1;
   bloom_line_width's windows from below 0, spilling, past 2H and wrapping
   int32, with max_e 0, -1 and 96256, rows whose chunks straddle the
   tensor's end, L past one 256-line pass; K7 and K8 at 1-65 rows and
   1-1487 samples around their lines and ring, every T mod 4, x on and off
   y's line grid, on full-range samples; K11 at odd batches, NES's rows
   (N 2 mod 4), region A's odd n, rows shorter than a thread's run and a
   warp's, input off a 16-byte boundary, and K12 over regions B+C of both
   parities, at the int32 seeds and knobs, noise 1 << 24 included; K13 at
   PPU sizes 256x240, 1x1 and 255x239, every 9-bit pixel, a picture
   spilling past HRES or clipped at the field's end, the border at 0x1FF,
   a field off the 4- and 16-byte grids, B 17 (the slots' fields start at
   every even residue of the 16-byte grid), negative dot-crawl offsets
   and the black and white points where the int32 sums and the int8 store
   wrap; K6's bloom mode at every ratio, blend, scanline gap and field
   parity, on 16-byte and byte rows, with lines drawn wholly, not at all,
   to mid-row and with dx and scan at the int32 edges).  Then
   one NTSC batch-1 step, one NTSC-VHS step at B 2048 and one video_exact
   call of 4 frames, run op by op under torch.cuda.set_sync_debug_mode: a
   synchronizing op inside the line scan or the VHS step, or one of the
   port's inside video_exact, fails the run; any other is reported with
   its source line; and one NES batch-1 step (K13, the border, the
   unoptimized build) under set_sync_debug_mode("error"): any
   synchronizing op fails the run.  Then the three benchmark cells' steps at B
   2048 replayed as CUDA graphs (models/graphs.py), 6 steps each, held to
   the same steps run op by op at 0 LSB with equal launch counts, the
   graphs' counter showing a replay on every step after the capture.
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
   run on no pipeline path); every path places its rows by K6 (bloom's by
   its bloom mode): a call of the general row placement (per-row gathers)
   fails the run.  Each path's last step must equal the same
   step run on the CPU's plain path.  Then, for each path and batch, one
   step timed stage by stage (host clock around synchronized stages) and
   one step under torch.profiler (device launches and busy time, and each
   of the port's kernels' device time and launches in that step); at batch
   512 also the line scan's device operations (the burst gather, K3, K4,
   the waves), each with its device time.
7. variants — one batch-2 step each of fixed sync (do_vsync and do_hsync
   False: K3 must not launch), NTSC_RAINBOW, SNES, TEMPLATE, NESRGB and
   NES with draw_border (border_color 0x1FF) and optimized=False, held to
   the CPU's plain path.
8. video and front ends — tests/fixtures/video_goldens.npz (the JAX package's
   video_exact, v_fac 4 included, and video_strided) replayed bit-exact;
   then each path counted like the main paths: video_exact of 16 640x480
   frames (frames 0-3 held to the CPU plain path; ms a frame),
   video_strided at B 512, k 2 from 320x240 (slots 0 and 511 held to
   video_exact of their sub-videos; frames/s, peak memory), cli.video_main
   on 16 BMP frames (NTSCVHS, -a; every frame held to video_exact; frames/s
   with the file I/O), cli.main on the test card (the card's file equal to
   the CPU's), LiveSession at 832x624 (60 tick and 60 tick_fast, equal;
   ms a tick) and term_live.main --frames 30 --no-display; a checkpoint
   saved mid-video, loaded and resumed (equal to the uninterrupted run);
   parallel.mesh's make_sharded_step over one card and over the same card
   twice (the split and merge; the split over several cards is
   tests/test_torch_mesh.py's and time_mesh's) against step_batch.
9. spatial split and demo — make_sharded_step over make_mesh(1, 2) and
   make_mesh(2, 2) of this card repeated, each counted: NTSC at batch 1
   (640x480 image) and 512 (320x240 images), NTSCVHS (do_aberration 1),
   bloom, conv7, PV1K and NES at batch 2, two steps each, every leaf held
   to step_batch at 0 LSB; parallel.spatial's _INSPECT record shows K1's
   rows and K2's lines tiled once over each mesh row, a launch a shard.
   K7, K8 and K9 through their op entries over a group of two, held to one
   call.  One batch-1 step over 1x2 under set_sync_debug_mode("error")
   (any synchronizing op fails the run); the bytes a second shard copies a
   step; host ms a step at NTSC batch 1 and 512, 1x1 against 1x2 (1x1,
   1x2, 1x2, 1x1).  Then `python -m ntsc_crt_tpu_torch.demo` on the card
   into a temporary directory (every system, counted), its NTSC files
   held to the same demo on the CPU.  The split over distinct cards is
   tests/test_torch_spatial.py's `gpu` tests' and time_spatial's.

BOUNDS: a kernel's bound is the larger of the bytes it must move (each input
read once, each output written once; of K6's previous frame only the rows
this data needs) over 3.35 TB/s and the int32 instructions it executes on
these inputs (source ops counted from its source; where the work depends on
the data, what this data needs) over the card's int32 source-op rate: the
probe's `peak` rate measured in phase 3 of this run at the full-card size (a
source op is often less than one SASS instruction, so this is above the
issue ceiling of 132 SMs x 128 lanes x clock; the data sheet gives no int32
rate; K11's tables count no bytes: they are positions of the generator it
steps).  For the serial kernels (K1, K2, K3, K4, K5, bloom_line_width, K7,
K8, K10) the dependent chain of the longest entry is also priced
(`chain`): the cycles per dependent source op that the probe measured in
this run (eq1, one warp a scheduler), 260 cycles per dependent load that
hits L2 (assumed), at the SM clock read during the probe; K5's line also
prices the parent design's chain (a thread's eight ops a step).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Every number is measured in this run.
"""

import contextlib
import itertools
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ntsc_crt_tpu_torch.utils import profiling
from ntsc_crt_tpu_torch.utils.profiling import (device_ms, kernel_of,
                                                profile_step)

GOLDENS = (Path(__file__).resolve().parent / "tests" / "fixtures"
           / "device_parity_goldens.npz")
OUTW, OUTH = 640, 480
LIVE_SIZE = (832, 624)     # LiveSession's window: off K6's uniform gate
ORIGIN = {  # kernel -> (CUDA source, the Pallas kernel's pallas_call)
    "encode_rows": ("ntsc_crt_tpu_torch/csrc/encode.cu",
                    "ntsc_crt_tpu/ops/pallas/encode_fused.py:179"),
    # K1's field mode: the same Pallas kernel, and the XLA passes around it
    # (the skeleton, the burst, the block's store, VHS's kill)
    "encode_rows_field": ("ntsc_crt_tpu_torch/csrc/encode.cu",
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
    # no Pallas kernel: the JAX decoder leaves the noise stage to XLA's
    # fused elementwise pass
    "inject_noise": ("ntsc_crt_tpu_torch/csrc/noise.cu",
                     "ntsc_crt_tpu/models/demodulate.py:128"),
    "vhs_noise_bc": ("ntsc_crt_tpu_torch/csrc/noise.cu",
                     "ntsc_crt_tpu/models/demodulate.py:150"),
    # no Pallas kernel: the JAX encoder leaves NES's square-wave pass
    # (modulate_nes, and _nes_square_sum4 at :755) to XLA
    "nes_square": ("ntsc_crt_tpu_torch/csrc/nes.cu",
                   "ntsc_crt_tpu/models/modulate.py:818"),
    "place_rows_uniform": ("ntsc_crt_tpu_torch/csrc/place.cu",
                           "ntsc_crt_tpu/ops/pallas/place_rows.py:255"),
    # no Pallas kernel: the JAX decoder sends bloom's lines (a `valid`
    # plane) to its general placement, XLA's row gathers
    "place_rows_uniform_bloom": ("ntsc_crt_tpu_torch/csrc/place.cu",
                                 "ntsc_crt_tpu/models/demodulate.py:1314"),
    # no Pallas kernel: off the uniform gate the JAX decoder places rows
    # with its cover mask and XLA's row gathers
    "place_rows_general": ("ntsc_crt_tpu_torch/csrc/place.cu",
                           "ntsc_crt_tpu/models/demodulate.py:1289"),
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
NES_BORDER = {"draw_border": True, "border_color": 0x1FF, "optimized": False}
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
    """profiling.cuda_ms (as issued, or behind a spin kernel sized at the
    SM clock the probe read in this run)."""
    return profiling.cuda_ms(fn, reps, spin=spin, sm_hz=MEASURED["sm_hz"])


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


@contextlib.contextmanager
def eager_steps(pipeline):
    """pipeline.step run op by op inside the block, never replayed as CUDA
    graphs (models/graphs.py), so that the module functions a phase patches
    are called on every step."""
    graphed = pipeline.step
    pipeline.step = getattr(graphed, "__wrapped__", graphed)
    try:
        yield
    finally:
        pipeline.step = graphed


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


def work_encode_field(a, k, out):
    """K1's field mode: work_encode's ops and chain over the picture's
    samples, plus 6 a sample for the field store's span tests; per other
    field byte 14 (its spans, the mask, the select, the store).  Bytes: K1's
    inputs and the (B,) and (B, P, burst_len) arguments, the field written
    once, the constant tables once, and of the caller's field the bytes
    that nothing else writes (found by assembling the field over two
    different caller's fields)."""
    from ntsc_crt_tpu_torch.ops.kernels import encode
    img, sy, modI, modQ, gain, base, analog, skel, mask_end, vrows = a[:10]
    B, desth, destw = sy.shape[0], sy.shape[1], k["destw"]
    ire = torch.zeros((B, desth, destw), dtype=torch.int8,
                      device=out.device)
    spans = {n: k[n] for n in ("xo", "yo", "cb_beg", "bw_beg", "blank")}
    kept = [encode.assemble_field(torch.full_like(analog, v), ire, *a[7:],
                                  **spans) for v in (0, 1)]
    kept = int((kept[0] != kept[1]).sum())
    n_pic = B * desth * destw
    ops = (n_pic * (49 if k["coefs"] is not None else 37)
           + (out.numel() - n_pic) * 14)
    chain = (4 * destw if k["coefs"] is not None else 11) * dep()
    return (nbytes(img, sy, modI, modQ, gain, base, skel, mask_end, vrows,
                   *(t for t in a[10:] if t is not None), out) + kept,
            ops, chain)


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
    moved = line_rows_bytes(a[0], L) + nbytes(*a[1:], out)
    if k.get("bloom_dx") is None:
        return (moved, B * L * (av * per_sample + outw * 44), chain(av))
    n_eq = decode.eq_len(av, a[3].shape[2])
    last = ((k["bloom_dx"].long() * (outw - 1)) >> 12).clamp(min=0)
    march = (last + 1).clamp(max=n_eq - 1) + 1
    return (moved + nbytes(k["bloom_dx"], k["bloom_lidx"]),
            int(march.sum()) * (per_sample + 6) + B * L * outw * 54,
            chain(int(march.max())))


def line_rows_bytes(field, L) -> int:
    """The field bytes L consecutive lines read: their L + 1 rows (a line
    runs on into the next row), each once, at most every row."""
    B, V, H = field.shape
    return B * min(L + 1, V) * H


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
    field, line_row, xpos, max_e = a
    B, L = xpos.shape
    win = line_window_bytes(field.shape[2], xpos, k["av_len"])
    ops = (win // 4) * 2 + B * L * 40
    chain = L * 5 * dep() + -(-L // 16) * LOAD_CYCLES
    return win + nbytes(line_row, xpos, max_e, out), ops, chain


def work_place(a, k, out):
    """Per 16-byte chunk: the row's source picks and the keep test (about
    30), the blend 16 over four words, bloom mode's six pixel tests and
    byte masks about 40.  Bytes: the lines, the field bits, bloom mode's
    (dx, scan) lines, the output, and only the previous rows this data
    needs — those kept (scanline gaps, the odd field's clips), with blend
    each group's beg row, and without it, in bloom mode, the bytes of the
    beg rows under the pixels their lines do not draw."""
    from ntsc_crt_tpu_torch.models import demodulate as dem
    rgb, old, field_px = a
    ratio, fp, sl = k["ratio"], k["fp"], k["scanlines"]
    B, L, w = rgb.shape[:3]
    fb = (field_px > 0).cpu()[:, None]                    # (B, 1)
    r = torch.arange(ratio * L)
    kk, j = r // ratio, r % ratio
    keep = torch.where(fb, (j - fp) % ratio, j) >= ratio - sl
    if fp:
        keep |= (j < fp) & (kk == 0) & fb
        keep |= (j > fp) & (j >= ratio - sl) & (kk == L - 1) & fb
    src = torch.where(fb & (j < fp), (kk - 1).clamp(min=0), kk)
    need = keep.clone()
    if k["blend"]:
        beg = ratio * src + torch.where(fb, fp, 0)
        need.scatter_(1, torch.where(keep, r, beg), True)
    old_bytes = int(need.sum()) * old[0, 0].numel()
    bloom = k.get("bloom_dx") is not None
    if bloom and not k["blend"]:
        undrawn = (~dem.bloom_drawn(k["bloom_dx"], k["bloom_scan"],
                                    k["av_len"], w)).sum(-1).cpu()
        used = torch.zeros((B, L + 1), dtype=torch.bool)
        used.scatter_(1, torch.where(keep, L, src), True)  # lines read
        old_bytes += int((undrawn * used[:, :L]).sum()) * 3
    n = out.numel() // 16
    return (nbytes(rgb, field_px, out) + old_bytes
            + (nbytes(k["bloom_dx"], k["bloom_scan"]) if bloom else 0),
            n * (30 + (16 if k["blend"] else 0) + (40 if bloom else 0)),
            None)


def work_place_general(a, k, out):
    """Per 16-byte chunk: the row's line and beg row picks (about 20), the
    blend 16, bloom mode's pixel tests 40; per block of 32 rows a test of
    every line (about 12 each).  Bytes: the lines the rows take (each
    once), beg/end/active, the output, and only the previous rows this data
    needs — those no line covers, with blend on each covered row's beg
    row, and in bloom mode the beg rows' bytes under undrawn pixels (an
    upper count: every covered row's line taken as undrawn where it is)."""
    from ntsc_crt_tpu_torch.models import demodulate as dem
    from ntsc_crt_tpu_torch.ops.fixedpoint import host_i32
    rgb, old, beg, end, active = a
    B, L, w = rgb.shape[:3]
    outh = old.shape[1]
    row = old[0, 0].numel()
    sl = k["scanlines"]
    sl = (sl if torch.is_tensor(sl) else torch.full((B,), sl)).cpu()
    beg, end, active = beg.cpu(), end.cpu(), active.cpu()
    ce = torch.maximum(beg + 1, end.clamp(max=outh) - sl[:, None])
    r = torch.arange(outh)[None, :, None]
    cov = (r >= beg[:, None]) & (r < ce[:, None]) & active[:, None]
    last = torch.where(cov, torch.arange(L), -1).amax(2)   # (B, outh)
    covered = last >= 0
    used = torch.zeros((B, L + 1), dtype=torch.bool)
    used.scatter_(1, torch.where(covered, last, L), True)
    old_rows = int((~covered).sum())
    bl = k["blend"]
    on = ((bl != 0).cpu() if torch.is_tensor(bl)
          else torch.full((B,), host_i32(bl) != 0))
    if bool(on.any()):
        old_rows += int((covered & on[:, None]).sum())
    nb = int(used[:, :L].sum()) * row + old_rows * row
    bloom = k.get("bloom_dx") is not None
    if bloom:
        undrawn = (~dem.bloom_drawn(k["bloom_dx"], k["bloom_scan"],
                                    k["av_len"], w)).sum(-1).cpu()
        nb += int(torch.gather(undrawn, 1, last.clamp(min=0))[
            covered & ~on[:, None]].sum()) * 3
        nb += nbytes(k["bloom_dx"], k["bloom_scan"])
    n = out.numel() // 16
    blocks = B * -(-outh // 32)
    return (nb + nbytes(beg, end, active, out),
            n * (20 + (16 if bool(on.any()) else 0) + (40 if bloom else 0))
            + blocks * L * 12, None)


def work_hsync(a, k, out):
    """Bytes: the samples each active line's search needs, up to its first
    crossing (the kernel also stages each line's look-ahead span, which the
    function does not need), the flags, hsync0 and the output.  Ops: an add
    and a compare a probed sample, 6 a line.  Chain: 15 dependent ops an
    active line in csrc/hsync.cu (the window's offset 3, a shuffle, the
    funnel, two dp4a and their sum, the compare, the warp min, the move 2,
    the wrap 2, the flag), the load off it; a shuffle and the warp min take
    longer than the probe's dependent op."""
    from ntsc_crt_tpu_torch.ops import fastpath
    field, line_row, active, h0 = a
    HP = field.shape[2] + k["pad"]
    rows2 = fastpath.line_samples(field, line_row,
                                  torch.arange(HP, device=field.device))
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
    return (probed + nbytes(line_row, active, h0, out),
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


def work_noise(a, k, out):
    """Bytes: a byte read and a byte written a sample, the seeds, knobs and
    last states (the tables are positions of the generator the function
    steps, not data it must read).  Ops: a sample's step, byte (shift, and,
    subtract), product and shift, add, clamp 2, unpack and pack — 11."""
    analog, apow, csum, rn, nz = a
    return nbytes(analog, rn, nz, *out), analog.numel() * 11, None


def work_vhs_noise(a, k, out):
    """Bytes: regions B+C's samples read and written, region B's entry
    states, region C's three-call factors, the knobs, the band lines and
    the returned states, and of the band table the entries this data's
    band tests pass (noise.vhs_noise_bc_draws).  Ops: per sample r1 2, st2
    1, m1 4, the upper-edge test 3, rC 2, the lower-edge test 5, the pick
    2, the byte 3, product, shift, add and clamp 5, the addresses 5 — 32;
    region C's entry 11 more (K5's step 8, the stream's multiply-add 3)."""
    from ntsc_crt_tpu_torch.ops.kernels import noise
    x, entB, a3, c3, cs, band_line, nz = a
    B, nBC = x.shape[0], cs.shape[1]
    _, _, band = noise.vhs_noise_bc_draws(entB, a3, c3, N=x.shape[1],
                                          H=k["H"])
    rows = torch.zeros((8, nBC), dtype=torch.bool, device=x.device)
    rows[(band_line - 10).long()] |= band     # the (line, sample) pairs read
    cs_bytes = int(rows.sum()) * cs.element_size()
    return (2 * B * nBC + nbytes(entB, a3, c3, band_line, nz, *out[1:])
            + cs_bytes, B * (nBC * 32 + a3.shape[0] * 11), None)


def work_nes(a, k, out):
    """Bytes: the PPU pixels read, every field sample written (the pass
    writes the skeleton and the burst too) and the ccf export, the knobs
    and the tables.
    Ops: per picture (and border) sample its sx, PPU load, mask, table row
    and shared load, and its byte's pack — 10 (csrc/nes.cu), 1 (a word's
    quarter of a constant store) elsewhere; per slot its stored-byte table,
    12 x 512 entries of an add, a multiply, a division by 100 (3) and a
    shift — 6."""
    analog, ppu, table, *knobs = a
    B, V, H = analog.shape
    drawn = np.zeros(V * H, bool)
    f = ((k["yo"] + np.arange(k["desth"]))[:, None] * H + k["xo"]
         + np.arange(k["destw"])[None, :])
    drawn[f[f < V * H]] = True
    if k["draw_border"]:
        r0, r1, c0 = k["box"]
        drawn.reshape(V, H)[r0:r1, c0:] = True
    n = int(drawn.sum()) * B
    return (nbytes(ppu, table, *knobs, *out),
            n * 10 + (B * V * H - n) + B * 12 * 512 * 6, None)


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
    """One kernel: its wrapper (module attribute `wrapper`), plain version
    and work counter; `inplace` if it writes its first argument in place
    (K12, K13)."""

    def __init__(self, mod, wrapper, plain, work, inplace=False):
        self.mod, self.wrapper = mod, wrapper
        self.plain, self.work, self.inplace = plain, work, inplace

    def fresh(self, a):
        """The arguments a call may take: an in-place kernel's first one
        copied, so that each call starts from the same values."""
        return (a[0].clone(), *a[1:]) if self.inplace else a


def kernel_modules():
    """name -> Kernel, for every kernel of ORIGIN; the name is also its
    key in build.LAUNCHES."""
    from ntsc_crt_tpu_torch.ops.kernels import (ccf, decode, encode, hsync,
                                                nes, noise, place, probe,
                                                rowfilters, scanconv, vhs)
    dec = Kernel(decode, "decode_rows", decode.decode_rows_plain, work_decode)
    return {
        "encode_rows": Kernel(encode, "encode_rows", encode.encode_rows_plain,
                              work_encode),
        "encode_rows_field": Kernel(encode, "encode_field",
                                    encode.encode_field_plain,
                                    work_encode_field),
        "decode_rows": dec,
        "decode_rows_conv": dec,
        "decode_rows_bloom": dec,
        "bloom_line_width": Kernel(decode, "bloom_line_width",
                                   decode.bloom_line_width_plain,
                                   work_line_width),
        "hsync_chase": Kernel(hsync, "hsync_chase", hsync.hsync_chase_plain,
                              work_hsync),
        "ccf_ema": Kernel(ccf, "ccf_ema", ccf.ccf_ema_plain, work_ccf),
        "vhs_region_b_entries": Kernel(vhs, "vhs_region_b_entries",
                                       vhs.vhs_region_b_entries_plain,
                                       work_vhs),
        "inject_noise": Kernel(noise, "inject_noise",
                               noise.inject_noise_plain, work_noise),
        "vhs_noise_bc": Kernel(noise, "vhs_noise_bc",
                               noise.vhs_noise_bc_plain, work_vhs_noise,
                               inplace=True),
        "nes_square": Kernel(nes, "nes_square", nes.nes_square_plain,
                             work_nes, inplace=True),
        "place_rows_uniform": Kernel(place, "place_rows_uniform",
                                     place.place_rows_uniform_plain,
                                     work_place),
        "place_rows_uniform_bloom": Kernel(place, "place_rows_uniform",
                                           place.place_rows_uniform_plain,
                                           work_place),
        "place_rows_general": Kernel(place, "place_rows_general",
                                     place.place_rows_general_plain,
                                     work_place_general),
        "iir_lowpass_rows": Kernel(rowfilters, "iir_lowpass_rows",
                                   rowfilters.iir_lowpass_rows_plain,
                                   work_iir),
        "eq_threeband_rows": Kernel(rowfilters, "eq_threeband_rows",
                                    rowfilters.eq_threeband_rows_plain,
                                    work_eq3),
        "scanconv_rows": Kernel(scanconv, "scanconv_rows",
                                scanconv.scanconv_rows_plain, work_scanconv),
        "probe": Kernel(probe, "probe", probe.probe_plain, work_probe)}


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


def capture_kernel_inputs(pipeline, cfg, B, names, dev, kw, some=False,
                          size=(OUTW, OUTH)):
    """The arguments each named kernel's wrapper receives on the second
    step of a batch-B run (a locked, non-trivial state) into a `size`
    (outw, outh) output; some=True: of those the step calls."""
    mods = kernel_modules()
    imgs = frames_for(cfg, B, 240, 320, B, dev)
    st = pipeline.init_batch(cfg, B, *size, device=dev)
    with eager_steps(pipeline):
        st = pipeline.step_batch(cfg, st, imgs, *path_args(B, 0, dev),
                                 noise=12, **kw)
    seen = {}
    inplace = {mods[n].wrapper: mods[n] for n in names if mods[n].inplace}

    def record(wrapper, fn):
        def rec(*a, **k):
            seen[wrapper] = (inplace[wrapper].fresh(a) if wrapper in inplace
                             else a, k)
            return fn(*a, **k)
        return rec

    targets = {(mods[n].mod, mods[n].wrapper) for n in names}
    with eager_steps(pipeline), patched(sorted(targets, key=lambda t: t[1]),
                                        record):
        pipeline.step_batch(cfg, st, imgs, *path_args(B, 1, dev), noise=12,
                            **kw)
    return {n: seen[mods[n].wrapper] for n in names
            if not some or mods[n].wrapper in seen}


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
    stacked = scanconv.demod_rows(*a[:6], av_len=k["av_len"])
    R = stacked.shape[0] * stacked.shape[1]
    cs = [torch.tensor([c[j] for c in k["coefs"]], dtype=torch.int32,
                       device=a[0].device).repeat(R) for j in range(5)]
    return (stacked.reshape(-1, k["av_len"]).contiguous(), *cs), {}


def k7_rows(a, k):
    """K7's arguments from K1's (k7_args): the Y/I/Q stack as (R, destw)
    rows, each with its channel's coefficient."""
    yiq, c = k7_args(a, k)
    x = yiq.reshape(-1, yiq.shape[-1]).contiguous()
    return (x, c.repeat(x.shape[0] // 3)), {}


# kernels that no path hands arguments of its own: name -> (the kernels
# whose captured arguments they are derived from, the first the path calls,
# the derivation); K1's field mode takes K1's arguments first
K1_MODES = ("encode_rows_field", "encode_rows")
DERIVED = {"iir_lowpass_rows": (K1_MODES, k7_rows),
           "eq_threeband_rows": (("decode_rows",), k8_args)}


def kernel_inputs(pipeline, cfg, B, names, dev, kw):
    """capture_kernel_inputs, with K7's and K8's arguments derived from the
    K1 and K2 arguments of the same step (DERIVED)."""
    src = sorted({s for n in names
                  for s in (DERIVED[n][0] if n in DERIVED else (n,))})
    seen = capture_kernel_inputs(pipeline, cfg, B, src, dev, kw, some=True)

    def derived(n):
        srcs, fn = DERIVED[n]
        return fn(*next(seen[s] for s in srcs if s in seen))
    return {n: derived(n) if n in DERIVED else seen[n] for n in names}


def k9_args(eqd, a, k):
    """K9's rows from K8's output and K2's arguments: oy = eq << 4, oi/oq =
    eq >> 3 (crt_core.c:540), (B * L, av_len) each."""
    av = k["av_len"]
    e = eqd.reshape(-1, 3, av)
    return ((e[:, 0] << 4).contiguous(), (e[:, 1] >> 3).contiguous(),
            (e[:, 2] >> 3).contiguous(), a[6].reshape(-1).contiguous()), \
        dict(outw=k["outw"])


def wrap_share(name, a, k):
    """For K2 (each mode), K3 and bloom_line_width, which read each line in
    place from the field (a, k: their arguments): the share of the lines
    that start on the field's last row and so continue on its row 0 (the
    wrap); None for the other kernels."""
    if not (name.startswith("decode_rows")
            or name in ("hsync_chase", "bloom_line_width")):
        return None
    field, line_row = a[0], a[1]
    return float((line_row == field.shape[1] - 1).double().mean())


def check_kernel(name, label, B, a, k, rows):
    """The kernel against its plain version on the same inputs at 0 LSB,
    both timed; records and prints the row (with wrap_share's share of
    wrapping lines); returns the kernel's result."""
    kd = kernel_modules()[name]
    kern = getattr(kd.mod, kd.wrapper)
    got, want = kern(*kd.fresh(a), **k), kd.plain(*kd.fresh(a), **k)
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
    share = wrap_share(name, a, k)
    if share is not None:
        chain += f", wrapping lines {share:.6f}"
    print(f"kernel {name} batch {B} ({label}) shapes "
          f"{[tuple(g.shape) for g in got_t]}: {ms:.4f} ms (behind a spin "
          f"{spin_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}){chain}, max |err| {err}",
          flush=True)
    rows.setdefault(name, {})[(label, B)] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, **({} if share is None else
                              dict(wrap_share=share)))
    return got


def gate_wrap(name, label, B, a, k) -> None:
    """Fails the run unless some line of these in-place readers' inputs
    wraps: the parity gate must exercise the wrap."""
    share = wrap_share(name, a, k)
    if share is not None and share <= 0:
        raise SystemExit(f"{name} {label} batch {B}: no line starts on the "
                         "field's last row, so the wrap went untested")


def phase_kernels(pipeline, systems, dev):
    """Each kernel vs its plain version at batch 1 and 64, on the inputs
    each path hands it.  Returns {name: {(label, B): row}}, a kernel's
    first label being the one its JSON row reports."""
    from ntsc_crt_tpu_torch.ops.kernels import probe, scanconv
    groups = ((systems.NTSC, ("encode_rows_field", "decode_rows",
                              "hsync_chase", "ccf_ema", "place_rows_uniform",
                              "inject_noise"), {}),
              (systems.NTSC, ("decode_rows_conv", "inject_noise"), CONV7),
              (systems.NTSC, ("decode_rows_bloom", "bloom_line_width",
                              "place_rows_uniform_bloom", "inject_noise"),
               BLOOM),
              (systems.NTSCVHS, ("encode_rows_field", "ccf_ema",
                                 "vhs_region_b_entries", "inject_noise",
                                 "vhs_noise_bc"), VHS_KW),
              (systems.NTSC, ("encode_rows_field",), BLOOM),
              (systems.PV1K, ("encode_rows_field", "decode_rows",
                              "hsync_chase", "ccf_ema", "inject_noise"), {}),
              (systems.SNES, ("encode_rows_field", "ccf_ema"), {}),
              (systems.NESRGB, ("encode_rows",), {}),
              (systems.NES, ("nes_square", "inject_noise"), {}),
              (systems.NES, ("nes_square",), NES_BORDER))
    rows = {}
    for cfg, names, kw in groups:
        label = path_label(cfg, kw)
        for B in KERNEL_BATCHES:
            seen = capture_kernel_inputs(pipeline, cfg, B, names, dev, kw)
            got = {n: check_kernel(n, label, B, *seen[n], rows)
                   for n in names}
            if cfg is systems.NTSC:
                for n in names:
                    gate_wrap(n, label, B, *seen[n])
            k1 = [n for n in K1_MODES if n in names]
            if k1 and cfg.do_bandlimiting:
                check_kernel("iir_lowpass_rows", label, B,
                             *k7_rows(*seen[k1[0]]), rows)
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
    # K6's general mode on the live window's rows: 832x624, 624 rows of
    # NES's 240 lines, off the uniform gate
    for B in (*KERNEL_BATCHES, MAIN_BATCH):
        a, k = capture_kernel_inputs(pipeline, systems.NES, B,
                                     ("place_rows_general",), dev, {},
                                     size=LIVE_SIZE)["place_rows_general"]
        check_kernel("place_rows_general", "NES 832x624", B, a, k, rows)
    phase_scan_kernels(pipeline, systems, dev, (MAIN_BATCH,), rows)
    x = probe.probe_input(PROBE_BLOCKS, dev)
    for pattern in ("eq3", "eq1", "peak"):
        check_kernel("probe", pattern, PROBE_BLOCKS, (x, pattern),
                     dict(iters=PROBE_ITERS), rows)
    return rows


def phase_scan_kernels(pipeline, systems, dev, batches, rows):
    """K2 in each mode on the inputs NTSC's decodes hand it (3-band, conv7,
    bloom), K3 and K4 on the inputs NTSC's and PV1K's line scans hand them,
    K5 on NTSCVHS's noise inputs, bloom_line_width on the bloom path's, K7
    on the Y/I/Q rows of NTSC's and PV1K's K1 inputs and K8 on NTSC's K2
    inputs' (DERIVED), K11 on every main path's noise inputs, K12 on
    NTSCVHS's and K13 on NES's, each against its plain version at each
    batch of `batches`, timed and bounded as in phase_kernels (the NTSC
    paths' in-place readers gated on their wrapping lines, gate_wrap)."""
    groups = ((systems.NTSC, ("decode_rows", "hsync_chase", "ccf_ema",
                              "inject_noise"), {}),
              (systems.NTSC, ("decode_rows_conv",), CONV7),
              (systems.NTSCVHS, ("encode_rows_field",), VHS_KW),
              (systems.NTSC, ("encode_rows_field",), BLOOM),
              (systems.PV1K, ("hsync_chase", "ccf_ema", "inject_noise"), {}),
              (systems.NTSCVHS, ("vhs_region_b_entries", "inject_noise",
                                 "vhs_noise_bc"), VHS_KW),
              (systems.NTSC, ("decode_rows_bloom", "bloom_line_width",
                              "place_rows_uniform_bloom", "inject_noise"),
               BLOOM),
              (systems.NTSC, ("inject_noise",), CONV7),
              (systems.NES, ("nes_square", "inject_noise"), {}),
              (systems.NTSC, ("iir_lowpass_rows", "eq_threeband_rows"), {}),
              (systems.PV1K, ("iir_lowpass_rows",), {}))
    for cfg, names, kw in groups:
        for B in batches:
            seen = kernel_inputs(pipeline, cfg, B, names, dev, kw)
            for n in names:
                check_kernel(n, path_label(cfg, kw), B, *seen[n], rows)
                if cfg is systems.NTSC:
                    gate_wrap(n, path_label(cfg, kw), B, *seen[n])


# (L, pad, H, W, c0, far) of K3 inputs whose estimate walks across H both
# ways: windows inside the lines' H + pad samples, from below 0, past
# them, W at the kernel's limit, and its one-lane path: estimates from
# outside [0, H) (hsync0 up to `far` lines of H off), W >= H
# (tests/test_torch_kernels.py K3_EDGES); each on a field of L + 8 rows,
# line l on row l and on rows that pass the last row to row 0
K3_EDGES = ((60, 88, 40, 8, 0, 0), (60, 88, 40, 6, 0, 0),
            (40, 24, 104, 8, 9, 0), (50, 8, 40, 8, -16, 0),
            (70, 0, 60, 6, -3, 0), (33, 50, 150, 16, 5, 0),
            (50, 24, 40, 8, 0, 3), (40, 54, 10, 12, 0, 0))
# (L, m, CC, VP) of K4 inputs: the kernel's limits over ragged chunks, SNES's
# rows, one line
K4_EDGES = ((37, 16, 5, 5), (240, 10, 4, 3), (1, 3, 2, 2))
# (H, n_steps) of K5 inputs: a band a step, the last band cut short by 5
# steps, 9 steps past 19H, NTSC's H cut short (as the CPU tests' K5_EDGES,
# tests/test_torch_kernels.py)
K5_EDGES = ((1, 19), (7, 19 * 7 - 5), (7, 19 * 7 + 9), (40, 19 * 40),
            (40, 19 * 40 - 5), (40, 19 * 40 + 9), (910, 19 * 910 - 5))
# (L, H, av, V) of bloom_line_width inputs: NTSC's field, odd rows whose
# 16-byte chunks straddle rows and the tensor's end with L past the
# kernel's 256-line pass, windows wider than a row, one-byte rows; each
# with line l on row l and on rows that pass the last row to row 0
LINE_EDGES = ((240, 910, 753, 262), (300, 61, 50, 302), (7, 13, 30, 8),
              (9, 1, 3, 10))
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
# K11 and K12 seeds and knobs, dealt over the slots: the int32 edges, and a
# knob whose product with the byte wraps int32
RN_EDGES = (0, 1, -1, -2**31, 2**31 - 1)
NOISE_EDGES = (0, 7, 127, 1 << 24, -3, 40)
# (B, N, n, shift, off) of K11 inputs: NES's rows (N 2 mod 4), VHS region A
# (n odd, the rest copied), rows shorter than a thread's 16-sample run and a
# warp's 1024 (runs that cross slots and meet n), one sample; the input `off`
# bytes past a 16-byte boundary (the byte path); shift 16 NTSC's LCG, 17
# region A's two crt_rand calls (tests/test_torch_noise.py K11_CASES)
K11_EDGES = ((3, 909 * 262, 909 * 262, 16, 0),
             (5, 910 * 262, 910 * 262 - 25 * 910 + 1, 17, 0),
             (33, 7, 5, 16, 0), (33, 7, 5, 17, 1), (3, 1030, 517, 17, 0),
             (9, 530, 512, 16, 1), (1, 1, 1, 16, 0), (4, 2046, 1023, 17, 3))
# (B, H, N) of K12 inputs: regions B+C of 25H - 1 samples, odd (H 910, 8, 2)
# and even (909, 7), after a region A of both parities, at odd B
K12_EDGES = ((1, 910, 910 * 262), (3, 909, 909 * 262), (33, 7, 174),
             (5, 8, 260), (3, 2, 80))
# (B, PPU (h, w), every 9-bit pixel, xoffset, yoffset, border_color or None,
# field offset in bytes) of K13 inputs (tests/test_torch_nes.py CASES):
# PPU sizes 256x240, 1x1 and 255x239, all 512 pixels with the border at
# 0x1FF, a picture spilling past HRES, one clipped at the field's end, both
# with the border, a field off the 4- and 16-byte grids; at B 17 the slots'
# fields (238,158 bytes, 14 mod 16) start at every even residue mod 16 of
# the 16-byte grid that K13 stores on (odd ones with the field 3 bytes
# off), with rows spilling past HRES and the border; the knobs dealt over
# the slots reach negative dot-crawl offsets and the black and white
# points where the int32 sums and the int8 store wrap
NES_EDGES = ((1, (240, 256), False, 0, 0, None, 0),
             (3, (1, 1), False, 0, 0, None, 0),
             (3, (239, 255), False, 0, 0, None, 0),
             (5, (240, 256), True, 0, 0, 0x1FF, 0),
             (3, (240, 256), False, 100, 0, None, 0),
             (3, (239, 255), False, 0, 20, None, 0),
             (33, (240, 256), False, 33, 7, 0x1FF, 0),
             (3, (240, 256), True, 0, 20, 0x1FF, 1),
             (17, (240, 256), False, 0, 0, None, 0),
             (17, (240, 256), True, 100, 0, 0x1FF, 0),
             (17, (239, 255), False, 100, 20, 0x1FF, 3))
# (B, L, w, ratio, blend, scanlines, parity of slot 0) of K6 bloom-mode
# inputs: 16-byte rows (w * 3 % 16 == 0) and byte rows, every ratio, blend
# and scanline gap, both field parities; the lines drawn wholly, not at
# all, to mid-row, and with dx and scan near the int32 edge (bloom_lines;
# tests/test_torch_bloom_place.py KINDS)
K6_BLOOM_EDGES = ((1, 7, 640, 2, 1, 1, 1), (3, 9, 37, 3, 0, 2, 0),
                  (3, 8, 21, 2, 0, 0, 1), (5, 6, 16, 1, 1, 0, 0),
                  (2, 240, 640, 2, 0, 1, 0), (33, 11, 48, 3, 1, 1, 1))
# K1's field mode: (system, batches, do_bloom, xoffset, yoffset, each
# slot's killed rows in turn, None for no kill): on NTSC-VHS the two cells'
# sizings, a picture spilling past the row end (its tail on killed rows),
# rows clipped at the field's end, a picture starting left of the kill's
# columns; 5-sample chroma and 5 burst classes at PV1K's geometry (the
# cell's: the picture on the first vsync row and over the skeleton's
# prefix) and spilling; SNES's 3 burst classes
FIELD_EDGES = (("NTSCVHS", (1, 5, 33, 2048), False, 0, 0, (0, 6, 17)),
               ("NTSCVHS", (1, 5, 33, 2048), True, 0, 0, None),
               ("NTSCVHS", (1, 5, 33), True, 0, 0, (17, 0, 6)),
               ("NTSCVHS", (1, 5, 33), False, 100, 0, (0, 6, 17)),
               ("NTSCVHS", (1, 5, 33), False, 100, 10, (17, 6, 0)),
               ("NTSCVHS", (1, 5, 33), False, 0, 12, (6, 17, 0)),
               ("NTSCVHS", (1, 5, 33), False, -100, 0, (17, 17, 6)),
               ("PV1K", (1, 5, 33, 2048), False, 0, 0, None),
               ("PV1K", (1, 5, 33), False, 10, 8, None),
               ("SNES", (1, 5, 33), False, 100, 0, None))
DCO_EDGES = (0, -1, -5, -2**31, 2**31 - 1, 4)
BLACK_EDGES = (0, -40000, 2**31 - 1, -2**31, 123)
WHITE_EDGES = (100, 2**31 - 1, -9000, 12345)
HUE_EDGES = (0, 45, -300, 2**31 - 1)


def bloom_lines(rng, B, L, w, av):
    """(dx, scan) int32 (B, L) of bloom lines: each slot's first six lines
    drawn wholly, not at all, to mid-row, past the int32 top of scan (drawn
    again where the sum wraps), at dx's int32 edges and backwards from past
    the end; the rest dealt from these kinds."""
    lim = (av - 1) << 12
    kind = np.where(np.arange(L) < 6, np.resize(np.arange(6), (B, L)),
                    rng.integers(0, 6, (B, L)))
    step = lim // w
    dx = np.choose(kind, [
        rng.integers(0, step, (B, L)), rng.integers(1, 3 * step, (B, L)),
        rng.integers(2 * step, 4 * step, (B, L)),
        rng.integers(1 << 20, 1 << 24, (B, L)),
        rng.choice([2**31 - 1, -2**31, 2**30 + 7, -2**30 - 3], (B, L)),
        -rng.integers(step // 2 + 1, 2 * step, (B, L))])
    scan = np.choose(kind, [
        np.zeros((B, L), np.int64), rng.integers(lim, 2**31, (B, L)),
        rng.integers(-4096, 4096, (B, L)),
        rng.integers(2**31 - (1 << 22), 2**31, (B, L)),
        rng.integers(-2**31, 2**31, (B, L)),
        rng.integers(lim, lim + 8 * step, (B, L))])
    return dx.astype(np.int32), scan.astype(np.int32)


def ragged_cases(dev):
    """K1 and K2 inputs at shapes the paths never give, small: 111 rows (a
    warp's last 15 lanes idle), widths that are not multiples of a tile
    (K1's 64 or 60 samples, K2's 32 pixels) or of 4 bytes, an image wider
    than the line, shifts before 0 and past H, K2's conv4-conv7, and bloom
    rows whose source moves back (dx <= 0, or p*dx wrapping), clamps at
    n_eq - 1 or meets the forced-zero sample, its lines on rows that pass
    the field's last row to row 0, the field one byte off the word grid;
    K3 and K4 at their edges (K3_EDGES, K4_EDGES), K5 at small H, bands cut
    short and steps past 19H from the seeds 0 and 2**32 - 1 (K5_EDGES),
    bloom_line_width on windows from below 0, spilling, past 2H and
    wrapping, with max_e 0, -1 and 96256 (LINE_EDGES), K3's and its lines
    also passing the field's last row to row 0, the wrapping ones on a
    field 3 bytes off the 16-byte grid; the last four at batch 5 and 512;
    K7 and K8 at the
    edges of their ring (ROW_EDGES) and with x off y's line grid
    (ROW_OFF_GRID), on full-range int32 samples, whose sums wrap; K11 and
    K12 at odd batches, NES's rows, short rows and unaligned input
    (K11_EDGES, K12_EDGES) at the seed and knob edges; K13 at the PPU sizes,
    pixels, offsets and knobs of NES_EDGES; K6's bloom mode at the shapes,
    knobs and lines of K6_BLOOM_EDGES; K1's field mode at FIELD_EDGES.
    Yields (kernel, label, args, kwargs)."""
    from ntsc_crt_tpu_torch.models import demodulate as dem
    from ntsc_crt_tpu_torch.models import systems
    from ntsc_crt_tpu_torch.ops import filters, lcg
    from ntsc_crt_tpu_torch.ops.kernels import decode, nes, vhs
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
    L, H, av, V = 37, 200, 150, 40
    three = dem._eq_coefs(ntsc)

    def field_of(B, V, H, off, lo=-128):
        """A seeded int8 field (B, V, H) starting `off` bytes past the
        allocation's start."""
        buf = t(rng.integers(lo, 128, B * V * H + off).astype(np.int8))
        return buf[off:].view(B, V, H)

    def rows_of(B, L, V, wrap):
        """Line l on row l, or (wrap) on rows that pass the last to row 0."""
        first = V - L // 2 if wrap else 0
        return t(np.broadcast_to((first + np.arange(L)) % V, (B, L)).astype(
            np.int32))

    modes = ([("decode_rows", 4, three, 641), ("decode_rows", 5, three, 37),
              ("decode_rows", 4, three, 640)]
             + [("decode_rows_conv", 4, ("conv", taps), outw)
                for taps, outw in ((4, 641), (5, 37), (6, 640), (7, 641))]
             + [("decode_rows_bloom", 4, three, 641),
                ("decode_rows_bloom", 5, three, 37),
                ("decode_rows_bloom", 4, ("conv", 7), 640)])
    for name, cc, coefs, outw in modes:
        a = (field_of(B, V, H, 1, lo=-127), rows_of(B, L, V, True),
             t(i32(-40, 2 * H - 20, (B, L))),
             t(i32(-60000, 60000, (B, L, cc))),
             t(i32(-60000, 60000, (B, L, cc))), t(i32(-20, 20, (B, L))),
             t(i32(150, 200, (B, L))))
        k = dict(coefs=coefs, av_len=av, outw=outw)
        label = f"cc {cc}, outw {outw}, wrapping lines" + (
            f", conv{coefs[1]}" if coefs[0] == "conv" else "")
        if name == "decode_rows_bloom":
            k.update({n: t(v) for n, v in
                      decode.bloom_steps(rng, B, L, av, outw, cc).items()})
        yield name, label, a, k
    for B in (5, MAIN_BATCH):  # 5: a part-full block of K3's four warps
        for (L, pad, H, W, c0, far), wrap in itertools.product(
                K3_EDGES, (False, True)):
            V = L + 8
            kind = rng.integers(0, 4, (B, V))[..., None]
            cols = np.arange(H)
            edge = rng.integers(0, H, (B, V))[..., None]
            rows = rng.integers(-30, 60, (B, V, H))
            rows = np.where((kind == 3) & (cols >= edge) & (cols < edge + 40),
                            -40, rows)
            rows = np.where(kind == 1, -100, np.where(kind == 2, 100, rows))
            act = rng.random((B, L)) > 0.2
            act[:, 5:15] = False
            yield ("hsync_chase", f"B {B}, L {L}, pad {pad}, H {H}, W {W}, "
                   f"c0 {c0}, hsync0 in [{-far * H}, {H + far * H})"
                   + (", wrapping lines" if wrap else ""),
                   (t(rows.astype(np.int8)), rows_of(B, L, V, wrap), t(act),
                    t(i32(-far * H, H + far * H, B))),
                   dict(pad=pad, W=W, c0=c0, thresh=-160))
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
        for (L, H, av, V), wrap in itertools.product(LINE_EDGES,
                                                     (False, True)):
            # windows inside the row, from below 0, spilling, past 2H, or
            # from any int32 (xpos + av wraps); max_e 0, -1, 96256
            kind = rng.integers(0, 5, (B, L))
            lo = np.array([0, -av - 5, H - av, 2 * H - av, -2**31])[kind]
            hi = np.array([max(H - av, 0) + 1, 0, H + 5, 3 * H, 2**31])[kind]
            max_e = rng.integers(-2**31, 2**31, B)
            max_e[:3] = [0, -1, 96256]
            yield ("bloom_line_width",
                   f"B {B}, L {L}, H {H}, av {av}, V {V}"
                   + (", wrapping lines, field 3 bytes off 16" if wrap
                      else ""),
                   (field_of(B, V, H, 3 if wrap else 0),
                    rows_of(B, L, V, wrap),
                    t((lo + (rng.random((B, L)) * (hi - lo))).astype(
                        np.int64).astype(np.int32)),
                    t(max_e.astype(np.int32))), dict(av_len=av))
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
    deal = lambda v, B: t(np.resize(np.array(v, np.int32), B))  # noqa: E731
    for B, N, n, shift, off in K11_EDGES:
        ga, gc = ((lcg.LCG_A, lcg.LCG_B) if shift == 16
                  else (vhs.A2, vhs.C2))
        apow, csum = lcg._lcg_tables(n, ga, gc)
        buf = t(rng.integers(-128, 128, B * N + off).astype(np.int8))
        yield ("inject_noise", f"B {B}, N {N}, n {n}, shift {shift}"
               + (f", input {off} bytes past 16" if off else ""),
               (buf[off:].view(B, N), t(apow.view(np.int32)),
                t(csum.view(np.int32)), deal(RN_EDGES, B),
                deal(NOISE_EDGES, B)), dict(shift=shift, ga=ga, gc=gc))
    for B, H, N in K12_EDGES:
        nB, nC = 19 * H, 6 * H - 1
        apow3, csum3 = lcg._lcg_tables(3 * nC, lcg.RAND_A, lcg.RAND_B)
        a3 = np.concatenate([np.ones(1, np.uint32), apow3[2::3]])[:nC]
        c3 = np.concatenate([np.zeros(1, np.uint32), csum3[2::3]])[:nC]
        yield ("vhs_noise_bc", f"B {B}, H {H}, N {N}",
               (t(rng.integers(-128, 128, (B, N)).astype(np.int8)),
                vhs.vhs_region_b_entries(deal(RN_EDGES, B), n_steps=nB, H=H),
                t(a3.view(np.int32)), t(c3.view(np.int32)),
                t(rng.integers(-64, 65, (8, nB + nC)).astype(np.int32)),
                deal(range(10, 18), B), deal(NOISE_EDGES, B)), dict(H=H))
    for B, L, w, ratio, blend, sl, parity in K6_BLOOM_EDGES:
        fp, av = ratio // 2, ntsc.av_len
        dx, scan = bloom_lines(rng, B, L, w, av)
        yield ("place_rows_uniform_bloom", f"B {B}, L {L}, w {w}, ratio "
               f"{ratio}, blend {blend}, scanlines {sl}, slot 0 "
               + ("odd" if parity else "even"),
               (t(rng.integers(0, 256, (B, L, w, 3), dtype=np.uint8)),
                t(rng.integers(0, 256, (B, ratio * L, w, 3), dtype=np.uint8)),
                t(((np.arange(B) + parity) % 2 * fp).astype(np.int32))),
               dict(blend=bool(blend), scanlines=sl, ratio=ratio, fp=fp,
                    bloom_dx=t(dx), bloom_scan=t(scan), av_len=av))
    nes_cfg = systems.NES
    V, H = nes_cfg.vres, nes_cfg.hres
    for B, (h, w), every, xoff, yoff, border, off in NES_EDGES:
        ppu = (np.resize(np.arange(512, dtype=np.uint16), (B, h, w)) if every
               else rng.integers(0, 1 << 16, (B, h, w)).astype(np.uint16))
        field = t(rng.integers(-128, 128, B * V * H + off).astype(np.int8))
        yo = nes_cfg.top + yoff     # the unoptimized build's burst past 240
        yield ("nes_square", f"B {B}, PPU {w}x{h}, xoffset {xoff}, yoffset "
               f"{yoff}, border {border}" + (", every pixel" if every else "")
               + (f", field {off} bytes off the grid" if off else ""),
               (field[off:].view(B, V, H), t(ppu),
                nes.square_table(torch.device(dev)), deal(DCO_EDGES, B),
                deal(BLACK_EDGES, B), deal(WHITE_EDGES, B),
                deal((border or 0, 0x21, -1), B), deal(HUE_EDGES, B),
                nes.burst_sines(torch.device(dev))),
               dict(xo=(nes_cfg.av_beg + xoff) & ~3, yo=yo,
                    destw=nes_cfg.av_len, desth=nes_cfg.lines,
                    draw_border=border is not None,
                    box=(nes_cfg.top, nes_cfg.bot + 3, nes_cfg.lav_beg),
                    vp=nes_cfg.cc_vper, black_level=nes_cfg.black_level,
                    skeleton=(nes_cfg.sync_beg, nes_cfg.bw_beg, 259,
                              327 * H // 341, nes_cfg.sync_level,
                              nes_cfg.blank_level),
                    burst_box=((0, 259) if yo + nes_cfg.lines > V
                               else (yo, nes_cfg.lines))
                    + (nes_cfg.cb_beg, nes_cfg.burst_len),
                    cc=nes_cfg.cc_samples, vert_step=nes_cfg.vert_step,
                    burst_level=nes_cfg.burst_level))
    yield from field_cases(dev, rng)


def field_cases(dev, rng):
    """K1's field mode at FIELD_EDGES: random pictures, carrier tables,
    burst samples (a set a vertical class) and previous fields, the slots'
    parities alternating, placed as the system's encoder places them."""
    from ntsc_crt_tpu_torch.models import modulate, systems
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v), device=dev)  # noqa
    i32 = lambda lo, hi, n: t(rng.integers(lo, hi, n).astype(np.int32))  # noqa
    h, w = 48, 64
    for name, batches, bloom, xoff, yoff, kills in FIELD_EDGES:
        cfg = systems.SYSTEMS[name]
        skel, mask_end, vrows = modulate._field_tables(cfg, dev)
        cc = cfg.cc_samples
        destw, desth = modulate._dest_size(cfg, False, w, h, bloom)
        xo = cfg.av_beg + xoff + (cfg.av_len - destw) // 2
        xo -= xo % cc
        yo = cfg.top + yoff + (cfg.lines - desth) // 2
        for B in batches:
            a = (t(rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)),
                 i32(0, h, (B, desth)), i32(-32, 33, (B, desth, cc)),
                 i32(-32, 33, (B, desth, cc)), i32(50, 150, B),
                 i32(-20, 30, B),
                 t(rng.integers(-128, 128, (B, cfg.vres, cfg.hres),
                                dtype=np.int8)),
                 skel, mask_end, vrows, t(np.arange(B, dtype=np.int32) % 2),
                 t(rng.integers(-128, 128, (B, cfg.cc_vper, cfg.burst_len),
                                dtype=np.int8)),
                 None if kills is None else t(np.resize(
                     np.array(kills, np.int32), B)))
            yield ("encode_rows_field",
                   f"{name}, B {B}, {'bloom' if bloom else 'full'} sizing, "
                   f"xoffset {xoff}, yoffset {yoff}, kills {kills}", a,
                   dict(coefs=modulate._iir_coefs(cfg), xo=xo, yo=yo,
                        destw=destw, cb_beg=cfg.cb_beg, bw_beg=cfg.bw_beg,
                        blank=cfg.blank_level))


def phase_ragged(dev):
    """K1-K5 (K1's field mode too), bloom_line_width, K7, K8, K11, K12, K13
    and K6's bloom mode against their plain versions on the ragged_cases
    inputs, at 0 LSB (K2's through
    decode_rows_plain_any_shift: the shifts go below 0)."""
    from ntsc_crt_tpu_torch.ops.kernels import decode
    mods = kernel_modules()
    for name, label, a, k in ragged_cases(dev):
        kd = mods[name]
        prev = a[6].clone() if name == "encode_rows_field" else None
        got = getattr(kd.mod, kd.wrapper)(*kd.fresh(a), **k)
        want = (decode.decode_rows_plain_any_shift(*a, **k)
                if name.startswith("decode_rows")
                else kd.plain(*kd.fresh(a), **k))
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if prev is not None and not torch.equal(a[6], prev):
            raise SystemExit(f"{name} ragged ({label}): the caller's field "
                             "was written")
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
                                 ("encode_rows_field", "decode_rows"), dev,
                                 {})
    yiq, c = k7_args(*seen["encode_rows_field"])
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
    "ntsc_decode_rows": ("decode_rows", "NTSC", {}),
    "ntsc_hsync_chase": ("hsync_chase", "NTSC", {}),
    "ntsc_ccf_ema": ("ccf_ema", "NTSC", {}),
    "ntsc_vhs_region_b_entries": ("vhs_region_b_entries", "NTSCVHS", VHS_KW),
    "ntsc_bloom_line_width": ("bloom_line_width", "NTSC", BLOOM),
    "ntsc_iir_lowpass_rows": ("iir_lowpass_rows", "NTSC", {}),
    "ntsc_eq_threeband_rows": ("eq_threeband_rows", "NTSC", {}),
    "ntsc_inject_noise": ("inject_noise", "NTSC", {}),
    "ntsc_vhs_noise_bc": ("vhs_noise_bc", "NTSCVHS", VHS_KW),
    "ntsc_nes_square": ("nes_square", "NES", {}),
}


def time_variants(sources, batches=(1, 64, MAIN_BATCH),
                  check: bool = True) -> None:
    """Design runs, on the card: each CUDA source of `sources` — a copy of
    a kernel's csrc/*.cu with its design changed and its entry points kept —
    is built alone, launched through the package's own wrapper, held to the
    plain version at 0 LSB and timed and bounded as phase_kernels does, on
    the inputs the kernel's path (VARIANT_PATHS) hands it at each batch;
    every entry point of VARIANT_PATHS that a source defines is timed (a
    copy of csrc/rowfilters.cu: K7 and K8).  The inputs of each kernel and
    batch are captured once and shared by the variants.  check=False times
    probes instead, copies with a part of the work taken out, whose results
    differ: each is timed behind the spin and reported equal to the
    package's kernel or not:

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
            kd = kernel_modules()[name]
            kern = getattr(kd.mod, kd.wrapper)
            ref = None if check else kern(*kd.fresh(a), **k)
            for src, fns in users:
                build._lib = types.SimpleNamespace(**fns)
                try:
                    if check:
                        check_kernel(name, f"{path_label(cfg, kw)}, {src}", B,
                                     a, k, rows)
                        continue
                    got = kern(*kd.fresh(a), **k)
                    same = all(torch.equal(g, r) for g, r in zip(
                        *(t if isinstance(t, tuple) else (t,)
                          for t in (got, ref))))
                    ms = cuda_ms(lambda: kern(*a, **k), 20, spin=True)
                    print(f"probe {name} batch {B} ({src}): {ms:.4f} ms "
                          f"behind a spin, equal to the kernel {same}",
                          flush=True)
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


def time_fills(B=MAIN_BATCH) -> None:
    """Yardsticks of K13's and K12's bytes, on the card: PyTorch calls that
    write NES's whole field, fill its picture block (682-byte rows 909
    apart), copy its PPU frames, and add in place over VHS regions B+C,
    each timed behind a spin:

        python3 -c "import chip_smoke as c; c.time_fills()"
    """
    from ntsc_crt_tpu_torch.models import demodulate as dem
    from ntsc_crt_tpu_torch.models import systems
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    nes, vhs = systems.NES, systems.NTSCVHS
    field = torch.zeros((B, nes.vres, nes.hres), dtype=torch.int8, device=dev)
    block = field[:, nes.top:nes.top + nes.lines,
                  nes.av_beg - 1:nes.av_beg - 1 + nes.av_len]
    ppu = torch.zeros((B, 240, 256), dtype=torch.int16, device=dev)
    ppu2 = torch.empty_like(ppu)
    _, nB, nC = dem._vhs_regions(vhs)
    x = torch.zeros((B, vhs.input_size), dtype=torch.int8, device=dev)
    bc = x[:, vhs.input_size - nB - nC:]
    for what, fn, moved in (
            ("fill NES's whole field", lambda: field.fill_(3), field),
            ("fill NES's picture block", lambda: block.fill_(3), block),
            ("copy NES's PPU frames", lambda: ppu2.copy_(ppu), ppu),
            ("add_ in place over VHS regions B+C", lambda: bc.add_(1), bc)):
        ms = cuda_ms(fn, 20, spin=True)
        print(f"yardstick {what}, {nbytes(moved):,} bytes: {ms:.4f} ms "
              "behind a spin", flush=True)


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
             lambda: build.launch("ntsc_iir_lowpass_rows", dev, x.data_ptr(),
                                  c.data_ptr(), y.data_ptr(), R, T),
             want)


def time_mesh(batch=MAIN_BATCH, steps=10) -> None:
    """NTSC steps of `batch` 320x240 frames to 640x480 on cuda:0 alone
    (step_batch), then split over every card (parallel.mesh, the frames on
    cuda:0 as a caller holds them); host ms a step between two
    synchronizations of every card, and the merged state held to the
    one-card run's after two steps:

        python3 -c "import chip_smoke as c; c.time_mesh()"
    """
    from ntsc_crt_tpu_torch.models import pipeline, systems
    from ntsc_crt_tpu_torch.parallel import mesh
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    print(card_line(), flush=True)
    cfg = systems.NTSC
    imgs = frames_for(cfg, batch, 240, 320, 1243, cards[0])

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)

    def run(devs):
        if devs is None:
            st = pipeline.init_batch(cfg, batch, OUTW, OUTH, device=cards[0])
            step = mesh.make_batched_step(cfg, noise=12)
        else:
            st = mesh.init_batch(cfg, batch, OUTW, OUTH, devices=devs)
            step = mesh.make_sharded_step(cfg, devs, noise=12)
        for i in range(2):
            st = step(st, imgs, *path_args(batch, i, cards[0]))
        first = mesh.gather([st] if devs is None else st)   # a copy
        sync_all()
        t0 = time.perf_counter()
        for i in range(steps):
            st = step(st, imgs, *path_args(batch, i, cards[0]))
        sync_all()
        return first, (time.perf_counter() - t0) * 1e3 / steps

    whole, one = run(None)
    print(f"NTSC batch {batch} on {cards[0]}: {one:.4f} ms a step",
          flush=True)
    for n in range(2, len(cards) + 1):
        merged, ms = run(cards[:n])
        same_leaves(merged, whole, f"make_sharded_step over {n} cards")
        print(f"NTSC batch {batch} over {n} cards: {ms:.4f} ms a step "
              f"({one / ms:.3f}x one card); the merged state equals "
              "step_batch's", flush=True)


def time_spatial(steps1=20, stepsB=5, cards=None) -> None:
    """NTSC steps over 1x1, 1x2, 1x4 and 2x2 meshes of distinct cards (as
    many as there are), the frames on cuda:0: batch 1 from a 640x480 image
    and batch 512 from 320x240 images, to 640x480.  Each mesh's state after
    two steps held to step_batch on cuda:0, K1's and K2's shards checked
    (one a card of each row, every line once, a launch a shard); host ms a
    step between two synchronizations of every card, each mesh timed twice
    (in order, then in reverse order, so drift shows); then one batch-1 step
    over the widest 1 x n row under set_sync_debug_mode("error").  cards:
    the devices to use, every CUDA card by default:

        python3 -c "import chip_smoke as c; c.time_spatial()"
    """
    from ntsc_crt_tpu_torch.models import pipeline, systems
    from ntsc_crt_tpu_torch.parallel import mesh, spatial
    cards = cards or [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())]
    card = card_line()
    print(card, flush=True)
    cfg, kw, needed = main_paths(systems)[0]
    shapes = [s for s in ((1, 1), (1, 2), (1, 4), (2, 2))
              if s[0] * s[1] <= len(cards)]
    records = []
    spatial._INSPECT = lambda tag, shards: records.append((tag, shards))
    try:
        for B, h, w, steps in ((1, OUTH, OUTW, steps1),
                               (MAIN_BATCH, 240, 320, stepsB)):
            imgs = frames_for(cfg, B, h, w, 1260, cards[0])
            whole = reference(pipeline, cfg, kw, B, imgs, cards[0])
            usable = [s for s in shapes if B >= s[0]]
            for shape in usable:
                spatial_case(pipeline, cfg, kw, needed, shape,
                             cards[:shape[0] * shape[1]], B, imgs, whole,
                             records)
            ms = {}
            for shape in usable + usable[::-1]:        # mirrored order
                grid = mesh.make_mesh(*shape, cards[:shape[0] * shape[1]])
                st = mesh.init_batch(cfg, B, OUTW, OUTH, devices=grid)
                step = mesh.make_sharded_step(cfg, grid, noise=12)
                for i in range(2):
                    st = step(st, imgs, *path_args(B, i, cards[0]))
                ms.setdefault(shape, []).append(
                    host_ms(step, st, imgs, B, steps, cards[0]))
            base = sum(ms[(1, 1)])
            for shape in usable:
                a, b = ms[shape]
                devs = cards[:shape[0] * shape[1]]
                print(f"NTSC batch {B} over {shape[0]}x{shape[1]} "
                      f"({', '.join(str(d) for d in devs)}): {a:.4f}, "
                      f"{b:.4f} ms a step over {steps} (timed in the order "
                      f"{usable} and back; {base / (a + b):.3f}x 1x1); 2 "
                      "steps equal step_batch, K1 and K2 a launch a shard"
                      f"  [{card}]", flush=True)
    finally:
        spatial._INSPECT = None
    n = max(s[1] for s in shapes if s[0] == 1)
    sync_free_step(cfg, mesh.make_mesh(1, n, cards[:n]),
                   frames_for(cfg, 1, OUTH, OUTW, 1261, cards[0]), cards[0])
    print(f"NTSC batch 1 over 1x{n} ran under set_sync_debug_mode('error'): "
          "no synchronizing op", flush=True)


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

    with eager_steps(pipeline), patched(names, timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times["step"] = (time.perf_counter() - t0) * 1e3
    return times


def profile_line_scan(pipeline, cfg, st, imgs, B, kw, card):
    """The device operations of one step's line scan (models/demodulate.py
    _line_scan: the burst gather and roll, K3, K4, the waves), each torch
    op with its own device time and each port kernel, from one call of
    _line_scan on the step's own arguments under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from ntsc_crt_tpu_torch.models import demodulate as dem
    dev = imgs.device
    seen = {}

    def record(name, fn):
        def rec(*a, **k):
            seen["args"] = (a, k)
            return fn(*a, **k)
        return rec

    with eager_steps(pipeline), patched([(dem, "_line_scan")], record):
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


def phase_syncs(pipeline, systems, dev, gate=True, vhs_batch=2048):
    """One NTSC batch-1 step, one NTSC-VHS step at B 2048 (the benchmark's
    cell: head switching, noise 24) and one video_exact call of 4 frames,
    each run op by op (eager_steps) under
    torch.cuda.set_sync_debug_mode("warn"), each synchronizing op reported
    by the line of the port that called it.  One inside the line scan or
    inside the VHS step, or any of the port's inside video_exact, fails the
    run unless `gate` is off (to run the script on a package from before
    the line scan lost its sync or from before video_exact): a CUDA graph's
    capture of the step would fail on it (models/graphs.py)."""
    import traceback

    from ntsc_crt_tpu_torch.models import demodulate as dem
    cfg, vhs = systems.NTSC, systems.NTSCVHS
    with eager_steps(pipeline):
        img = frames_for(cfg, 1, OUTH, OUTW, 1234, dev)
        st = pipeline.init_batch(cfg, 1, OUTW, OUTH, device=dev)
        st = pipeline.step_batch(cfg, st, img, *path_args(1, 0, dev),
                                 noise=12)
        B = vhs_batch
        g = torch.Generator(device=dev)
        g.manual_seed(1238)
        imgs_v = torch.randint(0, 256, (B, OUTH, OUTW, 3), generator=g,
                               device=dev, dtype=torch.uint8)
        st_v = pipeline.init_batch(vhs, B, OUTW, OUTH, device=dev)
        st_v = pipeline.step_batch(vhs, st_v, imgs_v, *path_args(B, 0, dev),
                                   noise=24, **VHS_KW)
        clip = frames_for(cfg, 4, OUTH, OUTW, 1236, dev)
        single = pipeline.crt_init(cfg, OUTW, OUTH, device=dev)
        video = None
        if gate:
            from ntsc_crt_tpu_torch.models import video
            video.video_exact(cfg, single, clip, noise=12)          # warm
        torch.cuda.synchronize()
        where_now = ["outside"]
        found = {"outside": set(), "scan": set(), "vhs": set(),
                 "video": set()}

        def note(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return
            # the innermost frame of the port, else of this script (a sync
            # the port did not ask for)
            stack = traceback.extract_stack()[:-1]
            port = [f for f in stack if "ntsc_crt_tpu_torch" in f.filename]
            mine = [f for f in stack if f.filename == __file__]
            where = (port or mine or stack)[-1]
            found[where_now[0]].add(
                f"{Path(where.filename).name}:{where.lineno}"
                + ("" if port else " (not the port's)"))

        def mark(name, fn):
            def run(*a, **k):
                outer, where_now[0] = where_now[0], (
                    "scan" if where_now[0] == "outside" else where_now[0])
                try:
                    return fn(*a, **k)
                finally:
                    where_now[0] = outer
            return run

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with patched([(dem, "_line_scan")], mark):
                    pipeline.step_batch(cfg, st, img, *path_args(1, 1, dev),
                                        noise=12)
                    where_now[0] = "vhs"
                    pipeline.step_batch(vhs, st_v, imgs_v,
                                        *path_args(B, 1, dev), noise=24,
                                        **VHS_KW)
                    where_now[0] = "outside"
                if video is not None:
                    where_now[0] = "video"
                    video.video_exact(cfg, single, clip, noise=12)
                    where_now[0] = "outside"
            finally:
                torch.cuda.set_sync_debug_mode(0)
    del imgs_v, st_v
    print("NTSC batch-1 step under set_sync_debug_mode: synchronizing ops "
          f"inside _line_scan at {', '.join(sorted(found['scan'])) or 'none'};"
          f" outside it at {', '.join(sorted(found['outside'])) or 'none'}",
          flush=True)
    print(f"NTSCVHS step at B {B} (do_aberration 1, noise 24) under "
          "set_sync_debug_mode: synchronizing ops at "
          f"{', '.join(sorted(found['vhs'])) or 'none'}", flush=True)
    if video is not None:
        print("NTSC video_exact of 4 frames under set_sync_debug_mode: "
              "synchronizing ops at "
              f"{', '.join(sorted(found['video'])) or 'none'}", flush=True)
    if found["scan"] and gate:
        raise SystemExit("the line scan synchronizes the stream")
    if any("not the port" not in w for w in found["vhs"]) and gate:
        raise SystemExit("the NTSCVHS step synchronizes the stream")
    if any("not the port" not in w for w in found["video"]):
        raise SystemExit("video_exact synchronizes the stream")


GRAPH_CELLS = (  # crt_bench's cells: (label, system, step keywords)
    ("vhs_batch2048", "NTSCVHS", dict(noise=24, do_aberration=1,
                                      mon=dict(saturation=10))),
    ("bloom_batch2048", "NTSC", dict(noise=24, do_bloom=True, mon=dict(
        blend=1, scanlines=1, saturation=10))),
    ("pv1k_batch2048", "PV1K", dict(noise=24, mon=dict(
        blend=1, scanlines=1, saturation=10))))


def phase_graphs(pipeline, systems, dev, B=2048, steps=6):
    """The benchmark cells' steps at B 2048 replayed as CUDA graphs
    (models/graphs.py) against the same steps run op by op: `steps` steps
    from init_batch, two 640x480 input batches in turn, the parities and
    dot crawl changing per slot and step.  Every leaf equal (0 LSB), each
    step's launch counts equal, graphs.GRAPHS one eager first call, one
    capture and a replay on every later step; the last replay under
    set_sync_debug_mode("error") (a synchronizing op fails the run)."""
    from ntsc_crt_tpu_torch.models import graphs
    from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
    from ntsc_crt_tpu_torch.ops.kernels import build
    for label, name, kw in GRAPH_CELLS:
        cfg = getattr(systems, name)
        kw = dict(kw, mon=MonitorParams(**kw["mon"]))
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        imgs = [torch.randint(0, 256, (B, OUTH, OUTW, 3), generator=g,
                              device=dev, dtype=torch.uint8)
                for _ in range(2)]
        graphs.reset()
        st_g = st_e = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
        for i in range(steps):
            args = path_args(B, i, dev)
            torch.cuda.synchronize()
            build.LAUNCHES.clear()
            if i == steps - 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                st_g = pipeline.step_batch(cfg, st_g, imgs[i % 2], *args,
                                           **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got = dict(build.LAUNCHES)
            build.LAUNCHES.clear()
            with eager_steps(pipeline):
                st_e = pipeline.step_batch(cfg, st_e, imgs[i % 2], *args,
                                           **kw)
            if got != dict(build.LAUNCHES):
                raise SystemExit(f"{label} step {i}: launches {got} replayed"
                                 f", {dict(build.LAUNCHES)} op by op")
            for k, a, b in zip(st_g._fields, st_g, st_e):
                if not torch.equal(a, b):
                    raise SystemExit(
                        f"{label} step {i} leaf {k}: {int((a != b).sum())} "
                        "elements differ between the replay and the step "
                        "op by op")
        want = {"eager_first": 1, "captures": 1, "replays": steps - 2}
        plans = [p for p in graphs._CACHE.values()
                 if isinstance(p, graphs.Plan)]
        print(f"{label} B {B}: {steps} steps through CUDA graphs equal the "
              f"steps op by op (0 LSB, every leaf); launches a step {got}; "
              f"graphs.GRAPHS {dict(graphs.GRAPHS)}; "
              + (f"{sum(g is not None for g in plans[0].graphs)} graphs, "
                 f"{len(plans[0].calls)} eager calls a step "
                 f"({', '.join(c.fn.__name__ for c in plans[0].calls)})"
                 if plans else f"failures {graphs.FAILURES}"), flush=True)
        if graphs.GRAPHS != want:
            raise SystemExit(f"{label}: graphs.GRAPHS {dict(graphs.GRAPHS)}"
                             f", failures {graphs.FAILURES}")
        del imgs, st_g, st_e, plans
        graphs.reset()
        torch.cuda.empty_cache()


def nes_sync_free(pipeline, systems, dev) -> None:
    """One NES batch-1 step (K13's path, with the border and the
    unoptimized build) after a warm one, under
    torch.cuda.set_sync_debug_mode("error"): a synchronizing op raises."""
    cfg = systems.NES
    img = frames_for(cfg, 1, OUTH, OUTW, 1237, dev)
    st = pipeline.init_batch(cfg, 1, OUTW, OUTH, device=dev)
    st = pipeline.step_batch(cfg, st, img, *path_args(1, 0, dev), noise=12,
                             **NES_BORDER)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipeline.step_batch(cfg, st, img, *path_args(1, 1, dev), noise=12,
                            **NES_BORDER)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("NES batch-1 step (draw_border, optimized=False) ran under "
          "set_sync_debug_mode('error'): no synchronizing op", flush=True)


def counted(label, needed, run):
    """run() with every launch count zeroed just before it and read just
    after; fails unless each kernel of `needed` launched and no other did.
    Returns (the counts, run's result)."""
    from ntsc_crt_tpu_torch.ops.kernels import build
    build.LAUNCHES.clear()
    result = run()
    launches = {name: build.LAUNCHES[name] for name in kernel_modules()}
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

    from ntsc_crt_tpu_torch.models import demodulate as dem
    from ntsc_crt_tpu_torch.models import graphs
    failed, replays = dict(graphs.FAILURES), graphs.GRAPHS["replays"]
    dem.PLACEMENTS.clear()
    launches, (r1, rB) = counted(
        f"{label} main path, {steps1 + stepsB + 4} steps", needed, both)
    print(f"{label} main path: placements {dict(dem.PLACEMENTS)}",
          flush=True)
    if dem.PLACEMENTS["general"]:
        raise SystemExit(f"{label}: the general row placement (per-row "
                         f"gathers) ran {dem.PLACEMENTS['general']} times on "
                         "a main path")
    new = [v for k, v in graphs.FAILURES.items() if k not in failed]
    print(f"{label} main path: {graphs.GRAPHS['replays'] - replays} steps "
          f"replayed as CUDA graphs; failed captures {new or 'none'}",
          flush=True)
    if new or graphs.GRAPHS["replays"] == replays:
        raise SystemExit(f"{label}: a main path's step must replay as CUDA "
                         "graphs (models/graphs.py)")
    print(f"{label} main path: every step's rows placed by K6, none by the "
          "general gathers", flush=True)
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


def time_paths(labels=("NTSC do_bloom=True", "NES")) -> None:
    """The main paths named by `labels` (path_label) alone, on the card:
    each one's phase_path (counted, held to the CPU, stage times, a
    profiled step, peak memory), to set two trees side by side in one
    call:

        python3 -c "import chip_smoke as c; c.time_paths()"
    """
    from ntsc_crt_tpu_torch.models import pipeline, systems
    from ntsc_crt_tpu_torch.ops.kernels import build
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    build.library()
    for cfg, kw, needed in main_paths(systems):
        if path_label(cfg, kw) in labels:
            phase_path(pipeline, cfg, kw, needed, card, dev)


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


# --- video and front ends -----------------------------------------------------

VIDEO_GOLDENS = GOLDENS.parent / "video_goldens.npz"
NTSC_KERNELS = ("encode_rows_field", "hsync_chase", "ccf_ema", "decode_rows",
                "inject_noise", "place_rows_uniform")


def same_video_golden(ref, case, st, outs):
    """Every frame, the analog field's SHA-256 and the other leaves; `out`
    is the last frame (or chunk) of outs."""
    import hashlib
    got = {k: v.cpu().numpy() for k, v in st._asdict().items()}
    outs = outs.cpu().numpy()
    last = outs[-got["out"].shape[0]:] if got["out"].ndim == 4 else outs[-1]
    sha = np.frombuffer(hashlib.sha256(got["analog"].tobytes()).digest(),
                        np.uint8)
    checks = [("outs", outs, ref[f"{case}/outs"]),
              ("analog_sha256", sha, ref[f"{case}/analog_sha256"]),
              ("out", got["out"], last)]
    checks += [(k, got[k], ref[f"{case}/{k}"])
               for k in ("ccf", "hsync", "vsync", "rn", "randstate")]
    for k, a, b in checks:
        if a.shape != b.shape or not np.array_equal(a, b):
            raise SystemExit(f"video golden {case}/{k} differs on the card")


def phase_video_goldens(pipeline, video, systems, dev):
    """tests/fixtures/video_goldens.npz (the JAX package's video_exact and
    video_strided) replayed on the card, each case by the recipe stored
    beside it in the file (tests/test_torch_video.py writes both)."""
    from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
    ref = np.load(VIDEO_GOLDENS)
    cfg = systems.NTSC
    cases = sorted({k.split("/")[0] for k in ref.files if "/" in k})
    for case in cases:
        r = {str(f): int(v) for f, v in zip(ref["recipe_fields"],
                                            ref[f"{case}/recipe"])}
        frames = torch.as_tensor(np.random.RandomState(r["seed"]).randint(
            0, 256, (r["frames"], r["in_h"], r["in_w"], 3), np.uint8),
            device=dev)
        fn = video.video_strided if r["batch"] else video.video_exact
        st, outs = fn(cfg, pipeline.crt_init(cfg, r["outw"], r["outh"],
                                             batch=r["batch"] or None,
                                             device=dev),
                      frames, noise=r["noise"],
                      mon=MonitorParams(blend=r["blend"],
                                        scanlines=r["blend"]),
                      v_fac=r["v_fac"])
        same_video_golden(ref, case, st, outs)
        print(f"video golden {case} ({r}): every frame and state leaf "
              "bit-exact on the card", flush=True)


def timed(fn):
    """(host ms around fn() with the device drained on both sides, its
    result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def same_leaves(a, b, what):
    for k in a._fields:
        if not torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu()):
            raise SystemExit(f"{what}: leaf {k} differs")


def phase_video(pipeline, systems, dev, card):
    """The video pipelines, the CLIs, the live session, a checkpoint's
    resume and the slot split, each path counted; returns the launches."""
    import io
    import tempfile

    from ntsc_crt_tpu_torch import cli
    from ntsc_crt_tpu_torch.apps import term_live
    from ntsc_crt_tpu_torch.apps.live import LiveSession
    from ntsc_crt_tpu_torch.models import video
    from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
    from ntsc_crt_tpu_torch.parallel import mesh
    from ntsc_crt_tpu_torch.utils import (checkpoint, imageio, native_io,
                                          testcard)
    cfg, vhs = systems.NTSC, systems.NTSCVHS
    rgb = NTSC_KERNELS[:5]              # without K6's uniform mode
    launches = dict.fromkeys(ORIGIN, 0)

    def count(label, needed, run):
        counts, out = counted(label, needed, run)
        for k, n in counts.items():
            launches[k] += n
        return out

    def fresh(c=cfg):
        return pipeline.crt_init(c, OUTW, OUTH, device=dev)

    phase_video_goldens(pipeline, video, systems, dev)

    # exact: T frames of 640x480, frames 0-3 held to the CPU plain path
    T = 16
    clip = frames_for(cfg, T, OUTH, OUTW, 1240, dev)
    video.video_exact(cfg, fresh(), clip[:2], noise=12)          # warm
    ms, (st, outs) = count(
        f"NTSC video_exact, {T} frames", NTSC_KERNELS,
        lambda: timed(lambda: video.video_exact(cfg, fresh(), clip,
                                                noise=12)))
    if tuple(outs.shape) != (T, OUTH, OUTW, 3) or outs.dtype != torch.uint8:
        raise SystemExit(f"video_exact: bad output {tuple(outs.shape)}")
    _, want = video.video_exact(
        cfg, pipeline.crt_init(cfg, OUTW, OUTH, device="cpu"),
        clip[:4].cpu(), noise=12)
    if not torch.equal(outs[:4].cpu(), want):
        raise SystemExit("video_exact frames 0-3 differ from the CPU")
    print(f"NTSC video_exact 640x480, {T} frames: {ms / T:.4f} ms/frame, "
          f"{T * 1e3 / ms:.2f} frames/s; frames 0-3 equal the CPU plain "
          f"path  [{card}]", flush=True)

    # strided: B slots, k frames each, from 320x240; slots 0 and B - 1
    # held to video_exact of their sub-videos from the same slot state
    B, k = MAIN_BATCH, 2
    frames = frames_for(cfg, B * k, 240, 320, 1241, dev)
    states0 = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    video.video_strided(cfg, states0, frames[:B], noise=12)      # warm
    torch.cuda.reset_peak_memory_stats(dev)
    ms, (stB, outsB) = count(
        f"NTSC video_strided, B {B}, k {k}", NTSC_KERNELS,
        lambda: timed(lambda: video.video_strided(cfg, states0, frames,
                                                  noise=12)))
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(outsB.shape) != (B * k, OUTH, OUTW, 3):
        raise SystemExit(f"video_strided: bad output {tuple(outsB.shape)}")
    for b in (0, B - 1):
        one = pipeline.CRTState(*(x[b] for x in states0))
        st1, o1 = video.video_exact(cfg, one, frames[b::B], noise=12)
        if not torch.equal(o1, outsB[b::B]):
            raise SystemExit(f"video_strided slot {b} differs from "
                             "video_exact of its sub-video")
        same_leaves(st1, pipeline.CRTState(*(x[b] for x in stB)),
                    f"video_strided slot {b}")
    print(f"NTSC video_strided 320x240 -> 640x480, B {B}, k {k}: "
          f"{B * k * 1e3 / ms:.2f} frames/s, {ms / k:.3f} ms/step, peak "
          f"{peak / 2**20:.1f} MiB allocated; slots 0 and {B - 1} equal "
          f"video_exact of their sub-videos  [{card}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # video_main on n BMP frames (NTSCVHS, aberration), against
        # video_exact; frames/s with the file I/O
        n = 16
        src, dst = tmp / "frames", tmp / "out"
        src.mkdir()
        pics = frames_for(cfg, n, OUTH, OUTW, 1242, "cpu").numpy()
        for i in range(n):
            imageio.bmp_write(src / f"{i:06d}.bmp", pics[i])
        native_io.available()                     # its build, untimed
        args = ["-a", "-W", str(OUTW), "-H", str(OUTH), str(n), str(src),
                str(dst)]

        def quiet(fn):
            with contextlib.redirect_stdout(io.StringIO()):
                return fn()
        ms, rc = count(f"NTSCVHS video_main, {n} BMP frames",
                       rgb + ("place_rows_uniform", "vhs_region_b_entries",
                              "vhs_noise_bc"),
                       lambda: timed(lambda: quiet(
                           lambda: cli.video_main(args))))
        _, want = video.video_exact(
            vhs, fresh(vhs), torch.as_tensor(pics, device=dev), noise=24,
            mon=MonitorParams(blend=0, scanlines=0, saturation=10),
            do_aberration=1)
        want = want.cpu().numpy()
        for i in range(n):
            if not np.array_equal(imageio.bmp_read(dst / f"{i:06d}.bmp"),
                                  want[i]):
                raise SystemExit(f"video_main frame {i} differs from "
                                 "video_exact")
        print(f"NTSCVHS video_main 640x480 -a, {n} BMP frames: rc {rc}, "
              f"{n * 1e3 / ms:.2f} frames/s end to end (native codec "
              f"{native_io.available()}); every frame equals video_exact  "
              f"[{card}]", flush=True)

        # the image CLI on the test card: the card's bytes against the CPU's
        card_img = tmp / "card.ppm"
        imageio.ppm_write(card_img, testcard.test_card())
        got = {}
        for d in (None, "cpu"):
            out = tmp / f"cli_{d}.ppm"
            argv = ["-o", str(OUTW), str(OUTH), "12", "0", str(card_img),
                    str(out)]
            run = lambda: quiet(lambda: cli.main(argv, device=d))  # noqa
            rc = count("NTSC cli.main, test card", NTSC_KERNELS, run) \
                if d is None else run()
            if rc != 0:
                raise SystemExit(f"cli.main on {d or 'the card'}: rc {rc}")
            got[d] = out.read_bytes()
        if got[None] != got["cpu"]:
            raise SystemExit("cli.main: the card's bytes differ from the CPU")
        print("NTSC cli.main -o 640 480 12 0 on the test card: the card's "
              "file equals the CPU's", flush=True)

        # a checkpoint mid-video: save after 4 of 8 frames, load, resume
        _, full = video.video_exact(cfg, fresh(), clip[:8], noise=12)
        st4, _ = video.video_exact(cfg, fresh(), clip[:4], noise=12)
        fseq, frseq = video._parities(8, cfg.progressive)
        ck = tmp / "ck.npz"
        checkpoint.save_checkpoint(str(ck), st4, frame_index=4,
                                   field=int(fseq[4]), frame=int(frseq[4]))
        st, meta = checkpoint.load_checkpoint(str(ck))
        same_leaves(st, st4, "checkpoint round trip")
        field, frame = meta["field"], meta["frame"]
        for i in range(meta["frame_index"], 8):
            st = pipeline.step(cfg, st, clip[i], field=field, frame=frame,
                               noise=12)
            if not torch.equal(st.out, full[i]):
                raise SystemExit(f"resumed frame {i} differs")
            field ^= 1
            if (i & 1) == 0:
                frame ^= 1
        print("checkpoint: saved after frame 4 of 8 on the card, loaded "
              "(every leaf equal), resumed: frames 4-7 equal the "
              "uninterrupted run", flush=True)

        # profiling.profile_kernels: a trace of two NTSC steps at batch 64,
        # its device events summed by name
        total, rows = profiling.profile_kernels("NTSC", batch=64, steps=2,
                                                logdir=str(tmp / "trace"))
        if total <= 0 or not any(kernel_of(r[0]) for r in rows):
            raise SystemExit("profile_kernels: no port kernel in the trace")
        print(f"profile_kernels NTSC batch 64, 2 steps: device {total:.3f} "
              "ms; most: " + ", ".join(
                  f"{kernel_of(n) or n[:40]} {ms:.3f} ({c})"
                  for n, ms, c in rows[:6]) + f"  [{card}]", flush=True)

    # the live session at its default 832x624 (K6's general mode: 624 is
    # not a multiple of the 240 lines)
    img = testcard.test_card()
    a, b = LiveSession(cfg, noise=12), LiveSession(cfg, noise=12)
    a.tick(img)
    b.tick_fast(img)                                             # warm

    def ticks():
        res = {}
        for name, fn in (("tick", a.tick), ("tick_fast", b.tick_fast)):
            t0 = time.perf_counter()
            res[name] = [fn(img) for _ in range(60)]
            res[name + " ms"] = (time.perf_counter() - t0) * 1e3 / 60
        return res
    live = rgb + ("place_rows_general",)
    res = count("NTSC LiveSession 832x624, 60 tick + 60 tick_fast", live,
                ticks)
    for i, (x, y) in enumerate(zip(res["tick"], res["tick_fast"])):
        if not np.array_equal(x, y):
            raise SystemExit(f"tick_fast differs from tick at tick {i}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = count("NTSC term_live.main --frames 30 --no-display", live,
                   lambda: term_live.main(["--frames", "30",
                                           "--no-display"]))
    if rc != 0:
        raise SystemExit(f"term_live.main: rc {rc}")
    print(f"NTSC LiveSession 832x624: tick {res['tick ms']:.4f} ms, "
          f"tick_fast {res['tick_fast ms']:.4f} ms (full frame to the "
          "host), 60 each, every tick_fast frame equals tick's; "
          f"term_live: {err.getvalue().strip()}  [{card}]", flush=True)

    # the slot split: over one card, and over the card twice
    B = 8
    imgs = frames_for(cfg, B, 240, 320, 1243, dev)
    whole = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    for i in range(2):
        whole = pipeline.step_batch(cfg, whole, imgs, *path_args(B, i, dev),
                                    noise=12)
    for devs in ([dev], [dev, dev]):
        chunks = mesh.init_batch(cfg, B, OUTW, OUTH, devices=devs)
        step = mesh.make_sharded_step(cfg, devs, noise=12)
        for i in range(2):
            chunks = step(chunks, imgs, *path_args(B, i, dev))
        same_leaves(mesh.gather(chunks), whole,
                    f"make_sharded_step over {len(devs)}")
    print(f"mesh: make_sharded_step over [{dev}] and [{dev}, {dev}] (split "
          f"and merge on one card), batch {B}, 2 steps, equals step_batch",
          flush=True)
    return launches


# --- 9. the spatial split and the demo ----------------------------------------


def main_paths(systems):
    """(cfg, step keywords, the kernels each step must launch) of the six
    main paths, on one card (split_needs: over a row of cards)."""
    common = ("hsync_chase", "ccf_ema", "decode_rows", "inject_noise")
    ntsc = common + ("encode_rows_field",)
    return ((systems.NTSC, {}, ntsc + ("place_rows_uniform",)),
            (systems.NTSCVHS, VHS_KW,
             ntsc + ("place_rows_uniform", "vhs_region_b_entries",
                     "vhs_noise_bc")),
            (systems.NTSC, BLOOM,
             ("encode_rows_field", "hsync_chase", "ccf_ema",
              "decode_rows_bloom", "bloom_line_width",
              "place_rows_uniform_bloom", "inject_noise")),
            (systems.NTSC, CONV7,
             ("encode_rows_field", "hsync_chase", "ccf_ema",
              "decode_rows_conv", "place_rows_uniform", "inject_noise")),
            (systems.PV1K, {}, ntsc + ("place_rows_uniform",)),
            (systems.NES, {}, common + ("place_rows_uniform", "nes_square")))


def split_needs(needed, shape):
    """A main path's kernels over a mesh of `shape`: a row of two cards or
    more splits K1's block by line, and the field's passes run around it,
    in place of K1's field mode."""
    if shape[1] < 2:
        return needed
    return tuple("encode_rows" if n == "encode_rows_field" else n
                 for n in needed)


def k2_counter(kw):
    """The launch count that K2's mode on this path adds to."""
    if kw.get("do_bloom"):
        return "decode_rows_bloom"
    return "decode_rows_conv" if "eq_mode" in kw else "decode_rows"


def tiles(shards, n, row) -> bool:
    """The shards [(card, lo, hi), ...] tile [0, n) in order, one on each
    of the row's first min(len(row), n) cards."""
    bounds = [(lo, hi) for _, lo, hi in shards]
    return ([d for d, _, _ in shards] == list(row[:min(len(row), n)])
            and bounds[0][0] == 0 and bounds[-1][1] == n
            and all(hi > lo for lo, hi in bounds)
            and all(a[1] == b[0] for a, b in zip(bounds, bounds[1:])))


def check_shards(label, records, counts, grid, n_lines, k2):
    """Each sharded call of a run over `grid` (records: (tag, [(card, lo,
    hi), ...]) in call order, chunk by chunk, K1 before K2) split K1's rows
    or K2's n_lines lines once over its chunk's row of cards; each kernel
    launched once a shard."""
    if len(grid[0]) == 1:                  # no row to split over
        if records:
            raise SystemExit(f"{label}: a 1-card row split {records}")
        return
    per_chunk = 2 if counts["encode_rows"] else 1
    for j, (tag, shards) in enumerate(records):
        row = grid[(j // per_chunk) % len(grid)]
        n = n_lines if tag == "decode_rows" else shards[-1][2]
        if not tiles(shards, n, row):
            raise SystemExit(f"{label}: {tag} shards {shards} do not tile "
                             f"[0, {n}) over {row}")
    for tag, key in (("encode_rows", "encode_rows"), ("decode_rows", k2)):
        n = sum(len(s) for t, s in records if t == tag)
        if counts[key] != n:
            raise SystemExit(f"{label}: {key} launched {counts[key]} times "
                             f"for {n} shards")


def spatial_case(pipeline, cfg, kw, needed, shape, devs, B, imgs, whole,
                 records, steps=2):
    """`steps` steps of B slots over make_mesh(*shape, devs), counted and
    checked shard by shard; the merged state held to `whole` (step_batch
    from the same start).  Returns the counts."""
    from ntsc_crt_tpu_torch.parallel import mesh
    grid = mesh.make_mesh(*shape, devs)
    label = f"{path_label(cfg, kw)} batch {B} over {shape[0]}x{shape[1]}"

    def run():
        chunks = mesh.init_batch(cfg, B, OUTW, OUTH, devices=grid)
        step = mesh.make_sharded_step(cfg, grid, noise=12, **kw)
        for i in range(steps):
            chunks = step(chunks, imgs, *path_args(B, i, devs[0]))
        return chunks
    records.clear()
    counts, chunks = counted(f"{label}, {steps} steps",
                             split_needs(needed, shape), run)
    same_leaves(mesh.gather(chunks), whole, label)
    check_shards(label, records, counts, grid, cfg.lines, k2_counter(kw))
    return counts


def reference(pipeline, cfg, kw, B, imgs, dev, steps=2):
    st = pipeline.init_batch(cfg, B, OUTW, OUTH, device=dev)
    for i in range(steps):
        st = pipeline.step_batch(cfg, st, imgs, *path_args(B, i, dev),
                                 noise=12, **kw)
    return st


def shard_copy_bytes(pipeline, cfg, B, imgs, dev):
    """The bytes a shard other than the home one copies in one NTSC step
    over a 1x2 group: each K1 and K2 call's tensor arguments in, its result
    out (what crosses between cards when the group's cards differ)."""
    from ntsc_crt_tpu_torch.ops.kernels import decode, encode
    from ntsc_crt_tpu_torch.parallel import mesh
    calls = []

    def measure(name, fn):
        def run(*a, **k):
            out = fn(*a, **k)
            ins = [v for v in (*a, *k.values()) if torch.is_tensor(v)]
            calls.append((name, nbytes(*ins), nbytes(out)))
            return out
        return run
    grid = mesh.make_mesh(1, 2, [dev, dev])
    st = mesh.init_batch(cfg, B, OUTW, OUTH, devices=grid)
    with patched([(encode, "encode_rows"), (decode, "decode_rows")],
                 measure):
        mesh.make_sharded_step(cfg, grid, noise=12)(
            st, imgs, *path_args(B, 0, dev))
    return {name: (i, o) for (name, i, o) in calls[1::2]}


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_ms(step, st, imgs, B, steps, dev):
    """Host ms a step over `steps` steps between two synchronizations of
    every card."""
    sync_all()
    t0 = time.perf_counter()
    for i in range(steps):
        st = step(st, imgs, *path_args(B, i, dev))
    sync_all()
    return (time.perf_counter() - t0) * 1e3 / steps


def sync_free_step(cfg, grid, img, dev) -> None:
    """One batch-1 step over `grid` (after a warm one) under
    torch.cuda.set_sync_debug_mode("error"): a synchronizing op raises."""
    from ntsc_crt_tpu_torch.parallel import mesh
    st = mesh.init_batch(cfg, 1, OUTW, OUTH, devices=grid)
    step = mesh.make_sharded_step(cfg, grid, noise=12)
    st = step(st, img, *path_args(1, 0, dev))
    sync_all()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = step(st, img, *path_args(1, 1, dev))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_all()


def phase_spatial(pipeline, systems, dev, card):
    """make_sharded_step over make_mesh(1, 2) and make_mesh(2, 2) of this
    card repeated: every main path, each step's state held to step_batch's
    at 0 LSB, K1 and K2 split once over each row (parallel.spatial's
    _INSPECT record) and launched once a shard; K7, K8 and K9 through
    their op entries over a group of two; one spatial batch-1 step under
    set_sync_debug_mode("error"); host ms at NTSC batch 1 and 512, 1x1
    against 1x2.  Returns the launches."""
    from ntsc_crt_tpu_torch.ops import filters
    from ntsc_crt_tpu_torch.ops.kernels import decode, rowfilters, scanconv
    from ntsc_crt_tpu_torch.parallel import mesh, spatial
    launches = dict.fromkeys(ORIGIN, 0)
    records = []
    spatial._INSPECT = lambda tag, shards: records.append((tag, shards))
    img1 = frames_for(systems.NTSC, 1, OUTH, OUTW, 1250, dev)
    imgsB = frames_for(systems.NTSC, MAIN_BATCH, 240, 320, 1251, dev)
    try:
        for cfg, kw, needed in main_paths(systems):
            if cfg is systems.NTSC and not kw:
                cases = ((1, img1, ((1, 2),)),
                         (MAIN_BATCH, imgsB, ((1, 2), (2, 2))))
            else:
                cases = ((2, frames_for(cfg, 2, 240, 320, 1252, dev),
                          ((1, 2), (2, 2))),)
            for B, imgs, shapes in cases:
                whole = reference(pipeline, cfg, kw, B, imgs, dev)
                for shape in shapes:
                    counts = spatial_case(
                        pipeline, cfg, kw, needed, shape,
                        [dev] * (shape[0] * shape[1]), B, imgs, whole,
                        records)
                    for k, n in counts.items():
                        launches[k] += n
        print("spatial: make_sharded_step over 1x2 and 2x2 of one card "
              "equals step_batch (2 steps, every leaf) on every main path "
              "(NTSC batch 1 and 512, the others batch 2); K1 and K2 split "
              "once over each row, a launch a shard", flush=True)

        # K7, K8 and K9 through their op entries over a group of two
        B = KERNEL_BATCHES[-1]
        seen = capture_kernel_inputs(pipeline, systems.NTSC, B,
                                     ("encode_rows_field", "decode_rows"),
                                     dev, {})
        yiq, c = k7_args(*seen["encode_rows_field"])
        a, k = seen["decode_rows"]
        want = (rowfilters.iir_lowpass_rows_plain(yiq, c),
                decode.decode_rows(*a, **k))
        out = {}

        def ops():
            with spatial.line_sharding([dev, dev]):
                out["iir"] = filters.iir_lowpass(yiq, c)
                out["unfused"] = scanconv.decode_rows_unfused(*a, **k)
        records.clear()
        counts, _ = counted("op entry points over a group of two",
                            ("iir_lowpass_rows", "eq_threeband_rows",
                             "scanconv_rows"), ops)
        torch.cuda.synchronize()
        if not (torch.equal(out["iir"], want[0])
                and torch.equal(out["unfused"], want[1])):
            raise SystemExit("the op entries over a group of two differ")
        Bk, Lk = a[1].shape
        rows = {"iir_lowpass_rows": yiq[..., 0].numel(),
                "eq_threeband_rows": 3 * Bk * Lk, "scanconv_rows": Bk * Lk}
        if [t for t, _ in records] != list(rows) or any(
                not tiles(s, rows[t], [dev, dev]) or counts[t] != 2
                for t, s in records):
            raise SystemExit(f"op entries over a group of two: {records}, "
                             f"launches {counts}")
        for k_, n in counts.items():
            launches[k_] += n
        print(f"spatial: iir_lowpass, eq_threeband and scanconv_rows split "
              f"their rows in two (batch {B}), a launch a shard, equal to "
              "one call", flush=True)
    finally:
        spatial._INSPECT = None

    # no synchronizing op inside a spatial step
    sync_free_step(systems.NTSC, mesh.make_mesh(1, 2, [dev, dev]), img1, dev)
    print("spatial: an NTSC batch-1 step over 1x2 ran under "
          "set_sync_debug_mode('error'): no synchronizing op", flush=True)

    # bytes a second shard would copy, and host ms 1x1 against 1x2
    for B, imgs in ((1, img1), (MAIN_BATCH, imgsB)):
        moved = shard_copy_bytes(pipeline, systems.NTSC, B, imgs, dev)
        print(f"spatial: NTSC batch {B} over 1x2, the second shard's "
              "copies a step (bytes in, out): " + ", ".join(
                  f"{k} {i}, {o}" for k, (i, o) in moved.items()),
              flush=True)
    for B, imgs, steps in ((1, img1, 20), (MAIN_BATCH, imgsB, 5)):
        ms = {}
        for shape in ((1, 1), (1, 2), (1, 2), (1, 1)):
            grid = mesh.make_mesh(*shape, [dev] * shape[1])
            st = mesh.init_batch(systems.NTSC, B, OUTW, OUTH, devices=grid)
            step = mesh.make_sharded_step(systems.NTSC, grid, noise=12)
            st = step(st, imgs, *path_args(B, 0, dev))
            ms.setdefault(shape, []).append(
                host_ms(step, st, imgs, B, steps, dev))
        one, two = ms[(1, 1)], ms[(1, 2)]
        print(f"spatial: NTSC batch {B}, host ms a step over {steps} steps "
              f"(1x1, 1x2, 1x2, 1x1 on one card): {one[0]:.4f}, "
              f"{two[0]:.4f}, {two[1]:.4f}, {one[1]:.4f}; 1x2 / 1x1 "
              f"{sum(two) / sum(one):.3f}  [{card}]", flush=True)
    return launches


def phase_demo(dev, card):
    """python -m ntsc_crt_tpu_torch.demo on the card into a temporary
    directory (every system, counted), its NTSC files held to the same demo
    on the CPU.  Returns the launches."""
    import io
    import tempfile

    from ntsc_crt_tpu_torch import demo
    from ntsc_crt_tpu_torch.models import systems
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        said = io.StringIO()

        def run():
            with contextlib.redirect_stdout(said):
                return demo.main([str(tmp / "card")])
        ms, (launches, rc) = timed(lambda: counted(
            "demo, every system",
            ("encode_rows", "encode_rows_field", "decode_rows",
             "hsync_chase", "ccf_ema", "vhs_region_b_entries",
             "place_rows_uniform", "inject_noise", "vhs_noise_bc",
             "nes_square"), run))
        names = {p.name for p in (tmp / "card").iterdir()}
        expected = {"input.ppm"} | {f"{n.lower()}{s}.ppm"
                                    for n in systems.SYSTEMS
                                    for s in ("", "_analog")}
        if rc != 0 or names != expected:
            raise SystemExit(f"demo: rc {rc}, files {sorted(names)}")
        every = systems.SYSTEMS
        systems.SYSTEMS = {"NTSC": systems.NTSC}
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                demo.main([str(tmp / "cpu")], device="cpu")
        finally:
            systems.SYSTEMS = every
        for n in ("input.ppm", "ntsc.ppm", "ntsc_analog.ppm"):
            card_, cpu = ((tmp / d / n).read_bytes() for d in ("card", "cpu"))
            if card_ != cpu:
                raise SystemExit(f"demo: the card's {n} differs from the CPU")
    print(f"demo: {len(every)} systems, {len(names)} files in {ms:.1f} ms "
          f"({said.getvalue().count('wrote')} reported); NTSC's equal the "
          f"CPU's  [{card}]", flush=True)
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

    # 3. the op entry points of K7-K10; the probe prices the chains below
    launches = dict.fromkeys(ORIGIN, 0)
    for k, n in phase_ops(systems, dev).items():
        launches[k] += n

    # 4. kernels vs plain versions, then K1-K4 at ragged shapes and edges
    table = phase_kernels(pipeline, systems, dev)
    phase_ragged(dev)

    # the line scan runs without a stream synchronize; NES's step with none
    phase_syncs(pipeline, systems, dev)
    nes_sync_free(pipeline, systems, dev)

    # the benchmark cells' steps replayed as CUDA graphs, against op by op
    phase_graphs(pipeline, systems, dev)

    # 5. goldens
    phase_goldens(pipeline, systems, dev)

    # 6. the main paths, each counted on its own; a kernel's launches are
    # its counts summed over the paths and the op entry points
    for cfg, kw, needed in main_paths(systems):
        for k, n in phase_path(pipeline, cfg, kw, needed, card, dev).items():
            launches[k] += n

    # 7. the other variants and encoder families: one step each
    rgb = ("hsync_chase", "ccf_ema", "decode_rows", "inject_noise",
           "place_rows_uniform")
    phase_variant(pipeline, systems.NTSC, FIXED_SYNC,
                  ("encode_rows_field", "ccf_ema", "decode_rows",
                   "place_rows_uniform", "inject_noise"), dev)
    phase_variant(pipeline, systems.NTSC_RAINBOW, {},
                  rgb + ("encode_rows_field",), dev)
    for cfg in (systems.SNES, systems.TEMPLATE):
        phase_variant(pipeline, cfg, {}, rgb + ("encode_rows_field",), dev)
    phase_variant(pipeline, systems.NESRGB, {}, rgb + ("encode_rows",), dev)
    phase_variant(pipeline, systems.NES, NES_BORDER,
                  ("hsync_chase", "ccf_ema", "decode_rows", "inject_noise",
                   "place_rows_uniform", "nes_square"), dev)

    # 8. video and front ends
    for k, n in phase_video(pipeline, systems, dev, card).items():
        launches[k] += n

    # 9. the spatial split and the demo
    for phase in (lambda: phase_spatial(pipeline, systems, dev, card),
                  lambda: phase_demo(dev, card)):
        for k, n in phase().items():
            launches[k] += n

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
