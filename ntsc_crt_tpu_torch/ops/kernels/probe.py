"""K10 ``probe``: the card's int32 issue rate under the EQ march's
dependency patterns — the yardstick for pricing the serial kernels.

    python -m ntsc_crt_tpu_torch.ops.kernels.probe

runs on the card and prints, for each pattern, the source-counted int32 rate
at the TPU probe's default size (64 blocks of 8 x 128 elements) and at a
size that fills 132 SMs, eq3's share of peak, and eq1's cycles per
dependent op at the SM clock read while it runs.

Patterns (ntsc_crt_tpu/ops/pallas/vpu_probe.py, which this replaces):
``peak`` — 16 independent mul/add/shift/add streams a thread; ``eq3`` —
three copies of the 3-band EQ chain, each output & 1 fed back into its
state; ``eq1`` — one.  Every element x of x = arange(blocks * 1024) runs
`iters` iterations and folds every stream into its output, a deterministic
int32 function of (pattern, iters, blocks) equal to the TPU kernel's.  A
CPU tensor runs the plain torch version below; a CUDA tensor launches
csrc/probe.cu.  This module keeps its own copy of what it needs of the JAX
package (the chain, the coefficients and the op counts).
"""

from __future__ import annotations

import subprocess

import torch

from ntsc_crt_tpu_torch.ops.kernels.rowfilters import EQ_P, EQ_R

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0

SUB, LANE = 8, 128           # one TPU probe block: 8 x 128 elements
PATTERNS = ("peak", "eq3", "eq1")
# the NTSC Y channel's 3-band coefficients (vpu_probe.py:45)
COEFS = (56360, 28235, 65536, 8192, 9175)
# source ops of one _eq_chain step (decode_fused.py:85-97): 8 poles x (sub,
# mul, add, shift, add) + the output (3 mul, 3 shift, 2 sub, 2 add)
EQ_OPS_PER_STEP = 8 * 5 + 10
# source ops on eq1's critical path an iteration: 4 poles x 5, the output's
# 5 after the last pole, the feedback's AND and add
EQ1_CHAIN_OPS = 4 * 5 + 5 + 2
FILL_BLOCKS = 132 * 16       # 16 probe blocks an SM of the H100
THREADS = 128                # a CUDA block: one warp an SM scheduler


def ops_per_iter(pattern: str) -> int:
    """int32 source ops an iteration and element (vpu_probe.py:117-123)."""
    if pattern == "peak":
        return 16 * 4
    n_ch = 3 if pattern == "eq3" else 1
    return n_ch * (EQ_OPS_PER_STEP + 11 + 1)   # + the feedback: 11 adds, AND


def probe_input(blocks: int, device) -> torch.Tensor:
    """x = arange(blocks * 1024) int32, shaped (blocks, 1, 8, 128) like the
    TPU probe's."""
    return torch.arange(blocks * SUB * LANE, dtype=torch.int32,
                        device=device).reshape(blocks, 1, SUB, LANE)


def probe(x: torch.Tensor, pattern: str, iters: int = 4096) -> torch.Tensor:
    """x int32 (blocks, 1, 8, 128) -> int32, same shape."""
    if pattern not in PATTERNS:
        raise ValueError(f"probe: pattern must be one of {PATTERNS}")
    if x.device.type == "cpu":
        return probe_plain(x, pattern, iters)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    global LAUNCHES
    build.check("x", x, torch.int32, tuple(x.shape), x.device)
    if x.ndim != 4 or tuple(x.shape[1:]) != (1, SUB, LANE) or iters < 0:
        raise ValueError(f"probe: x must be (blocks, 1, {SUB}, {LANE}) and "
                         f"iters >= 0, got {tuple(x.shape)}, {iters}")
    out = torch.empty_like(x)
    build.launch("ntsc_probe", x.device, x.data_ptr(), out.data_ptr(),
                 x.numel(), PATTERNS.index(pattern), iters, THREADS)
    LAUNCHES += 1
    return out


def _eq_chain(st, sx, lf, hf, g0, g1, g2):
    """vpu_probe's _eq_chain (decode_fused.py:85-97) on a stacked state:
    st int32 (11, ...) = fL0..fL3, fH0..fH3, h0, h1, h2."""
    fL = [st[0], st[1], st[2], st[3]]
    fH = [st[4], st[5], st[6], st[7]]
    prevL = prevH = sx
    for k in range(4):
        fL[k] = fL[k] + ((lf * (prevL - fL[k]) + EQ_R) >> EQ_P)
        fH[k] = fH[k] + ((hf * (prevH - fH[k]) + EQ_R) >> EQ_P)
        prevL, prevH = fL[k], fH[k]
    out = (((fL[3] * g0) >> EQ_P) + (((fH[3] - fL[3]) * g1) >> EQ_P)
           + (((st[10] - fH[3]) * g2) >> EQ_P))
    sxt = torch.full_like(st[0], sx)
    return torch.stack(fL + fH + [sxt, st[8], st[9]]), out


def probe_plain(x: torch.Tensor, pattern: str, iters: int) -> torch.Tensor:
    """The same patterns in plain torch, every stream of every element in
    one tensor and one step per iteration."""
    if pattern == "peak":
        r = x[None] + torch.arange(16, dtype=torch.int32,
                                   device=x.device).reshape(16, 1, 1, 1, 1)
        for _ in range(iters):
            r = ((r * 58361 + 977) >> 3) + r
        acc = r[0]
        for j in range(1, 16):
            acc = acc ^ r[j]
        return acc
    n_ch = 3 if pattern == "eq3" else 1
    ch = torch.arange(n_ch, dtype=torch.int32, device=x.device)
    # (11, n_ch, blocks, 1, 8, 128): state int k of channel c is x + c
    st = (x[None] + ch.reshape(n_ch, 1, 1, 1, 1)).expand(11, *(
        (n_ch,) + tuple(x.shape))).contiguous()
    for i in range(iters):
        st, out = _eq_chain(st, i, *COEFS)
        st = st + (out & 1)
    acc = st[0, 0]
    for c in range(n_ch):
        for k in range(1, 11):
            acc = acc ^ st[k, c]
    return acc


def _sm_clock_mhz() -> float:
    """The SM clock now (nvidia-smi), in MHz."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(res.stdout.strip().splitlines()[0])


def measure(pattern: str, iters: int = 4096, blocks: int = 64,
            reps: int = 20) -> dict:
    """Time `reps` launches on the card with CUDA events, then keep the card
    on the same launches for about two seconds and read the SM clock
    meanwhile.  Returns ms a launch, the source-counted Gops/s, the SM clock
    (MHz) and whether the read ended before the launches did."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe.measure: no CUDA device")
    x = probe_input(blocks, torch.device("cuda"))
    probe(x, pattern, iters)                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        probe(x, pattern, iters)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    busy = min(20000, int(2000 / ms) + 1)
    for _ in range(busy):
        probe(x, pattern, iters)
    done = torch.cuda.Event()
    done.record()
    mhz = _sm_clock_mhz()
    in_run = not done.query()
    done.synchronize()
    ops = x.numel() * iters * ops_per_iter(pattern)
    return dict(pattern=pattern, iters=iters, blocks=blocks, ms=ms,
                gops=ops / (ms * 1e-3) / 1e9, sm_mhz=mhz,
                clock_read_in_run=in_run)


def report(iters: int = 4096) -> dict:
    """The rates of every pattern at 64 blocks and at FILL_BLOCKS, eq3's
    share of peak, and eq1's cycles per dependent op with one warp per SM
    scheduler (4 blocks: 32 CUDA blocks of 4 warps)."""
    rows = [measure(p, iters, b, reps=20 if b == 64 else 3)
            for b in (64, FILL_BLOCKS) for p in PATTERNS]
    lat = measure("eq1", iters, 4, reps=20)
    cyc = lat["ms"] * 1e-3 * lat["sm_mhz"] * 1e6 / (iters * EQ1_CHAIN_OPS)
    share = {b: next(r["gops"] for r in rows if r["blocks"] == b
                     and r["pattern"] == "eq3")
             / next(r["gops"] for r in rows if r["blocks"] == b
                    and r["pattern"] == "peak")
             for b in (64, FILL_BLOCKS)}
    return dict(rows=rows, latency=lat, dep_cycles=cyc, eq3_share=share)


def print_report(out: dict) -> None:
    for r in out["rows"] + [out["latency"]]:
        print(f"probe {r['pattern']:5s} blocks {r['blocks']:5d} iters "
              f"{r['iters']}: {r['ms']:.4f} ms, {r['gops']:.1f} Gops/s int32 "
              f"(source-counted), SM {r['sm_mhz']:.0f} MHz"
              + ("" if r["clock_read_in_run"] else " (read after the run)"))
    for b, s in out["eq3_share"].items():
        print(f"probe eq3 / peak at {b} blocks: {s:.4f}")
    lat = out["latency"]
    print(f"probe eq1 at {lat['blocks']} blocks (one warp a scheduler): "
          f"{out['dep_cycles']:.3f} cycles per dependent source op "
          f"({EQ1_CHAIN_OPS} an iteration) at {lat['sm_mhz']:.0f} MHz",
          flush=True)


def main() -> int:
    print_report(report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
