"""K11 inject_noise and K12 vhs_noise_bc, the port's noise stage.

On the CPU the plain versions (the path a CPU tensor takes), reached through
the decoder's `_inject_noise` and `_inject_noise_vhs`, are held against the
JAX package's functions at full field size: NTSC's LCG noise on NTSC, PV1K
and NES at the seeds and knobs where the arithmetic wraps, and the VHS
tracking noise with every band line.  The tables the decoder hands K11 are
held to the generator it names, which the kernel steps and the plain
version does not read.  The tests marked `gpu` hold each CUDA kernel
against its plain version on the card and skip without one.  Every value is
an integer: every comparison is exact (0 LSB).

JAX is imported inside the tests that use it, so the `gpu` tests also run
on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \\
        tests/test_torch_noise.py -m gpu
"""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import systems
from ntsc_crt_tpu_torch.ops import lcg
from ntsc_crt_tpu_torch.ops.kernels import build, noise, vhs

torch.set_num_threads(1)  # the tier runs several workers on few cores

REPO = Path(__file__).resolve().parent.parent
I32_MIN, I32_MAX = -2**31, 2**31 - 1
EDGE_RN = np.array([0, 1, -1, I32_MIN, I32_MAX], np.int32)
# 1 << 24: byte * noise wraps int32
EDGE_NOISE = (0, 7, 127, 1 << 24)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


def same(got, want, tag=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got, want), \
        f"{tag}: {int((got != want).sum())} differ"


@functools.lru_cache(maxsize=None)
def jax_noise(name: str, vhs_noise: bool):
    """The JAX package's noise function of preset `name`, jitted."""
    import jax

    from ntsc_crt_tpu.models import demodulate as jdem
    from ntsc_crt_tpu.models import systems as jsystems
    cfg = jsystems.SYSTEMS[name]
    fn = jdem._inject_noise_vhs if vhs_noise else jdem._inject_noise
    return jax.jit(lambda a, r, n: fn(cfg, a, r, n))


def band_randstates() -> np.ndarray:
    """A randstate for each band line 10..17, the first found from 0 up."""
    found = {}
    for s in range(1000):
        head = (s * lcg.RAND_A + lcg.RAND_B) & lcg.MASK32
        found.setdefault((head >> 1) % 8 + 10, s)
    return np.array([found[b] for b in range(10, 18)], np.int32)


# --- on the CPU: the plain versions against JAX ------------------------------


@pytest.mark.parametrize("k", range(len(EDGE_NOISE)))
@pytest.mark.parametrize("name", ["NTSC", "PV1K", "NES"])
def test_inject_noise_matches_jax(name, k):
    """Full field, B = 3: the seeds cycle through EDGE_RN over the noise
    cases, so each preset meets every edge seed."""
    cfg = systems.SYSTEMS[name]
    rng = np.random.default_rng(k)
    analog = rng.integers(-128, 128, (3, cfg.vres, cfg.hres)).astype(np.int8)
    rn = EDGE_RN[(k + np.arange(3)) % len(EDGE_RN)]
    nz = np.full(3, EDGE_NOISE[k], np.int32)
    got = dem._inject_noise(cfg, torch.as_tensor(analog), torch.as_tensor(rn),
                            torch.as_tensor(nz))
    want = jax_noise(name, False)(analog, rn, nz)
    for tag, g, w in zip(("inp", "rn"), got, want):
        same(g, w, f"{name} {tag}")


@pytest.mark.parametrize("nz", [0, 40])
def test_inject_noise_vhs_every_band_matches_jax(nz):
    """Regions A (K11's plain version), B (K5's) and B+C (K12's) at every
    band line 10..17, one slot each."""
    cfg = systems.NTSCVHS
    rs = band_randstates()
    rng = np.random.default_rng(nz)
    analog = rng.integers(-128, 128, (len(rs), cfg.input_size)).astype(
        np.int8)
    knob = np.full(len(rs), nz, np.int32)
    got = dem._inject_noise_vhs(cfg, torch.as_tensor(analog),
                                torch.as_tensor(rs), torch.as_tensor(knob))
    want = jax_noise("NTSCVHS", True)(analog, rs, knob)
    for tag, g, w in zip(("inp", "randstate", "rn"), got, want):
        same(g, w, tag)


def test_tables_follow_the_generator_the_kernel_steps(monkeypatch):
    """K11 steps x -> ga * x + gc from a table entry; its plain version reads
    every entry instead.  So the tables the decoder hands K11 must be
    consecutive positions of that generator (NTSC's LCG; VHS region A's
    two crt_rand calls), and K12's a3 / c3 of the three-call stream."""
    seen = []

    def record(analog, apow, csum, rn, nz, **kw):
        seen.append((apow, csum, kw))
        return noise.inject_noise_plain(analog, apow, csum, rn, nz, **kw)
    monkeypatch.setattr(noise, "inject_noise", record)
    one = torch.ones(1, dtype=torch.int32)
    for cfg in (systems.NTSC, systems.NES):
        dem._inject_noise(cfg, torch.zeros((1, cfg.vres, cfg.hres),
                                           dtype=torch.int8), one, one)
    dem._inject_noise_vhs(systems.NTSCVHS, torch.zeros(
        (1, systems.NTSCVHS.input_size), dtype=torch.int8), one, one)
    assert [kw["shift"] for _, _, kw in seen] == [16, 16, 17]
    for apow, csum, kw in seen:
        a, c = lcg.u32(apow), lcg.u32(csum)
        same(a[1:], lcg.mul_u32(kw["ga"], a[:-1]), "apow")
        same(c[1:], (lcg.mul_u32(kw["ga"], c[:-1]) + kw["gc"]) & lcg.MASK32,
             "csum")
    # region A's first entry is one call from the head state
    assert seen[2][0][0] == lcg.to_i32(torch.tensor(lcg.RAND_A))
    tab = dem._vhs_tables(systems.NTSCVHS, torch.device("cpu"))
    a3, c3 = lcg.u32(tab["a3"]), lcg.u32(tab["c3"])
    assert int(a3[0]) == 1 and int(c3[0]) == 0
    same(a3[1:], lcg.mul_u32(vhs.A3, a3[:-1]), "a3")
    same(c3[1:], (lcg.mul_u32(vhs.A3, c3[:-1]) + vhs.C3) & lcg.MASK32, "c3")


def test_wrappers_on_cpu_tensors_never_import_build():
    """A CPU tensor takes the plain version without loading the kernel
    library's builder (no nvcc, no card)."""
    code = (
        "import sys, torch; "
        "from ntsc_crt_tpu_torch.models import demodulate as dem, systems; "
        "cfg = systems.NTSCVHS; one = torch.ones(2, dtype=torch.int32); "
        "dem._inject_noise(systems.NTSC, torch.zeros((2, 262, 910), "
        "dtype=torch.int8), one, one); "
        "dem._inject_noise_vhs(cfg, torch.zeros((2, cfg.input_size), "
        "dtype=torch.int8), one, one); "
        "assert 'ntsc_crt_tpu_torch.ops.kernels.build' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# --- on the card: the kernels against their plain versions -------------------


def k11_inputs(seed, B, N, off):
    """Random int8 samples (B, N) starting `off` bytes into their buffer,
    and the edge seeds and knobs dealt over the slots."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-128, 128, B * N + off).astype(np.int8)
    rn = np.resize(np.concatenate([EDGE_RN, rng.integers(
        I32_MIN, I32_MAX, 3, dtype=np.int64).astype(np.int32)]), B)
    nz = np.resize(np.array(EDGE_NOISE + (-3, 12), np.int32), B)
    return buf, rn, nz


# (N, n, shift, generator): NTSC; NES, N 2 mod 4; VHS region A, n odd; small
# rows that cross slots inside a 16-sample run and a warp's 1024 samples
K11_CASES = {"ntsc": (910 * 262, 910 * 262, 16, "lcg"),
             "nes": (909 * 262, 909 * 262, 16, "lcg"),
             "vhs_a": (910 * 262, 910 * 262 - 25 * 910 + 1, 17, "rand2"),
             "small": (7, 5, 16, "lcg"),
             "odd": (1030, 517, 17, "rand2")}


@pytest.mark.gpu
@pytest.mark.parametrize("off", [0, 1])     # 1: the unaligned byte path
@pytest.mark.parametrize("B", [1, 3, 33])
@pytest.mark.parametrize("case", list(K11_CASES))
def test_inject_noise_kernel_matches_plain(cuda, case, B, off):
    N, n, shift, gen = K11_CASES[case]
    ga, gc = ((lcg.LCG_A, lcg.LCG_B) if gen == "lcg"
              else (vhs.A2, vhs.C2))
    apow, csum = lcg._lcg_tables(n, ga, gc)
    buf, rn, nz = k11_inputs(B + off, B, N, off)
    args = lambda d: (  # noqa: E731
        torch.as_tensor(buf, device=d)[off:].view(B, N),
        torch.as_tensor(apow.view(np.int32), device=d),
        torch.as_tensor(csum.view(np.int32), device=d),
        torch.as_tensor(rn, device=d), torch.as_tensor(nz, device=d))
    kw = dict(shift=shift, ga=ga, gc=gc)
    want = noise.inject_noise(*args("cpu"), **kw)
    launches = build.LAUNCHES["inject_noise"]
    got = noise.inject_noise(*args(cuda), **kw)
    assert build.LAUNCHES["inject_noise"] == launches + 1
    for g, w in zip(got, want):
        same(g, w, case)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 33])
@pytest.mark.parametrize("H,N", [(910, 910 * 262), (909, 909 * 262),
                                 (7, 174), (8, 260), (3, 80)])
def test_vhs_noise_bc_kernel_matches_plain(cuda, H, N, B):
    """Regions B+C of 25H - 1 samples (odd at H 910 and 8, even at 909 and
    7), after a region A of N - 25H + 1 samples (both parities), from
    K5's entries of the edge seeds."""
    rng = np.random.default_rng(H + B)
    nB, nC = 19 * H, 6 * H - 1
    x = rng.integers(-128, 128, (B, N)).astype(np.int8)
    st0 = np.resize(np.concatenate([EDGE_RN, rng.integers(
        I32_MIN, I32_MAX, 3, dtype=np.int64).astype(np.int32)]), B)
    entB = vhs.vhs_region_b_entries(torch.as_tensor(st0, device=cuda),
                                    n_steps=nB, H=H)
    apow3, csum3 = lcg._lcg_tables(3 * nC, lcg.RAND_A, lcg.RAND_B)
    a3 = np.concatenate([np.ones(1, np.uint32), apow3[2::3]])[:nC]
    c3 = np.concatenate([np.zeros(1, np.uint32), csum3[2::3]])[:nC]
    cs = rng.integers(-64, 65, (8, nB + nC)).astype(np.int32)
    band = np.resize(np.arange(10, 18, dtype=np.int32), B)
    nz = np.resize(np.array(EDGE_NOISE + (40,), np.int32), B)
    args = lambda d: (  # noqa: E731
        torch.tensor(x, device=d), entB.to(d),       # x: a copy, K12 writes it
        *(torch.as_tensor(v, device=d) for v in (a3.view(np.int32),
                                                 c3.view(np.int32), cs,
                                                 band, nz)))
    want = noise.vhs_noise_bc(*args("cpu"), H=H)
    launches = build.LAUNCHES["vhs_noise_bc"]
    got = noise.vhs_noise_bc(*args(cuda), H=H)
    assert build.LAUNCHES["vhs_noise_bc"] == launches + 1
    for tag, g, w in zip(("x", "st_final", "rn"), got, want):
        same(g, w, tag)
