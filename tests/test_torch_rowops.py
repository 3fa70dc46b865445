"""K7-K10 of the port on the CPU: the row filters, the scan conversion and the
issue-rate probe against the JAX package.

Each plain version (the path a CPU tensor takes) is held against the Pallas
kernel it replaces, run in interpret mode as the JAX package's own kernel
tests run it, and against the JAX package's plain scans; the ops-level entry
points (`filters.iir_lowpass`, with `hipass`, and `filters.eq_threeband`)
against the JAX ops; the unfused decode chain (K8 then K9) against K2's
plain version on the inputs the NTSC and PV1K decodes hand K2.  The CUDA
kernels are held against these plain versions in tests/test_torch_kernels.py
(marked `gpu`).  Every value is an integer: every comparison is exact
(0 LSB)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntsc_crt_tpu.ops import filters as jfilters
from ntsc_crt_tpu.ops.pallas import filters_pallas, scanconv_pallas, vpu_probe
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.ops import filters
from ntsc_crt_tpu_torch.ops.kernels import decode, probe, rowfilters, scanconv

torch.set_num_threads(1)  # the tier runs several workers on few cores

NTSC = systems.NTSC


def same(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), f"{int((got != want).sum())} differ"


def eq_coef_rows(rng, R):
    """Per-row 3-band coefficients: the NTSC Y/I/Q sets, dealt at random."""
    sets = np.array([tuple(c) for c in dem._eq_coefs(NTSC)], np.int32)
    return sets[rng.integers(0, 3, R)].T                  # (5, R)


# --- K7 iir_lowpass_rows / K8 eq_threeband_rows --------------------------------


# T mod 4 = 1, 2, 3 beside the cases' 0 (the kernel's row starts are only
# 4-byte aligned at odd T), on full-range samples whose sums wrap
T_MOD4 = [(3, 41, 1 << 31), (2, 42, 300), (33, 43, 1 << 20)]


@pytest.mark.parametrize("R,T,lim", [(5, 40, 300), (130, 20, 1 << 30)]
                         + T_MOD4)
def test_k7_plain_matches_jax_kernel_and_scan(R, T, lim):
    rng = np.random.default_rng(R + T)
    x = rng.integers(-lim, lim, (R, T)).astype(np.int32)
    c = rng.integers(0, 2048, R).astype(np.int32)
    got = rowfilters.iir_lowpass_rows(torch.as_tensor(x), torch.as_tensor(c))
    same(got, filters_pallas.iir_lowpass_rows(jnp.asarray(x), jnp.asarray(c),
                                              interpret=True))
    same(got, jfilters.iir_lowpass(jnp.asarray(x), jnp.asarray(c)))


@pytest.mark.parametrize("R,T,lim", [(6, 40, 300), (130, 20, 1 << 20)]
                         + T_MOD4)
def test_k8_plain_matches_jax_kernel_and_scan(R, T, lim):
    rng = np.random.default_rng(R * T)
    x = rng.integers(-lim, lim, (R, T)).astype(np.int32)
    cs = eq_coef_rows(rng, R)
    got = rowfilters.eq_threeband_rows(torch.as_tensor(x),
                                       *map(torch.as_tensor, cs))
    same(got, filters_pallas.eq_threeband_rows(
        jnp.asarray(x), *map(jnp.asarray, cs), interpret=True))
    same(got, jfilters.eq_threeband(jnp.asarray(x),
                                    *map(jnp.asarray, cs)))


@pytest.mark.parametrize("hipass", [False, True])
def test_iir_lowpass_op_matches_jax(hipass):
    """The ops-level entry: lead dims flattened to rows and `c` broadcast
    over them, as the encoders' (B, desth, 3, destw) YIQ stack passes it."""
    rng = np.random.default_rng(int(hipass))
    s = rng.integers(-200, 400, (2, 3, 3, 37)).astype(np.int32)
    c = np.array([1500, 700, 300], np.int32)[None, None, :]
    got = filters.iir_lowpass(torch.as_tensor(s), torch.as_tensor(c),
                              hipass=hipass)
    same(got, jfilters.iir_lowpass(jnp.asarray(s), jnp.asarray(c),
                                   hipass=hipass))


def test_eq_threeband_op_matches_jax():
    """Y/I/Q on a channel axis, one coefficient set a channel."""
    rng = np.random.default_rng(4)
    s = rng.integers(-40000, 40000, (2, 5, 3, 33)).astype(np.int32)
    cs = [np.array(v, np.int32)[None, None, :]
          for v in zip(*dem._eq_coefs(systems.PV1K))]
    got = filters.eq_threeband(torch.as_tensor(s), *map(torch.as_tensor, cs))
    same(got, jfilters.eq_threeband(jnp.asarray(s), *map(jnp.asarray, cs)))


# --- K9 scanconv_rows ------------------------------------------------------------


@pytest.mark.parametrize("T,outw,lim", [(40, 24, 1 << 14), (9, 8, 1 << 27),
                                        (1, 3, 1 << 20)])
def test_k9_plain_matches_jax_kernel(T, outw, lim):
    """Wide values make y * L >> 2 wrap in int32.  The map keeps s + 1 <=
    T - 1 for T >= 2; at T = 1 every pixel reads s + 1 == T, the zero
    tail."""
    rng = np.random.default_rng(T + outw)
    oy, oi, oq = (rng.integers(-lim, lim, (6, T)).astype(np.int32)
                  for _ in range(3))
    ct = rng.integers(0, 400, 6).astype(np.int32)
    got = scanconv.scanconv_rows(*map(torch.as_tensor, (oy, oi, oq, ct)),
                                 outw=outw)
    same(got, scanconv_pallas.scanconv_rows(*map(jnp.asarray,
                                                 (oy, oi, oq, ct)),
                                            outw=outw, interpret=True))


# --- the unfused decode chain against K2 ---------------------------------------


def k2_inputs_of_step(cfg, B):
    """The arguments the decode hands K2 (decode.decode_rows) on the second
    step of a batch-B run at 96x72, noise 12."""
    seen = {}
    real = decode.decode_rows

    def rec(*a, **k):
        seen["args"] = (a, k)
        return real(*a, **k)

    rng = np.random.default_rng(B)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, 48, 64, 3)
                                        ).astype(np.uint8))
    st = pipeline.init_batch(cfg, B, 96, 72, device="cpu")
    fields = torch.arange(B, dtype=torch.int32) % 2
    st = pipeline.step_batch(cfg, st, imgs, fields, fields, fields * 0,
                             noise=12)
    decode.decode_rows = rec
    try:
        pipeline.step_batch(cfg, st, imgs, 1 - fields, fields, fields * 0,
                            noise=12)
    finally:
        decode.decode_rows = real
    return seen["args"]


@pytest.mark.parametrize("name,B", [("NTSC", 2), ("PV1K", 1)])
def test_unfused_chain_equals_k2_plain(name, B):
    a, k = k2_inputs_of_step(systems.SYSTEMS[name], B)
    same(scanconv.decode_rows_unfused(*a, **k), decode.decode_rows_plain(*a,
                                                                          **k))


# --- K10 probe ------------------------------------------------------------------


@pytest.mark.parametrize("pattern", probe.PATTERNS)
def test_k10_plain_matches_jax_probe(pattern):
    got = probe.probe(probe.probe_input(2, "cpu"), pattern, iters=8)
    same(got, vpu_probe.probe(pattern, iters=8, blocks=2, interpret=True))


def test_probe_counts_match_jax():
    for p in probe.PATTERNS:
        assert probe.ops_per_iter(p) == vpu_probe.ops_per_iter(p), p
    assert probe.EQ_OPS_PER_STEP == vpu_probe.EQ_OPS_PER_STEP
    assert probe.COEFS == vpu_probe._COEFS
