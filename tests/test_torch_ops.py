"""The port's integer ops against the JAX package's, on the CPU.

Every value is an integer, so every comparison is exact (0 LSB).  Inputs come
from a seeded numpy generator and go to both packages as numpy arrays."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntsc_crt_tpu.models.systems import NTSC
from ntsc_crt_tpu.ops import fastpath as jfast
from ntsc_crt_tpu.ops import filters as jfilt
from ntsc_crt_tpu.ops import fixedpoint as jfix
from ntsc_crt_tpu.ops import lcg as jlcg
from ntsc_crt_tpu_torch.ops import fastpath, filters, fixedpoint, lcg

torch.set_num_threads(1)  # the tier runs several workers on few cores

I32 = np.iinfo(np.int32)


def eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), int((got != want).sum())


def test_sincos14_full_angle_sweep():
    n = np.arange(-2 * 16384, 2 * 16384, dtype=np.int32)
    s, c = fixedpoint.sincos14(torch.as_tensor(n))
    js, jc = jfix.sincos14(jnp.asarray(n))
    eq(s, js)
    eq(c, jc)
    ns, nc = fixedpoint.np_sincos14(n)
    eq(ns, jfix.np_sincos14(n)[0])
    eq(nc, jfix.np_sincos14(n)[1])
    for a in (-16385, -1, 0, 4095, 4096, 8191, 12288, 16383, 99999):
        assert fixedpoint.host_sincos14(a) == jfix.host_sincos14(a)


@pytest.mark.parametrize("seed", [0, 1])
def test_truncating_div_rem_posmod(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-(1 << 20), 1 << 20, 4096).astype(np.int32)
    b = rng.integers(1, 300, 4096).astype(np.int32)
    b = np.where(rng.random(4096) < 0.5, -b, b).astype(np.int32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    eq(fixedpoint.cdiv(ta, tb), jfix.cdiv(a, b))
    eq(fixedpoint.crem(ta, tb), jfix.crem(a, b))
    eq(fixedpoint.cdiv(ta, 7), jfix.cdiv(a, 7))
    eq(fixedpoint.crem(ta, 7), jfix.crem(a, 7))
    eq(fixedpoint.posmod(ta, 910), jfix.posmod(a, 910))
    for x, y in zip(a[:64].tolist(), b[:64].tolist()):
        assert fixedpoint.host_tdiv(x, y) == jfix.host_tdiv(x, y)


def test_i32_wraps_like_jax():
    x = np.array([0, 1, -1, 2**31 - 1, 2**31, 2**32 + 5, -(2**31) - 1],
                 np.int64)
    eq(fixedpoint.i32(torch.as_tensor(x)), x.astype(np.int32))


def test_host_expx_and_filter_coefficients():
    for n in range(-40000, 40000, 97):
        assert fixedpoint.host_expx(n) == jfix.host_expx(n)
    for f in (NTSC.y_freq, NTSC.i_freq, NTSC.q_freq, 62700, 37000):
        assert filters.init_iir(NTSC.l_freq, f) == jfilt.init_iir(NTSC.l_freq, f)
    k = NTSC.khz2l
    for lo, hi in ((1500, 3000), (80, 1150), (80, 1000)):
        assert tuple(filters.init_eq(k(lo), k(hi), NTSC.hres, 65536, 8192,
                                     9175)) == \
            tuple(jfilt.init_eq(k(lo), k(hi), NTSC.hres, 65536, 8192, 9175))


def test_lcg_tables_and_noise_bytes():
    for n in (1, 17, NTSC.input_size):
        for a, b in ((lcg.LCG_A, lcg.LCG_B), (1103515245, 12345)):
            pa, pc = lcg._lcg_tables(n, a, b)
            ja, jc = jlcg._lcg_tables(n, a, b)
            eq(pa, ja)
            eq(pc, jc)
    n = 5000
    for seed in (194, 0, -1, -(2**31), 2**31 - 1, 123456789):
        got, rn = lcg.noise_bytes(torch.tensor(seed, dtype=torch.int32), n)
        want, jrn = jlcg.noise_bytes(jnp.int32(seed), n)
        eq(got, want)
        eq(rn, jrn)


@pytest.mark.parametrize("seed", [0, 1])
def test_iir_lowpass_random_rows(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(-30000, 30000, (5, 3, 97)).astype(np.int32)
    c = rng.integers(0, 2048, (5, 3)).astype(np.int32)
    eq(filters.iir_lowpass(torch.as_tensor(s), torch.as_tensor(c)),
       jfilt.iir_lowpass(jnp.asarray(s), jnp.asarray(c)))


@pytest.mark.parametrize("seed", [0, 1])
def test_eq_threeband_random_rows(seed):
    """Full-range inputs: the int32 products wrap in both packages."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-(1 << 20), 1 << 20, (4, 3, 131)).astype(np.int32)
    coefs = [rng.integers(0, 1 << 17, (1, 3)).astype(np.int32)
             for _ in range(5)]
    got = filters.eq_threeband(torch.as_tensor(s),
                               *map(torch.as_tensor, coefs))
    eq(got, jfilt.eq_threeband(jnp.asarray(s), *map(jnp.asarray, coefs)))


def test_shift_rows_tile_period_select_rows():
    rng = np.random.default_rng(3)
    ext = rng.integers(-127, 128, (40, 300)).astype(np.int8)
    sh = rng.integers(0, 300 - 128 + 1, 40).astype(np.int32)
    eq(fastpath.shift_rows(torch.as_tensor(ext), torch.as_tensor(sh), 128),
       jfast.shift_rows(jnp.asarray(ext), jnp.asarray(sh), 128))
    vals = rng.integers(-1000, 1000, (3, 7, 4)).astype(np.int32)
    for off in (0, 1, 3, 6):
        eq(fastpath.tile_period(torch.as_tensor(vals), 53, off),
           jfast.tile_period(jnp.asarray(vals), 53, off))
    data = rng.integers(0, 256, (3, 11, 5, 3)).astype(np.uint8)
    idx = rng.integers(0, 11, (3, 9)).astype(np.int32)
    eq(fastpath.select_rows_batched(torch.as_tensor(data),
                                    torch.as_tensor(idx)),
       jfast.select_rows_batched(jnp.asarray(data), jnp.asarray(idx)))


@pytest.mark.parametrize("av,outw", [(753, 640), (128, 100), (60, 128)])
def test_lerp_resample_exact(av, outw):
    """Full-range int32 inputs against JAX's 5-limb form (exact mod 2^32),
    small inputs against its 3-limb default."""
    rng = np.random.default_rng(av)
    for j, want in zip(fastpath.lerp_resample_weights(av, outw),
                       jfast.lerp_resample_weights(av, outw)):
        eq(j, want)
    big = rng.integers(I32.min, I32.max, (6, av), dtype=np.int64)
    big = big.astype(np.int32)
    small = rng.integers(-(1 << 20), 1 << 20, (6, av)).astype(np.int32)
    for sh in (2, 14):
        eq(fastpath.lerp_resample(torch.as_tensor(big), outw, sh),
           jfast.lerp_resample(jnp.asarray(big), outw, sh, wide=True))
        eq(fastpath.lerp_resample(torch.as_tensor(small), outw, sh),
           jfast.lerp_resample(jnp.asarray(small), outw, sh, wide=False))
