"""K1-K5 of the port: plain versions against the JAX kernels, and CUDA
kernels against the plain versions (K2's conv and bloom modes,
bloom_line_width and K6: tests/test_torch_variants.py).

On the CPU each plain version (the path a CPU tensor takes) is held against
the Pallas kernel it replaces, run in interpret mode as the JAX package's own
kernel tests run it.  The tests marked `gpu` hold each CUDA kernel against
its plain version on the card and skip without one.  Every value is an
integer: every comparison is exact (0 LSB).

JAX is imported inside the tests that use it, so the `gpu` tests also run
on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \
        tests/test_torch_kernels.py -m gpu
"""

import numpy as np
import pytest
import torch

from ntsc_crt_tpu.models.systems import NTSC
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.ops import filters
from ntsc_crt_tpu_torch.ops.kernels import ccf, decode, encode, hsync, vhs

torch.set_num_threads(1)  # the tier runs several workers on few cores

IIR = tuple(filters.init_iir(NTSC.l_freq, f)
            for f in (NTSC.y_freq, NTSC.i_freq, NTSC.q_freq))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


def to_torch(d, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def same(got, want):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), f"{int((got != want).sum())} differ"


# --- K1 encode_rows ---------------------------------------------------------


def k1_inputs(seed, B, h, w, desth, cc):
    rng = np.random.default_rng(seed)
    sy = np.sort(rng.integers(0, h, (B, desth)), axis=1)
    return dict(
        img=rng.integers(0, 256, (B, h, w, 3)).astype(np.uint8),
        sy=sy.astype(np.int32),
        modI=rng.integers(-32, 33, (B, cc)).astype(np.int32),
        modQ=rng.integers(-32, 33, (B, cc)).astype(np.int32),
        gain=rng.integers(50, 150, B).astype(np.int32),
        base=rng.integers(-20, 30, B).astype(np.int32))


def k1_jax(x, destw, xo_mod, col_map):
    """encode_fused_rows (interpret) on the same rows: narrow rows with the
    static column map, or host-resampled wide planes without one."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import encode_fused as ef
    B, h, w, _ = x["img"].shape
    desth = x["sy"].shape[1]
    rows = x["img"][np.arange(B)[:, None], x["sy"]]       # (B, desth, w, 3)
    cmap = (np.arange(destw) * w) // destw
    if not col_map:
        rows = rows[:, :, cmap]
    planes = [jnp.asarray(rows[..., c].reshape(B * desth, -1))
              for c in range(3)]
    per_row = lambda v: jnp.asarray(np.repeat(v, desth, axis=0))
    out = ef.encode_fused_rows(
        *planes, per_row(x["modI"]), per_row(x["modQ"]), per_row(x["gain"]),
        per_row(x["base"]), coefs=IIR, xo_mod=xo_mod, rgb=True,
        interpret=True,
        col_map=tuple(int(v) for v in cmap) if col_map else None)
    return np.asarray(out).reshape(B, desth, destw)


@pytest.mark.parametrize("cc,w,destw,col_map", [
    (4, 20, 32, True),                         # in-kernel map, upsampling
    (4, 100, 256, False), (5, 300, 256, False)])
def test_k1_plain_matches_jax_kernel(cc, w, destw, col_map):
    x = k1_inputs(cc + w, B=2, h=9, w=w, desth=8, cc=cc)
    xo_mod = 3 % cc
    got = encode.encode_rows(**to_torch(x), coefs=IIR, xo_mod=xo_mod,
                             destw=destw)
    same(got, k1_jax(x, destw, xo_mod, col_map))


@pytest.mark.gpu
@pytest.mark.parametrize("cc", [4, 5])
def test_k1_kernel_matches_plain(cuda, cc):
    x = k1_inputs(cc, B=3, h=240, w=320, desth=236, cc=cc)
    kw = dict(coefs=IIR, xo_mod=2, destw=NTSC.av_len)
    want = encode.encode_rows(**to_torch(x), **kw)
    n = encode.LAUNCHES
    same(encode.encode_rows(**to_torch(x, cuda), **kw), want)
    assert encode.LAUNCHES == n + 1


# --- K2 decode_rows (three-band) ---------------------------------------------


def k2_inputs(seed, B, L, H, cc, locked=False, row0=1):
    rng = np.random.default_rng(seed)
    shifts = rng.integers(0, H, (B, L))
    if locked:
        shifts = np.full((B, L), H - 7)
    waveI = rng.integers(-60000, 60000, (B, L, cc)).astype(np.int32)
    waveQ = (np.roll(waveI, -3, axis=-1) if cc == 4 else
             rng.integers(-60000, 60000, (B, L, cc)).astype(np.int32))
    return dict(
        rows=rng.integers(-127, 128, (B, row0 + L + 2, H)).astype(np.int8),
        shifts=shifts.astype(np.int32), waveI=waveI, waveQ=waveQ,
        bright=rng.integers(-20, 20, (B, L)).astype(np.int32),
        contrast=rng.integers(150, 200, (B, L)).astype(np.int32))


def k2_jax(x, row0, av_len, outw):
    """decode_fused_rows (interpret) fed the line rows as the two planes
    ext / ext_hi, shifts up to H - 1."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import decode_fused as df
    B, L = x["shifts"].shape
    H = x["rows"].shape[2]
    flat = lambda v: jnp.asarray(v.reshape((B * L,) + v.shape[2:]))
    ext = x["rows"][:, row0:row0 + L]
    ext_hi = x["rows"][:, row0 + 1:row0 + L + 1]
    r8, g8, b8 = df.decode_fused_rows(
        flat(ext), flat(x["shifts"]), flat(x["waveI"]), flat(x["waveQ"]),
        flat(x["bright"]), flat(x["contrast"]), ext_hi=flat(ext_hi),
        outw=outw, av_len=av_len, max_shift=H - 1,
        coefs=tuple(tuple(c) for c in dem._eq_coefs(NTSC)), interpret=True)
    rgb = np.stack([np.asarray(v) for v in (r8, g8, b8)], axis=-1)
    return rgb.reshape(B, L, outw, 3)


@pytest.mark.parametrize("locked", [False, True])
def test_k2_plain_matches_jax_kernel(locked):
    """cc = 4 only: each JAX interpret compile of this kernel costs about a
    minute; 5-sample waves differ only in the Q table the caller passes."""
    row0, av_len, outw = 1, 128, 48
    x = k2_inputs(7, B=2, L=24, H=160, cc=4, locked=locked, row0=row0)
    got = decode.decode_rows(**to_torch(x), row0=row0,
                             coefs=dem._eq_coefs(NTSC), av_len=av_len,
                             outw=outw)
    same(got, k2_jax(x, row0, av_len, outw))


@pytest.mark.gpu
@pytest.mark.parametrize("cc", [4, 5])
def test_k2_kernel_matches_plain(cuda, cc):
    x = k2_inputs(cc, B=2, L=NTSC.lines, H=NTSC.hres, cc=cc, row0=3)
    kw = dict(row0=3, coefs=dem._eq_coefs(NTSC), av_len=NTSC.av_len,
              outw=640)
    want = decode.decode_rows(**to_torch(x), **kw)
    n = decode.LAUNCHES
    same(decode.decode_rows(**to_torch(x, cuda), **kw), want)
    assert decode.LAUNCHES == n + 1


# --- K3 hsync_chase ----------------------------------------------------------

K3 = dict(W=8, c0=20, thresh=4 * -40, H=300)


def k3_inputs(seed, B, L=21, HP=512, locked=True):
    """Line rows with a -40 sync pulse near a jittering edge, plus noise;
    `locked` starts the estimate at the edge, else anywhere."""
    rng = np.random.default_rng(seed)
    rows2 = rng.integers(-30, 60, (B, L, HP))
    edge = 100 + rng.integers(-5, 6, (B, L))
    cols = np.arange(HP)
    pulse = (cols >= edge[..., None] + K3["c0"]) \
        & (cols < edge[..., None] + K3["c0"] + 40)
    rows2 = np.where(pulse, -40 + rng.integers(-3, 4, (B, L, HP)), rows2)
    h0 = (np.full(B, 100 - K3["W"]) if locked else
          rng.integers(0, K3["H"], B))
    return dict(rows2=rows2.astype(np.int8),
                active_l=rng.random((B, L)) > 0.2,
                hsync0=h0.astype(np.int32))


@pytest.mark.parametrize("B,locked", [(1, True), (1, False), (16, True),
                                      (16, False)])
def test_k3_plain_matches_jax_kernel(B, locked):
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import hsync_scan as hsk
    x = k3_inputs(B + locked, B, locked=locked)
    got = hsync.hsync_chase(**to_torch(x), **K3)
    want = hsk.hsync_chase(*(jnp.asarray(x[k]) for k in
                             ("rows2", "active_l", "hsync0")),
                           interpret=True, **K3)
    same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
def test_k3_kernel_matches_plain(cuda, B):
    x = k3_inputs(B, B, L=NTSC.lines, locked=False)
    want = hsync.hsync_chase(**to_torch(x), **K3)
    n = hsync.LAUNCHES
    same(hsync.hsync_chase(**to_torch(x, cuda), **K3), want)
    assert hsync.LAUNCHES == n + 1


# --- K4 ccf_ema --------------------------------------------------------------


def k4_inputs(seed, B, L, m, CC, VP, lim=1 << 20):
    rng = np.random.default_rng(seed)
    return dict(
        per_cls=rng.integers(-lim, lim, (B, L, m, CC)).astype(np.int32),
        vper_l=rng.integers(0, VP, (B, L)).astype(np.int32),
        active_l=rng.random((B, L)) > 0.3,
        ccf0=rng.integers(-lim, lim, (B, VP, CC)).astype(np.int32))


@pytest.mark.parametrize("VP,CC,m,B,L,lim", [
    (3, 4, 5, 7, 33, 1 << 20),      # the shapes of test_pallas_kernels.py
    (1, 4, 5, 9, 26, 1 << 20),
    (5, 8, 4, 17, 30, 1 << 20),
    (3, 4, 5, 1, 40, 1 << 20),
    (1, 4, 10, 3, 24, 1 << 30)])    # full range: ccr * 127 wraps
def test_k4_plain_matches_jax_kernel(VP, CC, m, B, L, lim):
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import ccf_scan
    x = k4_inputs(VP + CC + B + L, B, L, m, CC, VP, lim)
    got_f, got_r = ccf.ccf_ema(**to_torch(x))
    want_f, want_r = ccf_scan.ccf_ema(
        *(jnp.asarray(x[k]) for k in ("per_cls", "vper_l", "active_l",
                                      "ccf0")), interpret=True)
    same(got_f, want_f)
    same(got_r, want_r)


@pytest.mark.gpu
@pytest.mark.parametrize("B,VP,CC", [(1, 1, 4), (64, 1, 4), (5, 5, 5)])
def test_k4_kernel_matches_plain(cuda, B, VP, CC):
    x = k4_inputs(B, B, NTSC.lines, NTSC.burst_len // CC, CC, VP, 1 << 30)
    want = ccf.ccf_ema(**to_torch(x))
    n = ccf.LAUNCHES
    got = ccf.ccf_ema(**to_torch(x, cuda))
    assert ccf.LAUNCHES == n + 1
    same(got[0], want[0])
    same(got[1], want[1])


# --- K5 vhs_region_b_entries ---------------------------------------------------

VHS_H = 910


def k5_seeds(seed, B):
    """int32 bit patterns of uint32 seeds over the whole range, its ends
    included."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 2**32, B, dtype=np.uint64)
    st[:2] = [0, 2**32 - 1][:B]
    return st.astype(np.uint32)


@pytest.mark.parametrize("B", [1, 5])
def test_k5_plain_matches_jax_kernel(B):
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import vhs_scan
    st0 = k5_seeds(B, B)
    got = vhs.vhs_region_b_entries(torch.as_tensor(st0.view(np.int32)),
                                   n_steps=19 * VHS_H, H=VHS_H)
    want = vhs_scan.vhs_region_b_entries(jnp.asarray(st0), n_steps=19 * VHS_H,
                                         H=VHS_H, interpret=True)
    same(got, np.asarray(want).view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
def test_k5_kernel_matches_plain(cuda, B):
    st0 = torch.as_tensor(k5_seeds(B + 1, B).view(np.int32))
    kw = dict(n_steps=19 * VHS_H, H=VHS_H)
    want = vhs.vhs_region_b_entries(st0, **kw)
    n = vhs.LAUNCHES
    same(vhs.vhs_region_b_entries(st0.to(cuda), **kw), want)
    assert vhs.LAUNCHES == n + 1


# --- dispatch -----------------------------------------------------------------


def k2_bloom_inputs():
    x = k2_inputs(0, B=1, L=4, H=160, cc=4)
    return dict(x, bloom_dx=np.full((1, 4), 4000, np.int32),
                bloom_lidx=np.full((1, 4), 9, np.int32))


@pytest.mark.parametrize("name", ["encode_rows", "decode_rows", "hsync_chase",
                                  "ccf_ema", "vhs_region_b_entries",
                                  "decode_rows_conv", "decode_rows_bloom",
                                  "bloom_line_width", "place_rows_uniform"])
def test_non_cpu_tensors_never_take_the_plain_version(name):
    """Only a CPU tensor takes the plain version.  Any other tensor goes to
    the kernel path, which refuses a tensor that is not on a CUDA device
    before it builds or launches anything."""
    from ntsc_crt_tpu_torch.ops.kernels import place
    k2 = dict(row0=1, av_len=64, outw=48)
    call = {
        "encode_rows": lambda x: encode.encode_rows(
            **x, coefs=IIR, xo_mod=0, destw=32),
        "decode_rows": lambda x: decode.decode_rows(
            **x, coefs=dem._eq_coefs(NTSC), **k2),
        "hsync_chase": lambda x: hsync.hsync_chase(**x, **K3),
        "ccf_ema": lambda x: ccf.ccf_ema(**x),
        "vhs_region_b_entries": lambda x: vhs.vhs_region_b_entries(
            **x, n_steps=19 * VHS_H, H=VHS_H),
        "decode_rows_conv": lambda x: decode.decode_rows(
            **x, coefs=("conv", 7), **k2),
        "decode_rows_bloom": lambda x: decode.decode_rows(
            **x, coefs=dem._eq_coefs(NTSC), **k2),
        "bloom_line_width": lambda x: decode.bloom_line_width(**x),
        "place_rows_uniform": lambda x: place.place_rows_uniform(
            **x, blend=True, scanlines=1, ratio=2, fp=1),
    }[name]
    x = {"encode_rows": lambda: k1_inputs(0, B=1, h=9, w=20, desth=8, cc=4),
         "decode_rows": lambda: k2_inputs(0, B=1, L=4, H=160, cc=4),
         "hsync_chase": lambda: k3_inputs(0, B=1),
         "ccf_ema": lambda: k4_inputs(0, 1, 4, 10, 4, 1),
         "vhs_region_b_entries": lambda: dict(
             st0=k5_seeds(0, 2).view(np.int32)),
         "decode_rows_conv": lambda: k2_inputs(0, B=1, L=4, H=160, cc=4),
         "decode_rows_bloom": k2_bloom_inputs,
         "bloom_line_width": lambda: dict(
             sums=np.zeros((2, 8), np.int32), max_e=np.ones(2, np.int32)),
         "place_rows_uniform": lambda: dict(
             rgb=np.zeros((2, 4, 8, 3), np.uint8),
             old=np.zeros((2, 8, 8, 3), np.uint8),
             field_px=np.ones(2, np.int32))}[name]()
    counter = {"encode_rows": (encode, "LAUNCHES"),
               "decode_rows": (decode, "LAUNCHES"),
               "hsync_chase": (hsync, "LAUNCHES"),
               "ccf_ema": (ccf, "LAUNCHES"),
               "vhs_region_b_entries": (vhs, "LAUNCHES"),
               "decode_rows_conv": (decode, "CONV_LAUNCHES"),
               "decode_rows_bloom": (decode, "BLOOM_LAUNCHES"),
               "bloom_line_width": (decode, "LINE_WIDTH_LAUNCHES"),
               "place_rows_uniform": (place, "LAUNCHES")}[name]
    n = getattr(*counter)
    with pytest.raises(ValueError, match="expected a tensor on"):
        call({k: torch.as_tensor(v).to("meta") for k, v in x.items()})
    assert getattr(*counter) == n
