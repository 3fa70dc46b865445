"""The port's decode build variants against the JAX package, on the CPU.

The variants are the reference's compile-time builds: the convolution EQ
(eq_mode conv4..conv7), beam-energy bloom (do_bloom), fixed sync
(do_vsync / do_hsync False) and the NTSC_RAINBOW preset.  Live steps compare
every state leaf with the JAX step; the golden tags `NTSC_bloom` and
`NTSC_conv7` replay through the port; the plain versions of K2's conv and
bloom modes, of bloom_line_width (the line sums and the energy chain) and
of K6 place_rows_uniform are held against the Pallas kernels (interpret
mode) and the JAX functions and expressions they replace.  The tests
marked `gpu` hold each CUDA kernel against its plain version on the card
and skip without one.  Every value is an integer: every comparison is
exact (0 LSB).

JAX is imported inside the tests that use it, so the `gpu` tests also run
on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \
        tests/test_torch_variants.py -m gpu
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.ops import filters
from ntsc_crt_tpu_torch.ops.kernels import decode, place

torch.set_num_threads(1)  # the tier runs several workers on few cores

GOLDENS = (Path(__file__).resolve().parent / "fixtures"
           / "device_parity_goldens.npz")
NTSC = systems.NTSC


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
        f"{tag}: {int((got != want).sum())} elements differ"


def t(d, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


# --- live steps against the JAX step -----------------------------------------

# (preset, step keywords, batch, (outw, outh), monitor knobs).  The tall
# outputs (outh a multiple of the 240 lines) take the uniform row placement
# (K6's plain version); the bloom cases take the general one with `valid`.
VARIANTS = [
    ("NTSC", dict(eq_mode="conv4"), 1, (128, 96), {}),
    ("NTSC", dict(eq_mode="conv5"), 4, (96, 480), {}),
    ("NTSC", dict(eq_mode="conv6"), 1, (128, 96), {}),
    ("NTSC", dict(eq_mode="conv7"), 4, (128, 96), {}),
    ("NTSC", dict(do_bloom=True), 1, (128, 96), {}),
    ("NTSC", dict(do_bloom=True), 4, (128, 96), dict(blend=1, scanlines=1)),
    ("NTSC", dict(do_vsync=False), 1, (128, 96), {}),
    ("NTSC", dict(do_hsync=False), 4, (64, 240), dict(blend=1)),
    ("NTSC_RAINBOW", {}, 1, (128, 96), {}),
    ("NTSCVHS", dict(do_bloom=True, do_aberration=1), 4, (128, 96), {}),
]


@pytest.mark.parametrize(
    "name,kw,B,geom,knobs", VARIANTS,
    ids=["-".join([v[0], *(f"{k}={x}" for k, x in v[1].items()), f"b{v[2]}"])
         for v in VARIANTS])
def test_step_variant_matches_jax(name, kw, B, geom, knobs):
    """Two steps, field/frame (0, 0) then (1, 1) (per slot, mixed, at batch
    4), noise 12, every state leaf compared after each."""
    import jax.numpy as jnp
    from helpers import run_step
    from ntsc_crt_tpu.models import pipeline as jpipe
    from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
    from ntsc_crt_tpu.models.systems import SYSTEMS as JSYSTEMS
    from ntsc_crt_tpu_torch.utils import convert

    cfg, jcfg = systems.SYSTEMS[name], JSYSTEMS[name]
    outw, outh = geom
    rng = np.random.default_rng(len(name) + B + outh)
    img = rng.integers(0, 256, (B, 48, 64, 3)).astype(np.uint8)
    jst = jpipe.crt_init(jcfg, outw, outh, batch=B)
    jst = jst._replace(rn=jnp.arange(194, 194 + B, dtype=jnp.int32),
                       randstate=jnp.arange(1, 1 + B, dtype=jnp.int32))
    st = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, device="cpu")
    jmon = JMon(**{k: np.int32(v) for k, v in knobs.items()})
    mon = MonitorParams(**knobs)
    slot = np.arange(B, dtype=np.int32)
    for f in (0, 1):
        ff = (slot + f) % 2 if B > 1 else np.int32(f)
        step_kw = dict(field=ff, frame=ff, hue=7, noise=12, **kw)
        jst = run_step(jcfg, jst, img, mon=jmon, **step_kw)
        st = pipeline.step(cfg, st, torch.as_tensor(img), mon=mon,
                           **{k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                              else v for k, v in step_kw.items()})
        got = convert.state_to_numpy(st)
        for k, v in jst._asdict().items():
            same(got[k], np.asarray(v), f"{name} {kw} step {f} {k}")


def test_unknown_eq_mode_raises():
    st = pipeline.crt_init(NTSC, 64, 48, device="cpu")
    with pytest.raises(ValueError, match="eq_mode"):
        pipeline.demodulate(NTSC, st, eq_mode="conv3")


# --- goldens (the recipe of bench.py:198-235, without its JAX code) --------


@pytest.mark.parametrize("tag,kw", [("NTSC_bloom", dict(do_bloom=True)),
                                    ("NTSC_conv7", dict(eq_mode="conv7"))])
def test_golden_variant(tag, kw):
    """Two 320x240 frames at 128x96, noise 7, field/frame (0,0) then
    (1,1), with the tag's build variant."""
    ref = np.load(GOLDENS)
    img = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3),
                                           np.uint8)[0]
    st = pipeline.crt_init(NTSC, 128, 96, device="cpu")
    for f in (0, 1):
        st = pipeline.step(NTSC, st, torch.as_tensor(img), field=f, frame=f,
                           noise=7, **kw)
    for k, v in st._asdict().items():
        same(v, ref[f"{tag}/{k}"], f"{tag} {k}")


# --- K2's conv and bloom modes ----------------------------------------------


def k2_inputs(seed, B, L, H, av_len, outw, bloom=False, row0=1):
    """Random rows and per-line tables; with bloom, per-line pixel steps
    near the drawn width and EQ starts as the decoder makes them (the
    shifts then reach past H - 1)."""
    rng = np.random.default_rng(seed)
    waveI = rng.integers(-60000, 60000, (B, L, 4)).astype(np.int32)
    x = dict(
        rows=rng.integers(-127, 128, (B, row0 + L + 2, H)).astype(np.int8),
        shifts=rng.integers(0, H, (B, L)).astype(np.int32),
        waveI=waveI, waveQ=np.roll(waveI, -3, axis=-1),
        bright=rng.integers(-20, 20, (B, L)).astype(np.int32),
        contrast=rng.integers(150, 200, (B, L)).astype(np.int32))
    if bloom:
        lidx = rng.integers(2, 12, (B, L))
        width = av_len - 2 * lidx + rng.integers(-6, 7, (B, L))
        x["bloom_dx"] = ((width << 12) // outw).astype(np.int32)
        x["bloom_lidx"] = lidx.astype(np.int32)
        x["shifts"] = (x["shifts"] + lidx).astype(np.int32)
    return x


def k2_jax(x, row0, av_len, outw, coefs, max_shift):
    """decode_fused_rows (interpret) fed the line rows as the two planes
    ext / ext_hi."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import decode_fused as df
    B, L = x["shifts"].shape
    flat = lambda v: jnp.asarray(v.reshape((B * L,) + v.shape[2:]))  # noqa
    bkw = ({} if "bloom_dx" not in x else
           dict(bloom_dx=flat(x["bloom_dx"]), bloom_lidx=flat(x["bloom_lidx"])))
    r8, g8, b8 = df.decode_fused_rows(
        flat(x["rows"][:, row0:row0 + L]), flat(x["shifts"]),
        flat(x["waveI"]), flat(x["waveQ"]), flat(x["bright"]),
        flat(x["contrast"]), ext_hi=flat(x["rows"][:, row0 + 1:row0 + L + 1]),
        outw=outw, av_len=av_len, max_shift=max_shift, coefs=coefs,
        interpret=True, **bkw)
    rgb = np.stack([np.asarray(v) for v in (r8, g8, b8)], axis=-1)
    return rgb.reshape(B, L, outw, 3)


@pytest.mark.parametrize("mode", ["conv", "bloom"])
def test_k2_mode_plain_matches_jax_kernel(mode):
    """One small case each: conv mode with the 6-tap FIR; bloom mode with
    the 3-band EQ, compared on every pixel (those past the drawn line
    included: the plain version keeps the TPU kernel's values there)."""
    row0, H, av_len, outw = 1, 96, 80, 24
    bloom = mode == "bloom"
    x = k2_inputs(5, B=1, L=12, H=H, av_len=av_len, outw=outw, bloom=bloom)
    coefs = (("conv", 6) if not bloom else
             tuple(tuple(c) for c in dem._eq_coefs(NTSC)))
    got = decode.decode_rows(**t(x), row0=row0, coefs=coefs, av_len=av_len,
                             outw=outw)
    same(got, k2_jax(x, row0, av_len, outw, coefs, max_shift=H - 1 + 12))


@pytest.mark.parametrize("taps", [4, 5, 6, 7])
def test_eq_convolution_matches_jax(taps):
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops import filters as jfilters
    s = np.random.default_rng(taps).integers(-2**20, 2**20, (3, 2, 40))
    same(filters.eq_convolution(torch.as_tensor(s, dtype=torch.int32), taps),
         jfilters.eq_convolution(jnp.asarray(s, jnp.int32), taps))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["conv4", "conv5", "conv6", "conv7",
                                  "bloom", "bloom-conv7"])
def test_k2_mode_kernel_matches_plain(cuda, mode):
    av_len, outw = NTSC.av_len, 640
    bloom = mode.startswith("bloom")
    x = k2_inputs(len(mode), B=2, L=NTSC.lines, H=NTSC.hres, av_len=av_len,
                  outw=outw, bloom=bloom, row0=3)
    coefs = (("conv", int(mode[-1])) if "conv" in mode else
             dem._eq_coefs(NTSC))
    kw = dict(row0=3, coefs=coefs, av_len=av_len, outw=outw)
    want = decode.decode_rows(**t(x), **kw)
    counter = ("BLOOM_LAUNCHES" if bloom else "CONV_LAUNCHES")
    n = getattr(decode, counter)
    same(decode.decode_rows(**t(x, cuda), **kw), want)
    assert getattr(decode, counter) == n + 1


@pytest.mark.gpu
def test_k2_bloom_kernel_defined_for_any_step(cuda):
    """Pixel steps that move the source back (negative, or wrapping p*dx)
    restart the kernel's EQ walk; it still equals the plain version."""
    x = k2_inputs(3, B=1, L=8, H=NTSC.hres, av_len=NTSC.av_len, outw=64,
                  bloom=True, row0=3)
    rng = np.random.default_rng(0)
    x["bloom_dx"] = rng.integers(-2**31, 2**31, (1, 8)).astype(np.int32)
    kw = dict(row0=3, coefs=dem._eq_coefs(NTSC), av_len=NTSC.av_len, outw=64)
    same(decode.decode_rows(**t(x, cuda), **kw), decode.decode_rows(**t(x), **kw))


# --- bloom_line_width ---------------------------------------------------------


def line_sums(seed, B, L):
    rng = np.random.default_rng(seed)
    AV = NTSC.av_len
    sums = rng.integers(-128 * AV, 128 * AV, (B, L)).astype(np.int32)
    noise = np.array([0, 24, 255, 7][:B], np.int32)
    return sums, ((128 + noise // 2) * AV).astype(np.int32)


def test_bloom_line_width_plain_matches_jax_chain():
    """The JAX decoder's prev_e chain (demodulate.py:880-887), scanned, from
    the same line sums."""
    import jax.numpy as jnp
    from jax import lax
    from ntsc_crt_tpu.ops.fixedpoint import cdiv as jcdiv
    sums, max_e = line_sums(0, 4, NTSC.lines)
    me = jnp.asarray(max_e)

    def bloom_step(prev_e, s_l):
        prev_e = jcdiv(prev_e * 123, 128) + jcdiv(((me >> 1) - s_l) << 10, me)
        return prev_e, prev_e

    _, want = lax.scan(bloom_step, jnp.full((4,), 16384 // 8, jnp.int32),
                       jnp.asarray(sums).T)
    same(decode.bloom_ema_plain(torch.as_tensor(sums),
                                torch.as_tensor(max_e)), np.asarray(want).T)


# where a line's [xpos, xpos + AV) window lies: inside its row, starting
# below 0, spilling into the next row, reaching past it (xpos + AV >= 2H),
# from any int32 (xpos + AV wraps)
XPOS_KINDS = ("inside", "below 0", "spill", "past 2H", "any")


def bloom_inputs(seed, B, L, H, AV, kind, row0=3, extra=0):
    """rows int8 (B, row0 + L + 1 + extra, H), xpos int32 (B, L) of one
    kind (or of every kind, "mixed"), max_e int32 (B,) with the edges 0, -1
    and 96256 (noise 0 at NTSC's AV)."""
    rng = np.random.default_rng(seed)
    ranges = {"inside": (0, H - AV + 1), "below 0": (-AV - 5, 0),
              "spill": (H - AV, H + 5), "past 2H": (2 * H - AV, 3 * H),
              "any": (-2**31, 2**31)}
    xs = [rng.integers(*ranges[k], (B, L)) for k in XPOS_KINDS]
    xpos = (xs[XPOS_KINDS.index(kind)] if kind != "mixed" else
            np.take_along_axis(np.stack(xs), rng.integers(0, 5, (1, B, L)),
                               0)[0])
    max_e = rng.integers(-2**31, 2**31, B)
    max_e[:3] = [0, -1, 96256][:B]
    return dict(
        rows=rng.integers(-128, 128, (B, row0 + L + 1 + extra, H),
                          dtype=np.int8),
        xpos_l=xpos.astype(np.int32), max_e=max_e.astype(np.int32))


@pytest.mark.parametrize("kind", XPOS_KINDS)
def test_bloom_line_width_plain_matches_jax(kind):
    """Sums and chain against the JAX decoder's expressions
    (demodulate.py:869-887) on the same rows: rolled = rows from row 3, a
    line's window in its row and its spill into the next."""
    import jax.numpy as jnp
    from jax import lax
    from ntsc_crt_tpu.ops.fixedpoint import cdiv as jcdiv
    AV, H, L, B = NTSC.av_len, NTSC.hres, 9, 4
    x = bloom_inputs(1, B, L, H, AV, kind)
    rolled = jnp.asarray(x["rows"])[:, 3:]
    me = jnp.asarray(x["max_e"])
    iota_h = jnp.arange(H, dtype=jnp.int32)
    xa = jnp.asarray(x["xpos_l"])[..., None]
    in_w = (iota_h >= xa) & (iota_h < xa + AV)
    in_spill = iota_h < (xa + AV - H)
    s_sum = (jnp.sum(jnp.where(in_w, rolled[:, :L].astype(jnp.int32), 0),
                     axis=2)
             + jnp.sum(jnp.where(in_spill, rolled[:, 1:].astype(jnp.int32),
                                 0), axis=2))

    def bloom_step(prev_e, s_l):
        prev_e = jcdiv(prev_e * 123, 128) + jcdiv(((me >> 1) - s_l) << 10, me)
        return prev_e, prev_e

    _, want = lax.scan(bloom_step, jnp.full((B,), 16384 // 8, jnp.int32),
                       s_sum.T)
    same(decode.bloom_line_width(**t(x), row0=3, av_len=AV),
         np.asarray(want).T, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 5, 64])
@pytest.mark.parametrize("shape", ["ntsc", "ragged"])
@pytest.mark.parametrize("kind", XPOS_KINDS + ("mixed",))
def test_bloom_line_width_kernel_matches_plain(cuda, kind, shape, B):
    """NTSC's rows (rolled4: L + 4 rows, row0 3), or small odd ones whose
    chunks straddle rows and the tensor's end and whose L is past the
    kernel's 256-line pass."""
    L, H, AV, row0, extra = ((NTSC.lines, NTSC.hres, NTSC.av_len, 3, 3)
                             if shape == "ntsc" else (300, 61, 50, 1, 0))
    x = bloom_inputs(B, B, L, H, AV, kind, row0, extra)
    want = decode.bloom_line_width(**t(x), row0=row0, av_len=AV)
    n = decode.LINE_WIDTH_LAUNCHES
    same(decode.bloom_line_width(**t(x, cuda), row0=row0, av_len=AV), want)
    assert decode.LINE_WIDTH_LAUNCHES == n + 1


# --- K6 place_rows_uniform ----------------------------------------------------


def k6_inputs(seed, B, L, w, ratio):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, L, w, 3)).astype(np.uint8),
            rng.integers(0, 256, (B, ratio * L, w, 3)).astype(np.uint8),
            (np.arange(B, dtype=np.int32) % 2) * (ratio // 2))


@pytest.mark.parametrize("ratio", [1, 2, 3])
@pytest.mark.parametrize("blend", [0, 1])
def test_k6_plain_matches_jax(ratio, blend):
    """Against the Pallas kernels (interpret) and the JAX stacked form, every
    scanline gap, slots mixing both fields (tests/test_pallas_kernels.py)."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.models import demodulate as jdem
    from ntsc_crt_tpu.models.systems import NTSC as JNTSC
    from ntsc_crt_tpu.ops.pallas import place_rows as pr
    L = 6
    fp = ratio // 2
    for scanlines in range(ratio):
        rgb, old, field_px = k6_inputs(ratio * 10 + scanlines, 4, L, 9, ratio)
        got = place.place_rows_uniform(
            torch.as_tensor(rgb), torch.as_tensor(old),
            torch.as_tensor(field_px), blend=bool(blend), scanlines=scanlines,
            ratio=ratio, fp=fp)
        args = (jnp.asarray(rgb), jnp.asarray(old), jnp.asarray(field_px))
        kw = dict(blend=blend, scanlines=scanlines, ratio=ratio, fp=fp,
                  interpret=True)
        tag = f"scanlines {scanlines}"
        same(got, jdem._place_rows_uniform(JNTSC, *args, blend, scanlines,
                                           ratio * L, ratio), tag)
        same(got, pr.place_rows_uniform(*args, **kw), tag)
        same(got, pr.place_rows_uniform_tiled(*args, tile_rows=2, **kw), tag)


def test_place_rows_takes_k6_under_the_uniform_gate(monkeypatch):
    """_place_rows hands the uniform case to K6 — bloom lines too, in K6's
    bloom mode — and every other case to the general gather — a tensor
    knob, v_fac making outh + v_fac a multiple of the lines without outh ==
    ratio * L, bloom outside the gate (with its `valid` plane) — and both
    agree."""
    L, w = NTSC.lines, 8
    calls = []
    real = place.place_rows_uniform
    monkeypatch.setattr(place, "place_rows_uniform",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    rgb, old, field_px = k6_inputs(1, 2, L, w, 2)
    rng = np.random.default_rng(2)
    drawn = dict(bloom_dx=torch.as_tensor(rng.integers(
                     0, 40000, (2, L)).astype(np.int32)),
                 bloom_scan=torch.as_tensor(rng.integers(
                     -50000, 50000, (2, L)).astype(np.int32)), av_len=60)
    lrel = np.arange(L, dtype=np.int32)[None]
    cases = [  # (outh, v_fac, blend, scanlines, bloom?, K6?)
        (480, 0, 1, 1, False, True), (480, 0, 0, 0, False, True),
        (480, 0, torch.tensor(1), 1, False, False),
        (480, 0, 1, torch.tensor(1), False, False),
        (470, 10, 1, 1, False, False),
        (480, 0, 1, 1, True, True), (480, 0, 0, 0, True, True),
        (480, 0, torch.tensor(1), 1, True, False),
        (480, 0, 1, torch.tensor(1), True, False),
        (470, 10, 1, 1, True, False)]
    for outh, v_fac, blend, scanlines, bloom, k6 in cases:
        o = torch.as_tensor(old[:, :outh])
        beg = lrel * (outh + v_fac) // L + field_px[:, None]
        end = (lrel + 1) * (outh + v_fac) // L + field_px[:, None]
        n = len(calls)
        got = dem._place_rows(torch.as_tensor(rgb), o, torch.as_tensor(beg),
                              torch.as_tensor(end),
                              torch.as_tensor(beg < outh), blend, scanlines,
                              outh, bloom=drawn if bloom else None,
                              field_px=torch.as_tensor(field_px), v_fac=v_fac)
        assert len(calls) == n + k6, (outh, v_fac, blend, scanlines, bloom)
        if k6:
            assert (calls[-1].get("bloom_dx") is not None) == bloom
        want = dem._place_rows(torch.as_tensor(rgb), o, torch.as_tensor(beg),
                               torch.as_tensor(end),
                               torch.as_tensor(beg < outh),
                               torch.as_tensor(blend),
                               torch.as_tensor(scanlines), outh,
                               bloom=drawn if bloom else None)
        same(got, want, f"outh {outh} v_fac {v_fac} bloom {bloom}")


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,w", [(1, 640), (2, 640), (3, 37)])
@pytest.mark.parametrize("blend", [0, 1])
def test_k6_kernel_matches_plain(cuda, ratio, w, blend):
    """w = 640 moves 16-byte chunks, w = 37 (111-byte rows) single bytes."""
    rgb, old, field_px = k6_inputs(ratio + w, 3, NTSC.lines, w, ratio)
    for scanlines in range(ratio):
        kw = dict(blend=bool(blend), scanlines=scanlines, ratio=ratio,
                  fp=ratio // 2)
        want = place.place_rows_uniform(*map(torch.as_tensor,
                                             (rgb, old, field_px)), **kw)
        n = place.LAUNCHES
        got = place.place_rows_uniform(
            *(torch.as_tensor(a, device=cuda) for a in (rgb, old, field_px)),
            **kw)
        same(got, want, f"scanlines {scanlines}")
        assert place.LAUNCHES == n + 1
