"""The port's NTSC frame step against the JAX package, on the CPU.

The committed golden tags `NTSC` and `NTSC_b16` replay through the port, and
live runs compare every state leaf with the JAX step after every frame.
Every value is an integer: every comparison is exact (0 LSB)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helpers import run_demodulate, run_modulate, run_step
from ntsc_crt_tpu.models import pipeline as jpipe
from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
from ntsc_crt_tpu.models.systems import NTSC
from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.utils import convert

torch.set_num_threads(1)  # the tier runs several workers on few cores

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "fixtures" / "device_parity_goldens.npz"


def leaves_equal(port_state, jax_leaves, tag=""):
    got = convert.state_to_numpy(port_state)
    for k, want in jax_leaves.items():
        want = np.asarray(want)
        assert got[k].shape == want.shape, (tag, k, got[k].shape, want.shape)
        assert np.array_equal(got[k], want), \
            f"{tag} {k}: {int((got[k] != want).sum())} elements differ"


def jax_leaves(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


# --- goldens (the recipe of bench.py:198-235, without its JAX code) --------


def test_golden_ntsc_batch1():
    """Two 320x240 frames at 128x96, noise 7, field/frame (0,0) then (1,1)."""
    ref = np.load(GOLDENS)
    img = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3),
                                           np.uint8)[0]
    st = pipeline.crt_init(NTSC, 128, 96, device="cpu")
    for f in (0, 1):
        st = pipeline.step(NTSC, st, torch.as_tensor(img), field=f, frame=f,
                           noise=7)
    leaves_equal(st, {k: ref[f"NTSC/{k}"] for k in pipeline.CRTState._fields},
                 "NTSC")


def test_golden_ntsc_batch16():
    """Sixteen 80x60 slots through step_batch; the second step toggles
    field/frame per slot."""
    ref = np.load(GOLDENS)
    B = 16
    imgs = torch.as_tensor(np.random.RandomState(0).randint(
        0, 256, (B, 60, 80, 3), np.uint8))
    st = pipeline.init_batch(NTSC, B, 128, 96, device="cpu")
    zeros = torch.zeros(B, dtype=torch.int32)
    alt = torch.arange(B, dtype=torch.int32) % 2
    st = pipeline.step_batch(NTSC, st, imgs, zeros, zeros, zeros, noise=7)
    st = pipeline.step_batch(NTSC, st, imgs, alt, alt, zeros, noise=7)
    leaves_equal(st, {k: ref[f"NTSC_b16/{k}"]
                      for k in pipeline.CRTState._fields}, "NTSC_b16")


# --- live equality with the JAX step ----------------------------------------

FRAMES = ((0, 0), (1, 1), (1, 0), (0, 1))   # (field, frame) per step


@pytest.mark.parametrize("seed,noise,hue,as_color", [
    (0, 0, 0, 1), (1, 12, 35, 1), (2, 12, -120, 0), (3, 0, 200, 1)])
def test_step_matches_jax(seed, noise, hue, as_color):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    jst = jpipe.crt_init(NTSC, 128, 96)
    st = pipeline.crt_init(NTSC, 128, 96, device="cpu")
    for field, frame in FRAMES:
        kw = dict(field=field, frame=frame, hue=hue, noise=noise,
                  as_color=as_color)
        jst = run_step(NTSC, jst, img, **kw)
        st = pipeline.step(NTSC, st, torch.as_tensor(img), **kw)
        leaves_equal(st, jax_leaves(jst), f"{kw}")


def test_modulate_and_demodulate_match_jax():
    """The two halves on their own: the encoder from one shared state, and
    the decoder from the JAX encoder's field."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    jst = run_step(NTSC, jpipe.crt_init(NTSC, 128, 96), img, field=0,
                   frame=0, hue=0, noise=12, as_color=1)
    st = convert.state_from_numpy(jax_leaves(jst), device="cpu")
    kw = dict(field=1, frame=0, hue=17)
    jmod = run_modulate(NTSC, jst, img, **kw)
    leaves_equal(pipeline.modulate(NTSC, st, torch.as_tensor(img), **kw),
                 jax_leaves(jmod), "modulate")
    jdem = run_demodulate(NTSC, jmod, noise=30)
    leaves_equal(pipeline.demodulate(
        NTSC, convert.state_from_numpy(jax_leaves(jmod), device="cpu"),
        noise=30),
        jax_leaves(jdem), "demodulate")


def test_step_with_blend_scanlines_tall_output():
    """outw=96, outh=480 with blend and a scanline gap; the second frame is
    an odd field, so the odd-field row shift and the blend against the first
    frame both run."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    knobs = dict(blend=1, scanlines=1, hue=10, saturation=12)
    jmon = JMon(**{k: np.int32(v) for k, v in knobs.items()})
    jstep = jax.jit(lambda s, im, f: jpipe.step(
        NTSC, s, im, field=f, frame=f, noise=5, mon=jmon))
    jst = jpipe.crt_init(NTSC, 96, 480)
    st = pipeline.crt_init(NTSC, 96, 480, device="cpu")
    for f in (0, 1):
        jst = jstep(jst, jnp.asarray(img), jnp.int32(f))
        st = pipeline.step(NTSC, st, torch.as_tensor(img), field=f, frame=f,
                           noise=5, mon=MonitorParams(**knobs))
        leaves_equal(st, jax_leaves(jst), f"field {f}")


@pytest.mark.parametrize("outh,blend,scanlines", [
    (480, 1, 1), (480, 0, 0), (720, 1, 2), (720, 0, 1), (240, 1, 0)])
def test_general_row_placement_matches_jax_uniform_branch(outh, blend,
                                                          scanlines):
    """The port's general gather placement (what _place_rows runs without
    field_px or with tensor knobs); JAX, given static knobs and outh a
    multiple of the line count, takes its uniform stacked branch
    (demodulate.py:1144-1256).  Slots mix even and odd fields."""
    from ntsc_crt_tpu.models import demodulate as jdem
    from ntsc_crt_tpu_torch.models import demodulate as dem
    rng = np.random.default_rng(outh + blend + scanlines)
    B, L, w = 4, NTSC.lines, 24
    ratio = outh // L
    field_px = np.array([0, 1, 1, 0], np.int32) * (ratio // 2)
    rgb = rng.integers(0, 256, (B, L, w, 3)).astype(np.uint8)
    old = rng.integers(0, 256, (B, outh, w, 3)).astype(np.uint8)
    lrel = np.arange(L, dtype=np.int32)[None]
    beg = lrel * outh // L + field_px[:, None]
    end = (lrel + 1) * outh // L + field_px[:, None]
    want = jdem._place_rows_uniform(NTSC, jnp.asarray(rgb), jnp.asarray(old),
                                    jnp.asarray(field_px), blend, scanlines,
                                    outh, ratio)
    t = torch.as_tensor
    got = dem._place_rows(t(rgb), t(old), t(beg), t(end), t(beg < outh),
                          blend, t(np.full(B, scanlines, np.int32)), outh)
    assert np.array_equal(got.numpy(), np.asarray(want))


# --- state conversion, imports, scope ---------------------------------------


def test_state_and_monitor_round_trips():
    rng = np.random.default_rng(2)
    jst = jpipe.crt_init(NTSC, 40, 30, batch=3)
    leaves = jax_leaves(jst)
    leaves["analog"] = rng.integers(-128, 128, leaves["analog"].shape
                                    ).astype(np.int8)
    leaves["rn"] = np.array([-5, 2**31 - 1, 194], np.int32)
    st = convert.state_from_numpy(leaves, device="cpu")
    assert [str(v.dtype) for v in st] == [
        "torch.int8", "torch.uint8"] + ["torch.int32"] * 5
    back = convert.state_to_numpy(st)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    resized = pipeline.crt_resize(NTSC, st, 64, 48)
    assert resized.out.shape == (3, 48, 64, 3) and not resized.out.any()
    assert resized.analog is st.analog
    knobs = dict(hue=3, brightness=-4, contrast=np.arange(3, dtype=np.int32),
                 saturation=10, black_point=0, white_point=90, blend=1,
                 scanlines=0)
    mon = convert.mon_from_numpy(knobs, device="cpu")
    assert torch.is_tensor(mon.contrast) and mon.hue == 3
    for k, v in convert.mon_to_numpy(mon).items():
        assert np.array_equal(v, knobs[k]), k


def test_port_imports_no_jax():
    """Neither JAX nor any module of the JAX package (`ntsc_crt_tpu` and
    `ntsc_crt_tpu.*`) is loaded by importing the port."""
    code = ("import sys, ntsc_crt_tpu_torch; "
            "from ntsc_crt_tpu_torch.utils import convert; "
            "from ntsc_crt_tpu_torch.ops.kernels import ccf, nes, noise, "
            "place, vhs, probe, rowfilters, scanconv; "
            "from ntsc_crt_tpu_torch import cli; "
            "from ntsc_crt_tpu_torch.apps import live, term_live, x11_live; "
            "from ntsc_crt_tpu_torch.models import video; "
            "from ntsc_crt_tpu_torch.parallel import mesh, spatial; "
            "from ntsc_crt_tpu_torch import demo; "
            "from ntsc_crt_tpu_torch.utils import checkpoint, formats, "
            "imageio, native_io, profiling, testcard; "
            "assert 'jax' not in sys.modules, sorted(sys.modules); "
            "jp = [m for m in sys.modules if m == 'ntsc_crt_tpu' "
            "or m.startswith('ntsc_crt_tpu.')]; "
            "assert not jp, jp; "
            "assert 'ntsc_crt_tpu_torch.ops.kernels.build' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_unported_presets_raise():
    """Every preset of the reference runs now; a system outside its encoder
    families or its 4- and 5-sample chroma raises instead of guessing."""
    import dataclasses
    from ntsc_crt_tpu_torch.models import systems
    odd = dataclasses.replace(systems.NTSC, name="ODD", cc_samples=5)
    st = pipeline.crt_init(odd, 64, 48, device="cpu")
    with pytest.raises(ValueError, match="NTSC-family"):
        pipeline.modulate(odd, st, torch.zeros((48, 64, 3),
                                               dtype=torch.uint8))
    six = dataclasses.replace(systems.NTSC, name="SIX", cc_samples=6)
    with pytest.raises(ValueError, match="4 or 5"):
        pipeline.demodulate(six, pipeline.crt_init(six, 64, 48,
                                                   device="cpu"))
