"""The port's VHS path (NTSCVHS presets) against the JAX package, on the CPU.

The crt_rand helpers, the tracking noise, the VHS encoder and the decoder
are held against their JAX functions one by one; the committed golden tags
`NTSCVHS` and `NTSCVHS_b16` replay through the port; live runs compare every
state leaf with the JAX step after every frame for the three tape speeds.
Also here: the port's own copy of the presets and its default device.
Every value is an integer: every comparison is exact (0 LSB)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helpers import run_demodulate, run_modulate, run_step
from ntsc_crt_tpu.models import demodulate as jdem
from ntsc_crt_tpu.models import modulate as jmod
from ntsc_crt_tpu.models import pipeline as jpipe
from ntsc_crt_tpu.models import systems as jsystems
from ntsc_crt_tpu.ops import lcg as jlcg
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import modulate as mod
from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.ops import lcg
from ntsc_crt_tpu_torch.utils import convert

torch.set_num_threads(1)  # the tier runs several workers on few cores

GOLDENS = (Path(__file__).resolve().parent / "fixtures"
           / "device_parity_goldens.npz")
VHS = systems.NTSCVHS
JVHS = jsystems.NTSCVHS
# int32 randstates over the whole range, negative ones included
RANDSTATES = np.array([1, -5, 2**31 - 1, -(2**31)], np.int32)


def eq(got, want, tag=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got, want), \
        f"{tag}: {int((got != want).sum())} elements differ"


def leaves_equal(port_state, want: dict, tag=""):
    got = convert.state_to_numpy(port_state)
    for k, w in want.items():
        eq(got[k], w, f"{tag} {k}")


def jax_leaves(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


# --- the port's presets and its default device --------------------------------


def test_systems_copy_equals_jax_package():
    assert list(systems.SYSTEMS) == list(jsystems.SYSTEMS)
    for name, cfg in systems.SYSTEMS.items():
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(jsystems.SYSTEMS[name]), name
        assert hash(cfg) == hash(cfg) and cfg == dataclasses.replace(cfg)
    assert systems.SYSTEM_IDS == jsystems.SYSTEM_IDS
    assert (systems.VHS_SP, systems.VHS_LP, systems.VHS_EP) == \
        (jsystems.VHS_SP, jsystems.VHS_LP, jsystems.VHS_EP)
    assert (systems.CHROMA_VERTICAL, systems.CHROMA_CHECKERED,
            systems.CHROMA_SAWTOOTH) == (jsystems.CHROMA_VERTICAL,
                                         jsystems.CHROMA_CHECKERED,
                                         jsystems.CHROMA_SAWTOOTH)


def test_entry_points_default_to_the_card():
    """Without a device the entry points put state on the CUDA card, and
    raise where there is none: they never fall back to the CPU."""
    leaves = convert.state_to_numpy(
        pipeline.crt_init(VHS, 32, 24, batch=2, device="cpu"))
    calls = [lambda: pipeline.crt_init(VHS, 32, 24),
             lambda: pipeline.init_batch(VHS, 2, 32, 24),
             lambda: convert.state_from_numpy(leaves),
             lambda: convert.mon_from_numpy({"hue": np.arange(2)})]
    if torch.cuda.is_available():
        for call in calls[:3]:
            assert call().analog.device.type == "cuda"
        assert calls[3]().hue.device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_vhs_state_round_trips():
    """A VHS state carries no leaf beyond the NTSC one: randstate is
    already a leaf, and it survives the trip to numpy and back."""
    jst = jpipe.crt_init(JVHS, 40, 30, batch=4)
    leaves = jax_leaves(jst)
    leaves["randstate"] = RANDSTATES
    st = convert.state_from_numpy(leaves, device="cpu")
    assert set(st._fields) == set(leaves)
    back = convert.state_to_numpy(st)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


# --- crt_rand and the noise --------------------------------------------------


def test_crt_rand_helpers_match_jax():
    rs = torch.as_tensor(RANDSTATES)
    eq(lcg.crt_rand_step(rs), jlcg.crt_rand_step(jnp.asarray(RANDSTATES)))
    u = jnp.asarray(RANDSTATES.view(np.uint32))
    eq(lcg.crt_rand_out(rs), jlcg.crt_rand_out(u))
    for s in RANDSTATES:
        vals, last = lcg.crt_rand_stream(torch.tensor(s), 1000)
        jvals, jlast = jlcg.crt_rand_stream(jnp.int32(s), 1000)
        eq(vals, jvals)
        eq(last, jlast)


@pytest.mark.parametrize("noise", [0, 7, 40])
def test_inject_noise_vhs_matches_jax(noise):
    rng = np.random.default_rng(noise)
    B = len(RANDSTATES)
    analog = rng.integers(-128, 128, (B, VHS.input_size)).astype(np.int8)
    nz = np.full(B, noise, np.int32)
    got = dem._inject_noise_vhs(VHS, torch.as_tensor(analog),
                                torch.as_tensor(RANDSTATES),
                                torch.as_tensor(nz))
    want = jax.jit(lambda a, r, n: jdem._inject_noise_vhs(JVHS, a, r, n))(
        jnp.asarray(analog), jnp.asarray(RANDSTATES), jnp.asarray(nz))
    for tag, g, w in zip(("inp", "randstate", "rn"), got, want):
        eq(g, w, tag)


@pytest.mark.parametrize("do_aberration", [0, 1, "per-slot"])
def test_modulate_vhs_matches_jax(do_aberration):
    """From a random field buffer, so the head-switch kill shows against
    non-blank samples; per-slot draws mix both branches in one batch."""
    rng = np.random.default_rng(3)
    B = len(RANDSTATES)
    analog = rng.integers(-128, 128, (B, VHS.vres, VHS.hres)).astype(np.int8)
    img = rng.integers(0, 256, (B, 48, 64, 3)).astype(np.uint8)
    ab = (np.array([1, 0, 1, 1], np.int32) if do_aberration == "per-slot"
          else do_aberration)
    kw = dict(field=np.array([0, 1, 1, 0], np.int32),
              frame=np.array([0, 0, 1, 1], np.int32), hue=5)
    got = mod.modulate_vhs(
        VHS, torch.as_tensor(analog), torch.as_tensor(img),
        torch.as_tensor(RANDSTATES), do_aberration=torch.as_tensor(ab),
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = jax.jit(lambda a, im, r, d, f, fr: jmod.modulate_vhs(
        JVHS, a, im, r, field=f, frame=fr, hue=5, do_aberration=d))(
        jnp.asarray(analog), jnp.asarray(img), jnp.asarray(RANDSTATES),
        jnp.asarray(ab), jnp.asarray(kw["field"]), jnp.asarray(kw["frame"]))
    for tag, g, w in zip(("analog", "ccf", "randstate"), got, want):
        eq(g, w, tag)


def test_modulate_vhs_bloom_is_not_ported():
    with pytest.raises(NotImplementedError, match="M8"):
        mod.modulate_vhs(VHS, torch.zeros((1, VHS.vres, VHS.hres),
                                          dtype=torch.int8),
                         torch.zeros((1, 24, 32, 3), dtype=torch.uint8),
                         torch.ones(1, dtype=torch.int32), field=0, frame=0,
                         hue=0, do_bloom=True)


@pytest.mark.parametrize("noise,randstate", [(0, -5), (7, 2**31 - 1),
                                             (40, -(2**31))])
def test_modulate_then_demodulate_match_jax(noise, randstate):
    """The two halves on their own through the pipeline: the encoder from
    one shared state, the decoder from the JAX encoder's field."""
    rng = np.random.default_rng(noise)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    jst = run_step(JVHS, jpipe.crt_init(JVHS, 128, 96, rand_seed=randstate),
                   img, field=0, frame=0, noise=12, do_aberration=1)
    kw = dict(field=1, frame=0, hue=17, do_aberration=1)
    jm = run_modulate(JVHS, jst, img, **kw)
    st = convert.state_from_numpy(jax_leaves(jst), device="cpu")
    leaves_equal(pipeline.modulate(VHS, st, torch.as_tensor(img), **kw),
                 jax_leaves(jm), "modulate")
    jd = run_demodulate(JVHS, jm, noise=noise)
    leaves_equal(pipeline.demodulate(
        VHS, convert.state_from_numpy(jax_leaves(jm), device="cpu"),
        noise=noise), jax_leaves(jd), "demodulate")


# --- goldens (the recipe of bench.py:198-235, without its JAX code) --------


def test_golden_ntscvhs_batch1():
    """Two 320x240 frames at 128x96, noise 7, field/frame (0,0) then (1,1)."""
    ref = np.load(GOLDENS)
    img = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3),
                                           np.uint8)[0]
    st = pipeline.crt_init(VHS, 128, 96, device="cpu")
    for f in (0, 1):
        st = pipeline.step(VHS, st, torch.as_tensor(img), field=f, frame=f,
                           noise=7)
    leaves_equal(st, {k: ref[f"NTSCVHS/{k}"]
                      for k in pipeline.CRTState._fields}, "NTSCVHS")


# Slots of the NTSCVHS_b16 golden that hold the JAX package's cross-slot
# vsync pick: with B > 1, demodulate.py:295 (onehot_pick of the (B, 2W)
# candidate lines by a (B, 1) index) broadcasts to (B, B), so column 0 takes
# every slot's line from slot 0's candidates.  It changes the result only
# where a slot's candidates differ from slot 0's at the picked row: in this
# recipe slot 5 of the second step (vsync 10 batched, 4 run alone).
JAX_VSYNC_PICK_SLOTS = [5]


def test_golden_ntscvhs_batch16():
    """Sixteen 80x60 slots through step_batch; the second step toggles
    field/frame per slot.  Every slot but JAX_VSYNC_PICK_SLOTS equals the
    golden; those equal the JAX step run on the slot alone."""
    ref = np.load(GOLDENS)
    B = 16
    imgs = np.random.RandomState(0).randint(0, 256, (B, 60, 80, 3), np.uint8)
    st = pipeline.init_batch(VHS, B, 128, 96, device="cpu")
    zeros = torch.zeros(B, dtype=torch.int32)
    alt = torch.arange(B, dtype=torch.int32) % 2
    st = pipeline.step_batch(VHS, st, torch.as_tensor(imgs), zeros, zeros,
                             zeros, noise=7)
    st = pipeline.step_batch(VHS, st, torch.as_tensor(imgs), alt, alt, zeros,
                             noise=7)
    got = convert.state_to_numpy(st)
    want = {k: ref[f"NTSCVHS_b16/{k}"] for k in pipeline.CRTState._fields}
    differ = sorted({int(s) for k in want
                     for s in np.nonzero(got[k] != want[k])[0]})
    assert differ == JAX_VSYNC_PICK_SLOTS
    keep = [s for s in range(B) if s not in differ]
    for k in want:
        eq(got[k][keep], want[k][keep], f"NTSCVHS_b16 {k}")
    for s in differ:
        jst = jpipe.crt_init(JVHS, 128, 96, rand_seed=1 + s, batch=1)
        jst = jst._replace(rn=jnp.full((1,), 194 + s, jnp.int32))
        for f in (0, s % 2):
            jst = run_step(JVHS, jst, imgs[s:s + 1], field=f, frame=f,
                           noise=7)
        for k, v in jax_leaves(jst).items():
            eq(got[k][s:s + 1], v, f"slot {s} alone {k}")


# --- live equality with the JAX step ----------------------------------------

FRAMES = ((0, 0), (1, 1), (1, 0), (0, 1))   # (field, frame) per step


@pytest.mark.parametrize("name,noise,aberration", [
    ("NTSCVHS", 12, (0, 1, 1, 0)), ("NTSCVHS_LP", 40, (1, 1, 1, 1)),
    ("NTSCVHS_EP", 0, (0, 0, 0, 0))])
def test_step_matches_jax(name, noise, aberration):
    cfg, jcfg = systems.SYSTEMS[name], jsystems.SYSTEMS[name]
    rng = np.random.default_rng(len(name))
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    jst = jpipe.crt_init(jcfg, 128, 96, rand_seed=-12345)
    st = pipeline.crt_init(cfg, 128, 96, rand_seed=-12345, device="cpu")
    for (field, frame), ab in zip(FRAMES, aberration):
        kw = dict(field=field, frame=frame, hue=9, noise=noise,
                  do_aberration=ab)
        jst = run_step(jcfg, jst, img, **kw)
        st = pipeline.step(cfg, st, torch.as_tensor(img), **kw)
        leaves_equal(st, jax_leaves(jst), f"{name} {kw}")
