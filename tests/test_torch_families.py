"""The port's other encoder families against the JAX package, on the CPU:
SNES, TEMPLATE and PV1K (modulate_vper), NESRGB and NES, with the 5-sample
decode that PV1K drives.

K1's per-row carrier tables are held against the Pallas kernel in interpret
mode; live runs compare every state leaf with the JAX step after every frame,
at batch 1 and batch 2 with the state carried; the golden tags `PV1K`,
`PV1K_b16`, `NES`, `SNES` and `NESRGB` replay through the port.  Every value
is an integer: every comparison is exact (0 LSB)."""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from helpers import run_step
from ntsc_crt_tpu.models import pipeline as jpipe
from ntsc_crt_tpu.models import systems as jsystems
from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
from ntsc_crt_tpu.ops.pallas import encode_fused
from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.ops import filters
from ntsc_crt_tpu_torch.ops.kernels import encode
from ntsc_crt_tpu_torch.utils import convert

torch.set_num_threads(1)  # the tier runs several workers on few cores

GOLDENS = (Path(__file__).resolve().parent / "fixtures"
           / "device_parity_goldens.npz")


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


def frame_input(cfg, rng, lead=()):
    """uint16 PPU pixels (h, w) for NES, else uint8 RGB (h, w, 3)."""
    if cfg.kind == "nes":
        return rng.integers(0, 512, lead + (60, 64)).astype(np.uint16)
    return rng.integers(0, 256, lead + (48, 64, 3)).astype(np.uint8)


# --- K1 with a carrier table a row -------------------------------------------------


@pytest.mark.parametrize("cc", [4, 5])
def test_k1_per_row_tables_match_jax_kernel(cc):
    rng = np.random.default_rng(cc)
    B, h, w, desth, destw = 2, 7, 20, 6, 45
    img = rng.integers(0, 256, (B, h, w, 3)).astype(np.uint8)
    sy = np.sort(rng.integers(0, h, (B, desth)), axis=1).astype(np.int32)
    modI, modQ = (rng.integers(-32, 33, (B, desth, cc)).astype(np.int32)
                  for _ in range(2))
    gain = rng.integers(50, 150, B).astype(np.int32)
    base = rng.integers(-20, 30, B).astype(np.int32)
    cfg = systems.PV1K if cc == 5 else systems.TEMPLATE
    coefs = tuple(filters.init_iir(cfg.l_freq, f)
                  for f in (cfg.y_freq, cfg.i_freq, cfg.q_freq))
    t = torch.as_tensor
    got = encode.encode_rows(t(img), t(sy), t(modI), t(modQ), t(gain),
                             t(base), coefs=coefs, xo_mod=3 % cc, destw=destw)
    rows = img[np.arange(B)[:, None], sy][:, :, (np.arange(destw) * w)
                                           // destw]
    per_row = lambda v: jnp.asarray(np.repeat(v, desth, axis=0))  # noqa: E731
    want = encode_fused.encode_fused_rows(
        *(jnp.asarray(rows[..., c].reshape(B * desth, destw))
          for c in range(3)),
        jnp.asarray(modI.reshape(B * desth, cc)),
        jnp.asarray(modQ.reshape(B * desth, cc)), per_row(gain),
        per_row(base), coefs=coefs, xo_mod=3 % cc, rgb=True, interpret=True)
    eq(got, np.asarray(want).reshape(B, desth, destw))


# --- live equality with the JAX step ------------------------------------------------

KNOBS = dict(hue=25, saturation=12, brightness=3, contrast=170)


# Slots of the batch-2 runs below where the batched JAX step holds the JAX
# package's cross-slot vsync pick (ntsc_crt_tpu/models/demodulate.py:295:
# with B > 1 every slot's vsync line comes from slot 0's candidates; ROADMAP
# Queue 3).  In this recipe PV1K's slot 1 picks line 257 on frame 1 where
# the JAX step on the slot alone, and the port, pick 258.  Every slot is held
# to the JAX step run on that slot alone; the others also to the batched one.
JAX_VSYNC_PICK_SLOTS = {"PV1K": [1]}


@pytest.mark.parametrize("name,B,kw", [
    ("SNES", 1, {}), ("SNES", 2, {}),
    ("TEMPLATE", 1, {}), ("TEMPLATE", 2, {}),
    ("PV1K", 1, {}), ("PV1K", 2, {}),
    ("NESRGB", 1, {}), ("NESRGB", 2, {}),
    ("NES", 1, {}), ("NES", 2, {}),
    ("NES", 1, dict(draw_border=True, border_color=0x21)),
    ("NES", 2, dict(draw_border=True, optimized=False,
                    border_color=np.array([0x16, 0x1F0], np.int32)))])
def test_step_matches_jax(name, B, kw):
    """Three frames, state carried; batch 2 gives each slot its own field,
    frame, dot-crawl offset, hue and border colour (step_batch's dcos)."""
    cfg, jcfg = systems.SYSTEMS[name], jsystems.SYSTEMS[name]
    rng = np.random.default_rng(len(name) + B)
    img = frame_input(cfg, rng, () if B == 1 else (B,))
    jmon = JMon(**{k: np.int32(v) for k, v in KNOBS.items()})
    mon = MonitorParams(**KNOBS)
    slot = np.arange(B, dtype=np.int32)
    # one JAX state a slot (unbatched), plus the batched one at batch 2
    alone = [jpipe.crt_init(jcfg, 96, 72) for _ in range(B)]
    jst = jpipe.crt_init(jcfg, 96, 72, batch=B) if B > 1 else None
    st = convert.state_from_numpy(
        jax_leaves(jst if B > 1 else alone[0]), device="cpu")
    differ = set()
    for i in range(3):
        f = dict(field=(slot + i) % 2, frame=((slot + i) >> 1) % 2,
                 dc=slot * 2 + i, hue=7 * i - 40 * slot, noise=12 + i,
                 **kw)
        per_slot = lambda s: {k: (v[s] if isinstance(v, np.ndarray)  # noqa
                                  else v) for k, v in f.items()}
        for s in range(B):
            alone[s] = run_step(jcfg, alone[s], img if B == 1 else img[s],
                                mon=jmon, **per_slot(s))
        if B == 1:
            pkw = per_slot(0)
            pkw["dot_crawl_offset"] = pkw.pop("dc")
            st = pipeline.step(cfg, st, torch.as_tensor(img), mon=mon, **pkw)
            leaves_equal(st, jax_leaves(alone[0]), f"{name} {kw} frame {i}")
            continue
        jst = run_step(jcfg, jst, img, mon=jmon, **dict(f))
        t = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
             for k, v in f.items()}
        st = pipeline.step_batch(cfg, st, torch.as_tensor(img),
                                 t.pop("field"), t.pop("frame"), t.pop("dc"),
                                 mon=mon, **t)
        got = convert.state_to_numpy(st)
        for k, v in jax_leaves(jst).items():
            differ |= {int(s) for s in np.nonzero(got[k] != v)[0]}
        for s in range(B):
            leaves_equal(pipeline.CRTState(*(x[s] for x in st)),
                         jax_leaves(alone[s]), f"{name} {kw} slot {s} "
                         f"alone, frame {i}")
    if B > 1:
        assert sorted(differ) == JAX_VSYNC_PICK_SLOTS.get(name, [])


@pytest.mark.parametrize("name", ["SNES", "TEMPLATE", "PV1K"])
def test_state_round_trips(name):
    """The (cc_vper, cc_samples) = (3, 4), (2, 4) and (5, 5) states go to
    the port and back unchanged."""
    cfg = systems.SYSTEMS[name]
    leaves = jax_leaves(jpipe.crt_init(jsystems.SYSTEMS[name], 40, 30,
                                       batch=3))
    leaves["ccf"] = np.random.default_rng(1).integers(
        -2**31, 2**31, leaves["ccf"].shape).astype(np.int32)
    st = convert.state_from_numpy(leaves, device="cpu")
    assert tuple(st.ccf.shape) == (3, cfg.cc_vper, cfg.cc_samples)
    for k, v in convert.state_to_numpy(st).items():
        eq(v, leaves[k], k)


def test_conv_eq_needs_four_sample_chroma():
    st = pipeline.crt_init(systems.PV1K, 32, 24, device="cpu")
    with pytest.raises(ValueError, match="4-sample"):
        pipeline.demodulate(systems.PV1K, st, eq_mode="conv7")


# --- goldens (the recipe of bench.py:198-235, without its JAX code) --------


@pytest.mark.parametrize("tag", ["PV1K", "NES", "SNES", "NESRGB"])
def test_golden_batch1(tag):
    """Two frames at 128x96, noise 7, field/frame (0,0) then (1,1): RGB
    320x240 images, NES 256x240 PPU pixels."""
    ref = np.load(GOLDENS)
    cfg = systems.SYSTEMS[tag]
    rng = np.random.RandomState(0)
    img = (rng.randint(0, 512, (1, 240, 256), np.uint16) if cfg.kind == "nes"
           else rng.randint(0, 256, (1, 240, 320, 3), np.uint8))[0]
    st = pipeline.crt_init(cfg, 128, 96, device="cpu")
    for f in (0, 1):
        st = pipeline.step(cfg, st, torch.as_tensor(img), field=f, frame=f,
                           noise=7)
    leaves_equal(st, {k: ref[f"{tag}/{k}"]
                      for k in pipeline.CRTState._fields}, tag)


def test_golden_pv1k_batch16():
    """Sixteen 80x60 slots through step_batch; the second step toggles
    field/frame per slot.  Every slot equals the golden: the JAX package's
    cross-slot vsync pick (ROADMAP Queue 3) changes no slot here."""
    ref = np.load(GOLDENS)
    B, cfg = 16, systems.PV1K
    imgs = torch.as_tensor(np.random.RandomState(0).randint(
        0, 256, (B, 60, 80, 3), np.uint8))
    st = pipeline.init_batch(cfg, B, 128, 96, device="cpu")
    zeros = torch.zeros(B, dtype=torch.int32)
    alt = torch.arange(B, dtype=torch.int32) % 2
    st = pipeline.step_batch(cfg, st, imgs, zeros, zeros, zeros, noise=7)
    st = pipeline.step_batch(cfg, st, imgs, alt, alt, zeros, noise=7)
    leaves_equal(st, {k: ref[f"PV1K_b16/{k}"]
                      for k in pipeline.CRTState._fields}, "PV1K_b16")
