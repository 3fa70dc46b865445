"""The PV1K cell's benchmark pieces against the JAX package and the port, on
the CPU: the vper encoder's reference (``crt_bench/reference_vper``)
bit-exact to the JAX package's PV1K, SNES and TEMPLATE steps and to the
``PV1K`` / ``PV1K_b16`` goldens; the port's ``step_batch`` on PV1K
bit-exact to the reference over a sequence of per-slot parities; what the
reference and the cell's driver import; and the port's
``ntsc.modulate.skeleton`` / ``ntsc.modulate.store`` spans.  The test
marked `gpu` holds the cell's step on the card to the 5-sample kernels
and skips without one.

The JAX package is held slot by slot, each slot's step run alone: its
batched step picks every slot's vsync line from slot 0's candidates
(``test_torch_families.JAX_VSYNC_PICK_SLOTS``).  JAX is imported inside the
tests that use it, so the `gpu` test also runs on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \
        tests/test_torch_pv1k_bench.py -m gpu
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor
from crt_bench.reference_vper import pipeline as ref_vper
from ntsc_crt_tpu_torch.models import modulate, pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.ops import fastpath
from ntsc_crt_tpu_torch.ops.kernels import encode
from test_torch_spans import replay  # noqa: F401  (a fixture)

torch.set_num_threads(1)  # the tier runs several workers on few cores

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "fixtures" / "device_parity_goldens.npz"
PV1K, RCFG = systems.PV1K, ref_systems.SYSTEMS["PV1K"]
# the cell's monitor knobs
KNOBS = dict(blend=1, scanlines=1, saturation=10)


def parities(k, offsets):
    """(field, frame) int32 (B,) of step k, each slot on the video
    converter's sequence from its own offset."""
    fr = [ref.converter_parity((k + o) % 4) for o in offsets]
    return (torch.tensor([f for f, _ in fr], dtype=torch.int32),
            torch.tensor([r for _, r in fr], dtype=torch.int32))


def same(got, want, tag):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got, want), \
        f"{tag}: {int((got != want).sum())} elements differ"


@pytest.mark.parametrize("name", ["PV1K", "SNES", "TEMPLATE"])
def test_the_reference_equals_the_jax_step_slot_by_slot(name):
    """B 3 at 128x96, noise 24, the cell's knobs, three steps on per-slot
    parities and dot-crawl offsets; every slot held to the JAX step run on
    that slot alone, every state leaf after each step."""
    import jax.numpy as jnp
    from helpers import run_step
    from ntsc_crt_tpu.models import pipeline as jpipe
    from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
    from ntsc_crt_tpu.models.systems import SYSTEMS as JSYSTEMS

    B, outw, outh = 3, 128, 96
    rcfg, jcfg = ref_systems.SYSTEMS[name], JSYSTEMS[name]
    rng = np.random.default_rng(23 + len(name))
    jmon = JMon(**{k: np.int32(v) for k, v in KNOBS.items()})
    alone = [jpipe.crt_init(jcfg, outw, outh)._replace(
        rn=jnp.int32(194 + s), randstate=jnp.int32(1 + s)) for s in range(B)]
    rst = ref.init_slots(rcfg, range(B), outw, outh)
    for k in range(3):
        img = rng.integers(0, 256, (B, 48, 64, 3)).astype(np.uint8)
        field, frame = parities(k, [0, 3, 2])
        dco = torch.tensor([0, 1, 7], dtype=torch.int32) + k
        rst = ref_vper.step(rcfg, rst, torch.as_tensor(img), field=field,
                            frame=frame, dot_crawl_offset=dco, noise=24,
                            mon=RefMonitor(**KNOBS))
        for s in range(B):
            alone[s] = run_step(jcfg, alone[s], img[s], mon=jmon,
                                field=int(field[s]), frame=int(frame[s]),
                                dc=int(dco[s]), noise=24)
            for leaf, v in alone[s]._asdict().items():
                same(getattr(rst, leaf)[s].numpy(), np.asarray(v),
                     f"{name} step {k} slot {s} {leaf}")


@pytest.mark.parametrize("tag", ["PV1K", "PV1K_b16"])
def test_the_reference_replays_the_pv1k_goldens(tag):
    """PV1K: two 320x240 frames at 128x96, noise 7, field/frame (0, 0)
    then (1, 1).  PV1K_b16: sixteen 80x60 slots, the second step toggling
    field/frame by slot (test_torch_families' recipes)."""
    want = np.load(GOLDENS)
    if tag == "PV1K":
        img = torch.as_tensor(np.random.RandomState(0).randint(
            0, 256, (1, 240, 320, 3), np.uint8))
        st = ref.init_slots(RCFG, [0], 128, 96)
        for f in (0, 1):
            st = ref_vper.step(RCFG, st, img, field=f, frame=f, noise=7,
                               mon=RefMonitor())
        got = {k: v[0] for k, v in st._asdict().items()}
    else:
        B = 16
        img = torch.as_tensor(np.random.RandomState(0).randint(
            0, 256, (B, 60, 80, 3), np.uint8))
        st = ref.init_slots(RCFG, range(B), 128, 96)
        alt = torch.arange(B, dtype=torch.int32) % 2
        for f in (0, alt):
            st = ref_vper.step(RCFG, st, img, field=f, frame=f, noise=7,
                               mon=RefMonitor())
        got = st._asdict()
    for name, v in got.items():
        same(v.numpy(), want[f"{tag}/{name}"], f"{tag} {name}")


@pytest.mark.parametrize("outw,outh", [(160, 480), (128, 96)])
def test_the_port_pv1k_sequence_equals_the_reference(outw, outh):
    """The cell's knobs (noise 24, blend 1, scanlines 1), three steps of B
    3 on per-slot parities, the state carried: at 160x480 K6's stacked
    form, at 128x96 the general placement."""
    g = torch.Generator().manual_seed(23)
    imgs = torch.randint(0, 256, (3, 3, 60, 80, 3), generator=g,
                         dtype=torch.uint8)
    st = pipeline.init_batch(PV1K, 3, outw, outh, device="cpu")
    rst = ref.init_slots(RCFG, [0, 1, 2], outw, outh)
    dco = torch.zeros(3, dtype=torch.int32)
    for k in range(3):
        field, frame = parities(k, [0, 3, 2])
        st = pipeline.step_batch(PV1K, st, imgs[k], field, frame, dco,
                                 noise=24, mon=MonitorParams(**KNOBS))
        rst = ref_vper.step(RCFG, rst, imgs[k], field=field, frame=frame,
                            dot_crawl_offset=dco, noise=24,
                            mon=RefMonitor(**KNOBS))
        for name, a, b in zip(ref.CRTState._fields, st, rst):
            same(a.numpy(), b.numpy(), f"step {k} {name}")


def test_the_reference_takes_the_vper_encoders_only():
    ntsc = ref_systems.SYSTEMS["NTSC"]
    st = ref.init_slots(ntsc, [0], 64, 48)
    img = torch.zeros((1, 24, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="vertical phase class"):
        ref_vper.step(ntsc, st, img, field=0, frame=0, mon=RefMonitor())


def test_the_reference_and_the_driver_import_no_jax_nor_the_port():
    code = ("import crt_bench.reference_vper.pipeline, "
            "crt_bench.drivers.batch_closed_vper, crt_bench.control_vper\n"
            "import sys\n"
            "print(' '.join(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    tops = set(out.stdout.split())
    assert "torch" in tops
    assert not tops & {"ntsc_crt_tpu_torch", "ntsc_crt_tpu", "jax",
                       "jaxlib", "flax"}


def _marked(name, fn):
    def call(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return call


def _spans_of(event):
    """The ntsc. ranges around a profiler event, innermost first."""
    chain, p = [], event.cpu_parent
    while p is not None:
        if p.name.startswith("ntsc."):
            chain.append(p.name)
        p = p.cpu_parent
    return chain


@pytest.mark.usefixtures("replay")
@pytest.mark.parametrize("name", ["PV1K", "NESRGB"])
def test_the_skeleton_and_store_spans_hold_the_field_passes(name,
                                                            monkeypatch):
    """A step of a vper or NESRGB encoder records ntsc.modulate.skeleton
    and then ntsc.modulate.store inside ntsc.modulate.encode, once each:
    the skeleton holds the three field-wide `where`s (PV1K) or the
    skeleton's copy (NESRGB) and the burst's rows, the store holds
    store_active alone, and K1 runs inside neither.  An NTSC step records
    neither span.  The kernels replay their unprofiled results
    (`replay`)."""
    monkeypatch.setattr(modulate, "_burst_rows",
                        _marked("test.burst_rows", modulate._burst_rows))
    monkeypatch.setattr(fastpath, "store_active",
                        _marked("test.store_active", fastpath.store_active))
    monkeypatch.setattr(encode, "encode_rows",
                        _marked("test.encode_rows", encode.encode_rows))
    z = torch.zeros(1, dtype=torch.int32)
    img = torch.randint(0, 256, (1, 24, 32, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(23))
    new = ("ntsc.modulate.skeleton", "ntsc.modulate.store")
    for cfg in (systems.SYSTEMS[name], systems.NTSC):
        st = pipeline.init_batch(cfg, 1, 64, 48, device="cpu")
        pipeline.step_batch(cfg, st, img, z, z, z, noise=12)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipeline.step_batch(cfg, st, img, z, z, z, noise=12)
        events = prof.events()
        spans = sorted((e for e in events if e.name in new),
                       key=lambda e: e.time_range.start)
        if cfg is systems.NTSC:
            assert not spans
            continue
        assert [e.name for e in spans] == list(new)
        for e in spans:
            assert e.cpu_parent.name == "ntsc.modulate.encode"
        inner = {}
        for e in events:
            chain = _spans_of(e)
            if chain:
                inner.setdefault(chain[0], []).append(e.name)
        skel = inner["ntsc.modulate.skeleton"]
        assert "test.burst_rows" in skel
        if name == "PV1K":
            assert skel.count("aten::where") == 3
        else:
            assert "aten::clone" in skel
        store = [c for c in spans[1].cpu_children]
        assert [c.name for c in store] == ["test.store_active"]
        assert "aten::copy_" in [c.name for c in store[0].cpu_children]
        assert "test.encode_rows" in inner["ntsc.modulate.encode"]


@pytest.mark.gpu
def test_the_cells_step_runs_the_5_sample_kernels():
    """One B 2048 step of the PV1K cell (640x480, noise 24, blend 1,
    scanlines 1) under the profiler launches K1's block mode, K2's 3-band
    mode and K4 at CC 5 once each, no other instantiation of K1 or K2 (so
    the K1 and K2 rooflines read the 5-sample kernels alone), and no K1
    field mode; the skeleton and store spans are on the trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    from ntsc_crt_tpu_torch.ops.kernels import build
    dev = torch.device("cuda")
    B = 2048
    st = pipeline.init_batch(PV1K, B, 640, 480, device=dev)
    img = torch.randint(0, 256, (B, 480, 640, 3), dtype=torch.uint8,
                        device=dev)
    field = torch.arange(B, dtype=torch.int32, device=dev) % 2
    mon = MonitorParams(**KNOBS)
    build.LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = pipeline.step_batch(PV1K, st, img, field, field, field * 0,
                                 noise=24, mon=mon)
        torch.cuda.synchronize()
    for name in ("encode_rows", "decode_rows", "ccf_ema"):
        assert build.LAUNCHES[name] == 1, (name, dict(build.LAUNCHES))
    assert build.LAUNCHES["encode_rows_field"] == 0
    names = [e.name for e in prof.events()]
    kernels = [n for n in names if "_kernel" in n]
    for func in ("encode_rows_kernel", "decode_rows_kernel"):
        launched = [n for n in kernels if func in n]
        assert len(launched) == 1, (func, kernels)
        assert func + "<5," in launched[0] or func + "ILi5E" in launched[0]
    assert [n for n in kernels if "ccf_ema_kernel" in n
            and ("<5, 10, 5>" in n or "ILi5ELi10ELi5E" in n)]
    for span in ("ntsc.modulate.skeleton", "ntsc.modulate.store"):
        assert names.count(span) >= 1, span
