"""The NES cell's benchmark pieces against the JAX package and the port, on
the CPU: ``crt_bench/reference``'s NES step bit-exact to the JAX package's
slot by slot; the port's ``step_batch`` on NES bit-exact to the reference
over the cell driver's knob sequence, at an output size off K6's gate and
at one K6 takes; ``demodulate.PLACEMENTS`` counting each row placement by
its path; what the cell's driver and work counts import.  The test marked
`gpu` runs the cell's step at B 2048 through the CUDA graphs and skips
without a card.

JAX is imported inside the test that uses it, so the `gpu` test also runs
on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \
        tests/test_torch_nes_bench.py -m gpu
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crt_bench.drivers import batch_closed_nes as driver
from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams

torch.set_num_threads(1)  # the tier runs several workers on few cores

ROOT = Path(__file__).resolve().parents[1]
NES, RCFG = systems.NES, ref_systems.SYSTEMS["NES"]
# the cell's monitor knobs and noise (crt_bench/configs/nes_ppu_832x624.json)
KNOBS = dict(blend=0, scanlines=0, saturation=10, contrast=180)
NOISE = 0
OFFSETS = [0, 3, 5]       # each slot's start in the live loop's sequence


def ppu_frames(seed, steps, B):
    """uint16 PPU pixels (steps, B, 60, 64), 9 bits each."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 512, (steps, B, 60, 64))
                           .astype(np.uint16))


def same(got, want, tag):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got, want), \
        f"{tag}: {int((got != want).sum())} elements differ"


def test_the_reference_equals_the_jax_step_slot_by_slot():
    """B 3 at 64x312 (off K6's gate), the cell's knobs, three steps of the
    driver's per-slot knob sequence; every slot held to the JAX step run on
    that slot alone, every state leaf after each step."""
    import jax.numpy as jnp
    from helpers import run_step
    from ntsc_crt_tpu.models import pipeline as jpipe
    from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
    from ntsc_crt_tpu.models.systems import SYSTEMS as JSYSTEMS

    B, outw, outh = 3, 64, 312
    jcfg = JSYSTEMS["NES"]
    jmon = JMon(**{k: np.int32(v) for k, v in KNOBS.items()})
    alone = [jpipe.crt_init(jcfg, outw, outh)._replace(
        rn=jnp.int32(194 + s), randstate=jnp.int32(1 + s)) for s in range(B)]
    rst = ref.init_slots(RCFG, range(B), outw, outh)
    imgs = ppu_frames(25, 3, B)
    for k in range(3):
        field, frame, dco = torch.as_tensor(driver.knobs(RCFG, k, OFFSETS))
        rst = ref.step(RCFG, rst, imgs[k], field=field, frame=frame,
                       dot_crawl_offset=dco, noise=NOISE,
                       mon=RefMonitor(**KNOBS))
        for s in range(B):
            alone[s] = run_step(jcfg, alone[s], imgs[k][s].numpy(), mon=jmon,
                                field=int(field[s]), frame=int(frame[s]),
                                dc=int(dco[s]), noise=NOISE)
            for leaf, v in alone[s]._asdict().items():
                same(getattr(rst, leaf)[s].numpy(), np.asarray(v),
                     f"step {k} slot {s} {leaf}")


@pytest.mark.parametrize("outw,outh,path", [(64, 312, "general"),
                                            (64, 480, "uniform")])
def test_the_port_nes_sequence_equals_the_reference(outw, outh, path):
    """The cell's knobs, six steps of B 3 on the driver's knob sequence (a
    whole period: both frame parities and the three dot-crawl phases in
    every slot), the state carried: every state field after each step.  At
    64x312 the rows are placed by the general path, at 64x480 by K6's; the
    counter says so, once a step."""
    imgs = ppu_frames(26, 6, 3)
    st = pipeline.init_batch(NES, 3, outw, outh, device="cpu")
    rst = ref.init_slots(RCFG, [0, 1, 2], outw, outh)
    before = dict(dem.PLACEMENTS)
    for k in range(driver.PERIOD):
        field, frame, dco = torch.as_tensor(driver.knobs(RCFG, k, OFFSETS))
        st = pipeline.step_batch(NES, st, imgs[k], field, frame, dco,
                                 noise=NOISE, mon=MonitorParams(**KNOBS))
        rst = ref.step(RCFG, rst, imgs[k], field=field, frame=frame,
                       dot_crawl_offset=dco, noise=NOISE,
                       mon=RefMonitor(**KNOBS))
        for name, a, b in zip(ref.CRTState._fields, st, rst):
            same(a.numpy(), b.numpy(), f"step {k} {name}")
    counted = {k: v - before.get(k, 0) for k, v in dem.PLACEMENTS.items()}
    assert {k: v for k, v in counted.items() if v} == {path: driver.PERIOD}


def test_the_driver_sequence_holds_every_phase_each_step():
    """Six slots at offsets 0..5: every step holds both frame parities and
    the three dot-crawl offsets, field 0 (NES is progressive), and slot s
    at step n is the live loop's frame n + s."""
    for n in range(2 * driver.PERIOD):
        field, frame, dco = driver.knobs(RCFG, n, range(driver.PERIOD))
        assert set(field) == {0} and set(frame) == {0, 1}
        assert set(dco) == {0, 1, 2}
        for s in range(driver.PERIOD):
            assert (field[s], frame[s], dco[s]) == ref.live_knobs(RCFG,
                                                                  n + s)


@pytest.mark.parametrize("name,outh,kw,path", [
    ("NES", 312, {}, "general"), ("NES", 480, {}, "uniform"),
    ("NTSC", 480, dict(do_bloom=True), "uniform_bloom"),
    ("NTSC", 480, dict(v_fac=1), "general")])
def test_placements_count_the_path_of_each_step(name, outh, kw, path):
    """One B 1 step: K6 where every line covers the same rows, its bloom
    mode with bloom, the general path off the gate (624 rows of 240 lines,
    a v_fac)."""
    cfg = systems.SYSTEMS[name]
    z = torch.zeros(1, dtype=torch.int32)
    img = (ppu_frames(27, 1, 1)[0] if cfg.kind == "nes" else
           torch.zeros((1, 24, 32, 3), dtype=torch.uint8))
    st = pipeline.init_batch(cfg, 1, 32, outh, device="cpu")
    dem.PLACEMENTS.clear()
    pipeline.step_batch(cfg, st, img, z, z, z, noise=NOISE, **kw)
    assert dict(dem.PLACEMENTS) == {path: 1}


def test_the_driver_and_work_counts_import_no_jax_nor_the_port():
    code = ("import crt_bench.drivers.batch_closed_nes, "
            "crt_bench.work_nes, crt_bench.readers_nes\n"
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


@pytest.mark.gpu
def test_the_cells_step_replays_one_k13_and_one_general_placement():
    """Five B 2048 steps of the cell at 832x624 (the output past 2^31
    elements) through the CUDA graphs: a first eager step, a capture,
    three replays; each launches K13 once and places its rows by the
    general path once, K6's general mode (counted in the eager call,
    replays included), with no uniform K6; the last replay equals the step
    run op by op from the same state, every state field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    from ntsc_crt_tpu_torch.models import graphs
    from ntsc_crt_tpu_torch.ops.kernels import build
    dev = torch.device("cuda")
    B, outw, outh = 2048, 832, 624
    st = pipeline.init_batch(NES, B, outw, outh, device=dev)
    assert st.out.numel() > 2**31
    g = torch.Generator(device=dev).manual_seed(25)
    img = torch.randint(0, 512, (B, 240, 256), generator=g, device=dev,
                        dtype=torch.int16).view(torch.uint16)
    offsets = np.arange(B) % driver.PERIOD
    table = torch.as_tensor(np.stack([driver.knobs(RCFG, p, offsets)
                                      for p in range(driver.PERIOD)]),
                            device=dev)
    mon = MonitorParams(**KNOBS)
    graphs.reset()
    build.LAUNCHES.clear()
    dem.PLACEMENTS.clear()
    steps = 5
    for n in range(steps - 1):
        st = pipeline.step_batch(NES, st, img, *table[n], noise=NOISE,
                                 mon=mon)
    assert (graphs.GRAPHS["eager_first"], graphs.GRAPHS["captures"],
            graphs.GRAPHS["replays"]) == (1, 1, 2), dict(graphs.GRAPHS)
    assert build.LAUNCHES["nes_square"] == steps - 1
    assert dict(dem.PLACEMENTS) == {"general": steps - 1}
    assert build.LAUNCHES["place_rows_general"] == steps - 1
    assert build.LAUNCHES["place_rows_uniform"] == 0
    want = pipeline.step.__wrapped__(
        NES, st, img, field=table[steps - 1][0], frame=table[steps - 1][1],
        dot_crawl_offset=table[steps - 1][2], noise=NOISE, mon=mon)
    build.LAUNCHES.clear()
    dem.PLACEMENTS.clear()
    got = pipeline.step_batch(NES, st, img, *table[steps - 1], noise=NOISE,
                              mon=mon)
    torch.cuda.synchronize()
    assert graphs.GRAPHS["replays"] == 3 and not graphs.FAILURES, \
        (dict(graphs.GRAPHS), graphs.FAILURES)
    assert build.LAUNCHES["nes_square"] == 1
    assert build.LAUNCHES["place_rows_uniform"] == 0
    assert build.LAUNCHES["place_rows_general"] == 1
    assert dict(dem.PLACEMENTS) == {"general": 1}
    for name, a, b in zip(ref.CRTState._fields, got, want):
        assert torch.equal(a, b), name
