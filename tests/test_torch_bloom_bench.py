"""The bloom build's benchmark pieces against the JAX package and the port,
on the CPU: the bloom reference (``crt_bench/reference_bloom``) bit-exact
to the JAX package's bloom step and to the ``NTSC_bloom`` golden; the
port's ``step_batch(do_bloom=True)`` bit-exact to the reference over a
sequence of per-slot parities; what the reference and the cell's driver
import; and the port's ``ntsc.demodulate.bloom`` span.  The test marked
`gpu` holds the cell's step on the card to bloom's own kernels and skips
without one.

JAX is imported inside the tests that use it, so the `gpu` test also runs
on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \
        tests/test_torch_bloom_bench.py -m gpu
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
from crt_bench.reference_bloom import pipeline as ref_bloom
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.ops.kernels import decode
from test_torch_spans import replay  # noqa: F401  (a fixture)

torch.set_num_threads(1)  # the tier runs several workers on few cores

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "fixtures" / "device_parity_goldens.npz"
NTSC, RCFG = systems.NTSC, ref_systems.SYSTEMS["NTSC"]


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


@pytest.mark.parametrize("blend,scanlines", [(0, 0), (1, 1)])
def test_the_reference_equals_the_jax_bloom_step(blend, scanlines):
    """B 2 at 128x96 (the general row placement), noise 24, three steps on
    per-slot parities, every state leaf compared after each."""
    import jax.numpy as jnp
    from helpers import run_step
    from ntsc_crt_tpu.models import pipeline as jpipe
    from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
    from ntsc_crt_tpu.models.systems import SYSTEMS as JSYSTEMS

    B, outw, outh = 2, 128, 96
    knobs = dict(blend=blend, scanlines=scanlines, saturation=10)
    rng = np.random.default_rng(18 + blend)
    jst = jpipe.crt_init(JSYSTEMS["NTSC"], outw, outh, batch=B)
    jst = jst._replace(rn=jnp.arange(194, 194 + B, dtype=jnp.int32),
                       randstate=jnp.arange(1, 1 + B, dtype=jnp.int32))
    rst = ref.init_slots(RCFG, range(B), outw, outh)
    jmon = JMon(**{k: np.int32(v) for k, v in knobs.items()})
    for k in range(3):
        img = rng.integers(0, 256, (B, 48, 64, 3)).astype(np.uint8)
        field, frame = parities(k, [0, 3])
        jst = run_step(JSYSTEMS["NTSC"], jst, img, mon=jmon,
                       field=field.numpy(), frame=frame.numpy(), noise=24,
                       do_bloom=True)
        rst = ref_bloom.step(RCFG, rst, torch.as_tensor(img), field=field,
                             frame=frame, noise=24, mon=RefMonitor(**knobs))
        for name, v in jst._asdict().items():
            same(getattr(rst, name).numpy(), np.asarray(v),
                 f"step {k} {name}")


def test_the_reference_replays_the_bloom_golden():
    """The NTSC_bloom tag: two 320x240 frames at 128x96, noise 7,
    field/frame (0, 0) then (1, 1)."""
    want = np.load(GOLDENS)
    img = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3),
                                           np.uint8)
    st = ref.init_slots(RCFG, [0], 128, 96)
    for f in (0, 1):
        st = ref_bloom.step(RCFG, st, torch.as_tensor(img), field=f, frame=f,
                            noise=7, mon=RefMonitor())
    for name, v in st._asdict().items():
        same(v[0].numpy(), want[f"NTSC_bloom/{name}"], name)


@pytest.mark.parametrize("outw,outh", [(160, 480), (128, 96)])
def test_the_port_bloom_sequence_equals_the_reference(outw, outh):
    """The cell's knobs (noise 24, blend 1, scanlines 1), three steps of B
    3 on per-slot parities: at 160x480 K6's stacked form in its bloom
    mode, at 128x96 the general placement with the drawn-pixel plane."""
    g = torch.Generator().manual_seed(18)
    imgs = torch.randint(0, 256, (3, 3, 60, 80, 3), generator=g,
                         dtype=torch.uint8)
    knobs = dict(blend=1, scanlines=1, saturation=10)
    st = pipeline.init_batch(NTSC, 3, outw, outh, device="cpu")
    rst = ref.init_slots(RCFG, [0, 1, 2], outw, outh)
    for k in range(3):
        field, frame = parities(k, [0, 3, 2])
        st = pipeline.step_batch(NTSC, st, imgs[k], field, frame,
                                 torch.zeros(3, dtype=torch.int32), noise=24,
                                 mon=MonitorParams(**knobs), do_bloom=True)
        rst = ref_bloom.step(RCFG, rst, imgs[k], field=field, frame=frame,
                             noise=24, mon=RefMonitor(**knobs),
                             do_bloom=True)
        for name, a, b in zip(ref.CRTState._fields, st, rst):
            same(a.numpy(), b.numpy(), f"step {k} {name}")


@pytest.mark.parametrize("kernel", ["decode", "line_width", "place"])
def test_the_references_bloom_kernels_equal_the_ports_plain_ones(kernel):
    """On tables that reach the rules the cell's data never does: pixel
    steps of every kind (decode.bloom_steps: past the EQ's end, 0,
    negative, wrapping), windows from below 0 and spilling past the row,
    max_e 0 and -1, pixels outside their line's drawn width, per-slot
    blend and scanlines."""
    from crt_bench.reference_bloom import kernels as rk
    rng = np.random.default_rng(18)
    B, L, V, H, av, outw = 3, 7, 12, 80, 64, 40
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    field = torch.as_tensor(rng.integers(-128, 128, (B, V, H), np.int8))
    line_row = i32(rng.integers(0, V, (B, L)))
    pairs = decode.line_pairs(field, line_row)
    if kernel == "decode":
        tables = {k: i32(v) for k, v in decode.bloom_steps(
            rng, B, L, av, outw, 4).items()}
        waveI = i32(rng.integers(-60000, 60000, (B, L, 4)))
        args = (i32(rng.integers(0, H, (B, L))) + tables["bloom_lidx"],
                waveI, torch.roll(waveI, -3, -1),
                i32(rng.integers(-20, 20, (B, L))),
                i32(rng.integers(150, 200, (B, L))))
        kw = dict(coefs=dem._eq_coefs(NTSC), av_len=av, outw=outw, **tables)
        got = rk.decode_rows_bloom_plain(pairs, *args, **kw)
        want = decode.decode_rows_plain(field, line_row, *args, **kw)
    elif kernel == "line_width":
        xpos = i32(rng.integers(-av, H + av, (B, L)))
        max_e = i32([0, -1, (128 + 12) * av])
        got = rk.bloom_line_width_plain(pairs, xpos, max_e, av_len=av)
        want = decode.bloom_line_width_plain(field, line_row, xpos, max_e,
                                             av_len=av)
    else:
        outh = 25
        rgb = torch.as_tensor(rng.integers(0, 256, (B, L, outw, 3), np.uint8))
        old = torch.as_tensor(rng.integers(0, 256, (B, outh, outw, 3),
                                           np.uint8))
        lrel = torch.arange(L, dtype=torch.int32)[None]
        fp = i32([0, 1, 1])[:, None]
        beg, end = lrel * outh // L + fp, (lrel + 1) * outh // L + fp
        valid = torch.as_tensor(rng.random((B, L, outw)) < 0.7)
        args = (rgb, old, beg, end, beg < outh, i32([0, 1, 1]),
                i32([0, 1, 0]), outh)
        got = rk.place_rows_general(*args, valid=valid)
        want = dem._place_rows_general(*args, valid=valid)
    same(got.numpy(), want.numpy(), kernel)


def test_the_reference_takes_the_bloom_build_only():
    st = ref.init_slots(RCFG, [0], 64, 48)
    img = torch.zeros((1, 24, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="bloom build only"):
        ref_bloom.step(RCFG, st, img, field=0, frame=0, mon=RefMonitor(),
                       do_bloom=False)


def test_the_reference_and_the_driver_import_no_jax_nor_the_port():
    code = ("import crt_bench.reference_bloom.pipeline, "
            "crt_bench.drivers.batch_closed_bloom, crt_bench.work_bloom, "
            "crt_bench.readers_bloom\nimport sys\n"
            "print(' '.join(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    tops = set(out.stdout.split())
    assert "torch" in tops
    assert not tops & {"ntsc_crt_tpu_torch", "ntsc_crt_tpu", "jax",
                       "jaxlib", "flax"}


@pytest.mark.usefixtures("replay")
def test_the_bloom_span_holds_the_line_widths(monkeypatch):
    """A bloom step records ntsc.demodulate.bloom inside ntsc.demodulate,
    after the line scan; bloom_line_width runs inside it and not inside
    ntsc.demodulate.line_scan.  A step without bloom records no bloom
    span.  The kernels replay their unprofiled results (`replay`)."""
    width = decode.bloom_line_width

    def marked(*a, **k):
        with torch.profiler.record_function("test.bloom_line_width"):
            return width(*a, **k)

    monkeypatch.setattr(decode, "bloom_line_width", marked)
    st = pipeline.init_batch(NTSC, 1, 64, 48, device="cpu")
    img = torch.zeros((1, 24, 32, 3), dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int32)
    for bloom in (True, False):
        pipeline.step_batch(NTSC, st, img, z, z, z, noise=12, do_bloom=bloom)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipeline.step_batch(NTSC, st, img, z, z, z, noise=12,
                                do_bloom=bloom)
        events = prof.events()
        spans = [e for e in events if e.name == "ntsc.demodulate.bloom"]
        if not bloom:
            assert not spans
            continue
        assert len(spans) == 1 and spans[0].cpu_parent.name == \
            "ntsc.demodulate"
        scan = [e for e in events if e.name == "ntsc.demodulate.line_scan"]
        assert scan[0].time_range.end <= spans[0].time_range.start
        calls = [e for e in events if e.name == "test.bloom_line_width"]
        assert len(calls) == 1
        chain, p = [], calls[0].cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        assert chain[0] == "ntsc.demodulate.bloom"
        assert "ntsc.demodulate.line_scan" not in chain


@pytest.mark.gpu
def test_the_cells_step_launches_blooms_kernels_once(monkeypatch):
    """One B 2048 step of the bloom cell (640x480, noise 24, blend 1,
    scanlines 1) launches K2's and K6's bloom modes and bloom_line_width
    once each, and never the general row placement."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    from ntsc_crt_tpu_torch.ops.kernels import build
    dev = torch.device("cuda")
    B = 2048

    def refuse(*a, **k):
        raise AssertionError("the general row placement ran")

    monkeypatch.setattr(dem, "_place_rows_general", refuse)
    st = pipeline.init_batch(NTSC, B, 640, 480, device=dev)
    img = torch.randint(0, 256, (B, 480, 640, 3), dtype=torch.uint8,
                        device=dev)
    field = torch.arange(B, dtype=torch.int32, device=dev) % 2
    mon = MonitorParams(blend=1, scanlines=1, saturation=10)
    build.LAUNCHES.clear()
    st = pipeline.step_batch(NTSC, st, img, field, field, field * 0,
                             noise=24, mon=mon, do_bloom=True)
    torch.cuda.synchronize()
    for name in ("decode_rows_bloom", "bloom_line_width",
                 "place_rows_uniform_bloom"):
        assert build.LAUNCHES[name] == 1, (name, dict(build.LAUNCHES))
    assert build.LAUNCHES["decode_rows"] == 0
    assert build.LAUNCHES["place_rows_uniform"] == 0
