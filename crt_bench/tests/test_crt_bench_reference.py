"""The frozen reference (crt_bench/reference) against the port's plain path
at a small size on the CPU, for each entry point a cell drives; and the
import rules: the reference imports nothing of the port, and nothing the
harness loads is JAX, Flax or the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from crt_bench.reference import pipeline as ref
from crt_bench.reference import systems as ref_systems
from crt_bench.reference.demodulate import MonitorParams as RefMonitor
from ntsc_crt_tpu_torch.apps.live import LiveSession
from ntsc_crt_tpu_torch.models import pipeline, systems, video
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams

ROOT = Path(__file__).resolve().parents[2]
CPU = "cpu"


def same(state, rstate):
    for name, a, b in zip(ref.CRTState._fields, state, rstate):
        assert torch.equal(a, b), name


def test_step_batch_sequence_equals_the_reference():
    cfg, rcfg = systems.SYSTEMS["NTSCVHS"], ref_systems.SYSTEMS["NTSCVHS"]
    g = torch.Generator().manual_seed(5)
    imgs = torch.randint(0, 256, (3, 3, 60, 80, 3), generator=g,
                         dtype=torch.uint8)
    mon = dict(blend=0, scanlines=0, saturation=10)
    st = pipeline.init_batch(cfg, 3, 80, 60, device=CPU)
    rst = ref.init_slots(rcfg, [0, 1, 2], 80, 60)
    off = [0, 3, 2]
    for k in range(3):
        fr = [ref.converter_parity((k + o) % 4) for o in off]
        f = torch.tensor([a for a, _ in fr], dtype=torch.int32)
        r = torch.tensor([b for _, b in fr], dtype=torch.int32)
        st = pipeline.step_batch(cfg, st, imgs[k], f, r,
                                 torch.zeros(3, dtype=torch.int32), noise=24,
                                 mon=MonitorParams(**mon), do_aberration=1)
        rst = ref.step(rcfg, rst, imgs[k], field=f, frame=r, noise=24,
                       mon=RefMonitor(**mon), do_aberration=1)
        same(st, rst)


def test_live_session_nes_sequence_equals_the_reference():
    cfg, rcfg = systems.SYSTEMS["NES"], ref_systems.SYSTEMS["NES"]
    rng = np.random.default_rng(6)
    sess = LiveSession(cfg, outw=832, outh=624, device=CPU)
    rst = ref.init_slots(rcfg, [0], 832, 624)
    for n in range(4):
        ppu = rng.integers(0, 512, (240, 256)).astype(np.uint16)
        frame = sess.tick(ppu)
        field, fr, dco = ref.live_knobs(rcfg, n)
        rst = ref.step(rcfg, rst._replace(out=ref.fade_phosphors(rst.out)),
                       torch.from_numpy(ppu)[None], field=field, frame=fr,
                       dot_crawl_offset=dco, mon=RefMonitor())
        same(pipeline._map(sess.state, lambda x: x[None]), rst)
        assert np.array_equal(frame, rst.out[0].numpy())


def test_video_exact_chunk_chain_equals_the_reference():
    cfg, rcfg = systems.SYSTEMS["NTSCVHS"], ref_systems.SYSTEMS["NTSCVHS"]
    g = torch.Generator().manual_seed(7)
    frames = torch.randint(0, 256, (8, 48, 64, 3), generator=g,
                           dtype=torch.uint8)
    mon = dict(blend=0, scanlines=0, saturation=10)
    st = pipeline.crt_init(cfg, 64, 48, device=CPU)
    rst = ref.init_slots(rcfg, [0], 64, 48)
    for c in range(2):
        st, outs = video.video_exact(cfg, st, frames[4 * c:4 * c + 4],
                                     noise=24, mon=MonitorParams(**mon),
                                     do_aberration=1)
        for i in range(4):
            field, fr = ref.converter_parity(4 * c + i)
            rst = ref.step(rcfg, rst, frames[4 * c + i][None], field=field,
                           frame=fr, noise=24, mon=RefMonitor(**mon),
                           do_aberration=1)
            assert torch.equal(outs[i], rst.out[0])
        same(pipeline._map(st, lambda x: x[None]), rst)


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_reference_imports_nothing_of_the_port():
    tops = loaded("import crt_bench.reference.pipeline, "
                  "crt_bench.reference.kernels")
    assert "torch" in tops
    assert not tops & {"ntsc_crt_tpu_torch", "ntsc_crt_tpu", "jax",
                       "jaxlib", "flax"}


def test_the_harness_loads_no_jax():
    """A rehearsal of every import the harness makes in a run: run.py,
    the port behind program.Port, each cell's driver and metric reader,
    and the control."""
    tops = loaded(
        "import json, runpy\n"
        "runpy.run_path('crt_bench/run.py', run_name='crt_bench_run')\n"
        "from crt_bench import control, harness, program\n"
        "program.Port()\n"
        "spec = harness.load_spec()\n"
        "for w in spec['workloads']:\n"
        "    _, _, t = harness.cell_files(spec, w['name'])\n"
        "    harness.driver(t)\n"
        "for m in spec['per_layer']:\n"
        "    harness.reader(m['name'])\n")
    assert "ntsc_crt_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "ntsc_crt_tpu"}
