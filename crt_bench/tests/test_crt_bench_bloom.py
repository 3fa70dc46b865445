"""The bloom cell, ``bloom_batch2048``: its files found by name, whole runs
at a size a test run holds (the port correct; the control and a planted
fault not correct), its metrics on hand-made traces, and the
bloom kernels' work counts against ``chip_smoke.py``'s.  The ``gpu`` cases
run the cell on the card."""

import time

import pytest
import torch

import chip_smoke
from crt_bench import control_bloom, harness, readers_bloom, work, work_bloom
from crt_bench.reference import systems as ref_systems
from crt_bench.trace import Trace
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import systems
from ntsc_crt_tpu_torch.ops.kernels import decode

CELL = "bloom_batch2048"
SMALL = dict(batch=4, pool=2, warmup_steps=1, trace_steps=2,
             issue_samples=1, check={"slots": 4, "steps": 1, "within": 2})
SEED = 2**31 + 18
SPEC = harness.load_spec()
# the cell's own metrics, and the batch cell's stage metrics it reports too
NEW = ["bloom_lines_device_ms.bloom", "decode_rows_bloom_roofline_pct.bloom",
       "bloom_line_width_roofline_pct.bloom",
       "place_rows_bloom_roofline_pct.bloom"]
SHARED = ["step_issue_ms.batch", "modulate_device_ms.batch",
          "demodulate_device_ms.batch", "device_idle_pct.batch",
          "field_device_ms.batch", "encode_device_ms.batch",
          "noise_device_ms.batch", "vsync_device_ms.batch",
          "line_scan_device_ms.batch", "decode_device_ms.batch",
          "place_rows_device_ms.batch"]
METRICS = SHARED + NEW
NTSC = ref_systems.SYSTEMS["NTSC"]


def run(device="cpu", sut=None, traced=False):
    return harness.run_cell(CELL, SEED, 0.05, traced, torch.device(device),
                            time.perf_counter(), sut=sut, spec=SPEC,
                            traffic_over=SMALL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def test_the_cells_files_load_by_name():
    cell, conf, traffic = harness.cell_files(SPEC, CELL)
    assert cell["chips"] == 1 and cell["config"] == "ntsc_bloom_640x480"
    assert set(conf) == {"system", "input", "output", "noise", "monitor",
                         "step", "eq", "parities", "guarantee",
                         "deployment", "reduced", "assumed"}
    assert conf["step"] == {"do_bloom": True} and conf["reduced"] == []
    assert conf["monitor"] == {"blend": 1, "scanlines": 1, "saturation": 10}
    drv = harness.driver(traffic)
    assert traffic["driver"] == "batch_closed_bloom"
    for fn in ("setup", "window", "more", "release", "replay"):
        assert callable(getattr(drv, fn))
    assert {m["name"] for m in harness.metrics_of(SPEC, CELL, "end_to_end")} \
        == {"batch_frames_per_s", "batch_peak_mem_gib", "setup_s"}
    assert [m["name"] for m in harness.metrics_of(SPEC, CELL, "per_layer")] \
        == METRICS
    for m in METRICS:
        assert callable(harness.reader(m).read)
    # a batch of inputs, 1.89e9 elements, keeps 32-bit indices
    inp = conf["input"]
    assert traffic["batch"] * inp["height"] * inp["width"] * 3 < 2**31


def test_the_port_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"batch_frames_per_s",
                                   "batch_peak_mem_gib", "setup_s"}


def one_line_wider(width):
    """bloom_line_width's energies with line 120's raised by 512: that
    line drawn one sample wider in every frame."""
    def call(*a, **k):
        out = width(*a, **k)
        out[:, 120] += 512
        return out
    return call


@pytest.mark.parametrize("fault", ["eq_float", "one_line_wider"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    sut = None
    if fault == "eq_float":
        sut = control_bloom.ControlBloom()
    else:
        monkeypatch.setattr(decode, "bloom_line_width",
                            one_line_wider(decode.bloom_line_width))
    res = run(sut=sut)
    assert not res["correct"]
    assert res["failed"] > 0
    assert res["checks"]["elements_differing"]["value"] > 0


def hand_made(device, steps=1):
    _, conf, traffic = harness.cell_files(SPEC, CELL)
    return Trace(device=device, launched_in={}, spans={}, walls=[(0, 100)],
                 wall_s_per_step=1e-4 if steps else None, steps=steps,
                 issue_ms=[], cell=dict(conf=conf, traffic=traffic),
                 host_ops=[], window=(0, 100))


K2_BLOOM = ("void (anonymous namespace)::decode_rows_kernel<4, "
            "(anonymous namespace)::ThreeBand, true>(signed char const*)")
K6_BLOOM = ("void (anonymous namespace)::place_rows_kernel<16, true>"
            "(unsigned char const*)")
WIDTH = "void (anonymous namespace)::bloom_line_width_kernel<16>(int)"


def test_the_metrics_read_nothing_on_a_hand_made_trace():
    """No device operation: every metric None.  The 3-band K2 and K6's
    plain mode only: the rooflines find no bloom kernel, and without the
    Probe that recorded a trace no program span is read."""
    empty = hand_made([], steps=0)
    assert {m: harness.reader(m).read(empty) for m in METRICS} == \
        dict.fromkeys(METRICS)
    plain = hand_made([
        (K2_BLOOM.replace("true", "false"), 0, 40),
        (K6_BLOOM.replace("true", "false"), 40, 50)])
    got = {m: harness.reader(m).read(plain) for m in METRICS}
    assert got.pop("device_idle_pct.batch") == pytest.approx(50.0)
    assert got == dict.fromkeys(got)


def test_a_roofline_reads_its_bloom_instantiation(capsys):
    tr = hand_made([(K2_BLOOM, 0, 40), (K2_BLOOM, 40, 50),
                    (K6_BLOOM, 50, 60), (WIDTH, 60, 61)], steps=2)
    for kernel, us in (("decode_rows_bloom", 50), ("place_rows_bloom", 10),
                       ("bloom_line_width", 1)):
        bound, _ = work.bound_s(*readers_bloom.work_of(tr, kernel))
        got = harness.reader(f"{kernel}_roofline_pct.bloom").read(tr)
        assert got == pytest.approx(100 * bound / (us / 2 * 1e-6))
    assert "decode_rows_bloom: bound" in capsys.readouterr().err


@pytest.fixture
def priced(monkeypatch):
    """chip_smoke's chains priced at a dependent op's cycles, as its probe
    would set them on the card."""
    monkeypatch.setitem(chip_smoke.MEASURED, "dep_cycles", 3.5)


def test_the_work_counts_equal_chip_smokes(priced):
    """At the cell's NTSC line geometry, B 2, 64 pixels wide: K2's bloom
    mode with every line at its least width, bloom_line_width with every
    window at one start, K6's bloom mode with blend over both parities."""
    B, L, H, V, AV, w = 2, NTSC.lines, NTSC.hres, NTSC.vres, NTSC.av_len, 64
    i32 = dict(dtype=torch.int32)
    widths = torch.tensor(work_bloom.least_line_widths(L, AV, 24), **i32)
    dx = ((widths << 12) // w).expand(B, L).contiguous()
    field = torch.zeros((B, V, H), dtype=torch.int8)
    lines = torch.zeros((B, L), **i32)
    waves = torch.zeros((B, L, 4), **i32)
    k2 = chip_smoke.work_decode(
        (field, lines, lines, waves, waves, lines, lines),
        dict(outw=w, av_len=AV, coefs=dem._eq_coefs(systems.NTSC),
             bloom_dx=dx, bloom_lidx=lines),
        torch.zeros((B, L, w, 3), dtype=torch.uint8))
    assert k2[:2] == work_bloom.decode_rows_bloom(B, L, H, V, AV, w, 4, 24)
    lw = chip_smoke.work_line_width(
        (field, lines, torch.full((B, L), 100, **i32),
         torch.zeros(B, **i32)), dict(av_len=AV), lines)
    assert lw[:2] == work_bloom.bloom_line_width(B, L, AV)
    old = torch.zeros((B, 2 * L, w, 3), dtype=torch.uint8)
    k6 = chip_smoke.work_place(
        (torch.zeros((B, L, w, 3), dtype=torch.uint8), old,
         torch.tensor([0, 1], **i32)),
        dict(ratio=2, fp=1, scanlines=1, blend=True, bloom_dx=dx,
             bloom_scan=lines, av_len=AV), old)
    assert k6[:2] == work_bloom.place_rows_bloom(B, L, w, 2, True, 1)


@pytest.mark.gpu
def test_the_port_is_correct_on_the_card(card):
    res = run(card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_every_bloom_metric(card):
    res = run(card, traced=True)
    assert res["correct"]
    assert set(res["metrics"]) == set(METRICS)
    for m in METRICS:
        if m.endswith("roofline_pct.bloom"):
            assert 0 < res["metrics"][m]["value"] <= 100, m


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(card):
    res = run(card, sut=control_bloom.ControlBloom())
    assert not res["correct"]
