"""The NES cell, ``nes_batch2048``: its files found by name, whole runs at a
size a test run holds (the port correct; the control and a planted fault
in K13's output or in the row placement not correct), its metrics on
hand-made traces, and K13's and the placement's work counts.  The ``gpu``
cases run the cell on the card."""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from crt_bench import control, harness, work, work_nes
from crt_bench.reference import systems as ref_systems
from crt_bench.trace import Trace
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.ops.kernels import nes

CELL = "nes_batch2048"
SMALL = dict(batch=4, pool=2, warmup_steps=1, trace_steps=2,
             issue_samples=1, check={"slots": 4, "steps": 1, "within": 2})
SEED = 2**31 + 25
SPEC = harness.load_spec()
# the batch cells' metrics this cell reports, in the order BENCHMARK.json
# lists them, then the cell's own
SHARED = ["step_issue_ms.batch", "modulate_device_ms.batch",
          "demodulate_device_ms.batch", "decode_rows_roofline_pct.batch",
          "device_idle_pct.batch", "encode_device_ms.batch",
          "noise_device_ms.batch", "vsync_device_ms.batch",
          "line_scan_device_ms.batch", "decode_device_ms.batch",
          "place_rows_device_ms.batch"]
NEW = ["nes_square_roofline_pct.nes", "place_rows_roofline_pct.nes"]
ROOFLINES = ["decode_rows_roofline_pct.batch"] + NEW
METRICS = SHARED + NEW
NES = ref_systems.SYSTEMS["NES"]


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
    assert cell["chips"] == 1 and cell["config"] == "nes_ppu_832x624"
    assert conf["system"] == "NES" and conf["step"] == {}
    assert conf["input"] == {"kind": "ppu", "width": 256, "height": 240,
                             "bits": 9}
    assert conf["output"] == {"width": 832, "height": 624}
    assert conf["reduced"] == [] and conf["noise"] == 0
    assert conf["monitor"] == {"blend": 0, "scanlines": 0, "saturation": 10,
                               "contrast": 180}
    drv = harness.driver(traffic)
    assert traffic["driver"] == "batch_closed_nes"
    for fn in ("setup", "window", "more", "release", "replay"):
        assert callable(getattr(drv, fn))
    assert {m["name"] for m in harness.metrics_of(SPEC, CELL, "end_to_end")} \
        == {"batch_frames_per_s", "batch_peak_mem_gib", "setup_s"}
    assert [m["name"] for m in harness.metrics_of(SPEC, CELL, "per_layer")] \
        == METRICS
    for m in METRICS:
        assert callable(harness.reader(m).read)
    # the output state passes 2^31 elements; slots 1379 and up start past
    # element 2^31
    out = conf["output"]
    per_slot = out["height"] * out["width"] * 3
    assert traffic["batch"] * per_slot > 2**31
    assert 1378 * per_slot < 2**31 < 1379 * per_slot


def test_the_port_is_correct():
    dem.PLACEMENTS.clear()
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"batch_frames_per_s",
                                   "batch_peak_mem_gib", "setup_s"}
    # every step's rows placed by the general path (624 rows of 240 lines)
    assert set(dem.PLACEMENTS) == {"general"}


def k13_one_class_off(nes_square):
    """K13 with every row's phase class taken one dot-crawl step on."""
    def call(analog, ppu, table, dco, *args, **kw):
        return nes_square(analog, ppu, table, dco + 1, *args, **kw)
    return call


def placement_one_row_off(general):
    """The general placement with the output's rows moved down one."""
    def call(*args, **kw):
        return torch.roll(general(*args, **kw), 1, dims=1)
    return call


@pytest.mark.parametrize("fault", ["eq_float", "k13_one_class_off",
                                   "placement_one_row_off"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    sut = None
    if fault == "eq_float":
        sut = control.Control()
    elif fault == "k13_one_class_off":
        monkeypatch.setattr(nes, "nes_square",
                            k13_one_class_off(nes.nes_square))
    else:
        monkeypatch.setattr(dem, "_place_rows_general",
                            placement_one_row_off(dem._place_rows_general))
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


K13_NAME = ("(anonymous namespace)::nes_square_kernel(signed char*, "
            "unsigned short const*, int const*, int const*, int const*, "
            "int const*, int const*, int const*, int const*, int*, "
            "(anonymous namespace)::Geometry)")


def test_the_metrics_read_nothing_on_a_hand_made_trace():
    """No device operation: every metric None.  Device operations that are
    neither K13 nor K2: the rooflines find nothing, and without the Probe
    that recorded a trace no program span is read."""
    empty = hand_made([], steps=0)
    assert {m: harness.reader(m).read(empty) for m in METRICS} == \
        dict.fromkeys(METRICS)
    other = hand_made([("ccf_ema_kernel<4, 10, 4>", 0, 10),
                       ("index_elementwise_kernel", 10, 50)])
    got = {m: harness.reader(m).read(other) for m in METRICS}
    assert got.pop("device_idle_pct.batch") == pytest.approx(50.0)
    assert got == dict.fromkeys(got)


def test_k13s_roofline_prices_its_device_time(capsys):
    """K13's share: its bound from the cell's shapes over its device time a
    step; the placement's reads nothing without the port's spans."""
    tr = hand_made([(K13_NAME, 0, 30), (K13_NAME, 40, 50)], steps=2)
    counts = work_nes.nes_square(NES, 2048, 240, 256)
    bound, by = work.bound_s(*counts)
    got = harness.reader("nes_square_roofline_pct.nes").read(tr)
    assert got == pytest.approx(100 * bound / (40 / 2 * 1e-6))
    assert by == "bytes"
    assert "nes_square: bound" in capsys.readouterr().err
    assert harness.reader("place_rows_roofline_pct.nes").read(tr) is None


def test_the_placement_floor():
    """At B 2048: each of the 240 lines of 832 RGB pixels read once, the
    624 rows written once, 4.42e9 bytes, bound by its bytes."""
    nbytes, ops = work_nes.place_rows(2048, NES.lines, 832, 624)
    assert nbytes == 2048 * 3 * 832 * (240 + 624) and ops == 0
    assert work.bound_s(nbytes, ops)[1] == "bytes"


def test_the_work_counts_equal_chip_smokes():
    """At B 2048, on shapes alone (meta tensors): K13 over the NES field
    from 256x240 PPU pixels, the optimized build without the border, counts
    what chip_smoke.work_nes counts."""
    B, V, H = 2048, NES.vres, NES.hres
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    analog = torch.empty((B, V, H), dtype=torch.int8, **meta)
    a = (analog, torch.empty((B, 240, 256), dtype=torch.int16, **meta),
         torch.empty((512, 12), **i32),
         *(torch.empty(B, **i32) for _ in range(5)),
         torch.empty(719, **i32))
    k = dict(xo=NES.av_beg & ~3, yo=NES.top, destw=NES.av_len,
             desth=NES.lines, draw_border=False)
    out = (analog, torch.empty((B, NES.cc_vper, NES.cc_samples), **i32))
    nbytes, ops, _ = chip_smoke.work_nes(a, k, out)
    assert (nbytes, ops) == work_nes.nes_square(NES, B, 240, 256)
    assert work_nes.picture_samples(NES) == NES.lines * NES.av_len
    assert np.isclose(work.bound_s(nbytes, ops)[0], 0.000220768, rtol=1e-5)


@pytest.mark.gpu
def test_the_port_is_correct_on_the_card(card):
    res = run(card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_every_nes_metric(card):
    res = run(card, traced=True)
    assert res["correct"]
    assert set(res["metrics"]) == set(METRICS)
    for m in ROOFLINES:
        assert 0 < res["metrics"][m]["value"] <= 100, m


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(card):
    res = run(card, sut=control.Control())
    assert not res["correct"]
