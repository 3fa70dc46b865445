"""The PV1K cell, ``pv1k_batch2048``: its files found by name, whole runs
at a size a test run holds (the port correct; the control and a planted
fault not correct), its metrics on hand-made traces, and the K1 and K2
rooflines' work counts at 5-sample chroma against ``chip_smoke.py``'s.
The ``gpu`` cases run the cell on the card."""

import time

import pytest
import torch

import chip_smoke
from crt_bench import control_vper, harness, work
from crt_bench.reference import systems as ref_systems
from crt_bench.trace import Trace
from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import modulate, systems

CELL = "pv1k_batch2048"
SMALL = dict(batch=4, pool=2, warmup_steps=1, trace_steps=2,
             issue_samples=1, check={"slots": 4, "steps": 1, "within": 2})
SEED = 2**31 + 23
SPEC = harness.load_spec()
# the batch cells' stage metrics and K1's and K2's rooflines, in the
# order BENCHMARK.json lists them, then the cell's own
SHARED = ["step_issue_ms.batch", "modulate_device_ms.batch",
          "demodulate_device_ms.batch", "decode_rows_roofline_pct.batch",
          "encode_rows_roofline_pct.batch", "device_idle_pct.batch",
          "field_device_ms.batch", "encode_device_ms.batch",
          "noise_device_ms.batch", "vsync_device_ms.batch",
          "line_scan_device_ms.batch", "decode_device_ms.batch",
          "place_rows_device_ms.batch"]
NEW = ["skeleton_device_ms.pv1k", "store_active_device_ms.pv1k"]
ROOFLINES = ["encode_rows_roofline_pct.batch",
             "decode_rows_roofline_pct.batch"]
METRICS = SHARED + NEW
PV1K = ref_systems.SYSTEMS["PV1K"]
DESTH = (PV1K.lines * 64500) >> 16


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
    assert cell["chips"] == 1 and cell["config"] == "pv1k_640x480"
    assert set(conf) == {"system", "input", "output", "noise", "monitor",
                         "step", "eq", "parities", "guarantee",
                         "deployment", "reduced", "assumed"}
    assert conf["system"] == "PV1K" and conf["step"] == {}
    assert conf["reduced"] == [] and conf["noise"] == 24
    assert conf["monitor"] == {"blend": 1, "scanlines": 1, "saturation": 10}
    drv = harness.driver(traffic)
    assert traffic["driver"] == "batch_closed_vper"
    for fn in ("setup", "window", "more", "release", "replay"):
        assert callable(getattr(drv, fn))
    assert {m["name"] for m in harness.metrics_of(SPEC, CELL, "end_to_end")} \
        == {"batch_frames_per_s", "batch_peak_mem_gib", "setup_s"}
    assert [m["name"] for m in harness.metrics_of(SPEC, CELL, "per_layer")] \
        == METRICS
    for m in METRICS:
        assert callable(harness.reader(m).read)
    # the batch's inputs and its fields keep 32-bit indices: 1.89e9 and
    # 1.03e9 elements
    inp, B = conf["input"], traffic["batch"]
    assert B * inp["height"] * inp["width"] * 3 < 2**31
    assert B * PV1K.vres * PV1K.hres < 2**31


def test_the_port_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"batch_frames_per_s",
                                   "batch_peak_mem_gib", "setup_s"}


def burst_one_class_off(burst_rows):
    """The vper encoder's burst with every row's table taken from the next
    vertical class."""
    def call(ccburst, cfg, row0, nrows):
        return burst_rows(ccburst, cfg, row0 + 1, nrows)
    return call


@pytest.mark.parametrize("fault", ["eq_float", "burst_one_class_off"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    sut = None
    if fault == "eq_float":
        sut = control_vper.ControlVper()
    else:
        monkeypatch.setattr(modulate, "_burst_rows",
                            burst_one_class_off(modulate._burst_rows))
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


K1_CC5 = ("void (anonymous namespace)::encode_rows_kernel<5, false>"
          "(unsigned char const*, int const*)")
K2_CC5 = ("void (anonymous namespace)::decode_rows_kernel<5, "
          "(anonymous namespace)::ThreeBand, false>(signed char const*)")
K1_CC5_MANGLED = "_ZN12_GLOBAL__N_118encode_rows_kernelILi5ELb0EEEvPKhPKi"
K2_CC5_MANGLED = ("_ZN12_GLOBAL__N_118decode_rows_kernelILi5ENS_9ThreeBandE"
                  "Lb0EEEvPKa")
NAMES = {"demangled": (K1_CC5, K2_CC5),
         "mangled": (K1_CC5_MANGLED, K2_CC5_MANGLED)}


def cell_work(B):
    """(bytes, int32 ops) of K1's block and K2's 3-band mode a step at the
    cell's shapes: the yardstick's counts at 5-sample chroma, with
    bandlimiting."""
    _, conf, _ = harness.cell_files(SPEC, CELL)
    inp, outw = conf["input"], conf["output"]["width"]
    return (work.encode_rows(B, inp["height"], inp["width"], DESTH,
                             PV1K.av_len, 5, True),
            work.decode_rows(B, PV1K.lines, PV1K.hres, PV1K.av_len, outw, 5))


def test_the_metrics_read_nothing_on_a_hand_made_trace():
    """No device operation: every metric None.  Device operations that are
    neither K1 nor K2: the rooflines find nothing, and without the Probe
    that recorded a trace no program span is read."""
    empty = hand_made([], steps=0)
    assert {m: harness.reader(m).read(empty) for m in METRICS} == \
        dict.fromkeys(METRICS)
    other = hand_made([("ccf_ema_kernel<5, 10, 5>", 0, 10),
                       ("place_rows_kernel", 10, 50)])
    got = {m: harness.reader(m).read(other) for m in METRICS}
    assert got.pop("device_idle_pct.batch") == pytest.approx(50.0)
    assert got == dict.fromkeys(got)


@pytest.mark.parametrize("form", sorted(NAMES))
def test_the_rooflines_count_the_5_sample_work(form, capsys):
    """On this cell the K1 and K2 rooflines price their kernels' device
    time, demangled or mangled, at CC 5 with bandlimiting, from the cell's
    shapes."""
    k1, k2 = NAMES[form]
    tr = hand_made([(k1, 0, 30), (k2, 30, 70), (k2, 70, 80)], steps=2)
    enc, dec = cell_work(tr.cell["traffic"]["batch"])
    for name, counts, us in (("encode_rows_roofline_pct.batch", enc, 30),
                             ("decode_rows_roofline_pct.batch", dec, 50)):
        bound, _ = work.bound_s(*counts)
        got = harness.reader(name).read(tr)
        assert got == pytest.approx(100 * bound / (us / 2 * 1e-6))
    assert "decode_rows: bound" in capsys.readouterr().err


def test_the_cells_bounds():
    """At B 2048: K1's block is bound by its bytes (the 640x480 images
    it reads), K2 by its int32 operations, so its field bytes (the L + 4
    rows the yardstick counts) do not set its roofline."""
    enc, dec = cell_work(2048)
    assert work.bound_s(*enc)[1] == "bytes"
    assert work.bound_s(*dec)[1] == "operations"


@pytest.fixture
def priced(monkeypatch):
    """chip_smoke's chains priced at a dependent op's cycles, as its probe
    would set them on the card."""
    monkeypatch.setitem(chip_smoke.MEASURED, "dep_cycles", 3.5)


def test_the_work_counts_equal_chip_smokes(priced):
    """At PV1K's geometry, B 2, a 64 x 48 image, 64 pixels out: K1's block
    mode over 236 rows of 1487 samples with a 5-entry carrier table a row
    counts as the yardstick does; K2's 3-band mode over 240 lines in the
    5-sample branch counts the yardstick's operations, and no more bytes
    (the yardstick's are the L + 4 rows K2 was once handed)."""
    B, L, H, V, AV, w = 2, PV1K.lines, PV1K.hres, PV1K.vres, PV1K.av_len, 64
    i32 = dict(dtype=torch.int32)
    img = torch.zeros((B, 48, 64, 3), dtype=torch.uint8)
    tables = torch.zeros((B, DESTH, 5), **i32)
    k1 = chip_smoke.work_encode(
        (img, torch.zeros((B, DESTH), **i32), tables, tables,
         torch.zeros(B, **i32), torch.zeros(B, **i32)),
        dict(coefs=modulate._iir_coefs(systems.PV1K)),
        torch.zeros((B, DESTH, AV), dtype=torch.int8))
    assert k1[:2] == work.encode_rows(B, 48, 64, DESTH, AV, 5)
    field = torch.zeros((B, V, H), dtype=torch.int8)
    lines = torch.zeros((B, L), **i32)
    waves = torch.zeros((B, L, 5), **i32)
    k2 = chip_smoke.work_decode(
        (field, lines, lines, waves, waves, lines, lines),
        dict(outw=w, av_len=AV, coefs=dem._eq_coefs(systems.PV1K)),
        torch.zeros((B, L, w, 3), dtype=torch.uint8))
    nbytes, ops = work.decode_rows(B, L, H, AV, w, 5)
    assert k2[1] == ops
    assert k2[0] <= nbytes


@pytest.mark.gpu
def test_the_port_is_correct_on_the_card(card):
    res = run(card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_every_pv1k_metric(card):
    res = run(card, traced=True)
    assert res["correct"]
    assert set(res["metrics"]) == set(METRICS)
    for m in ROOFLINES:
        assert 0 < res["metrics"][m]["value"] <= 100, m


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(card):
    res = run(card, sut=control_vper.ControlVper())
    assert not res["correct"]
