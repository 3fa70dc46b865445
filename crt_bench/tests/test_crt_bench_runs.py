"""Whole runs of each cell with the harness's look for a card skipped, at a
size a test run holds: the port comes out correct; the control (the
reference in the program's place, its EQ in float32) and a timed path
broken underneath come out not correct.  The ``gpu`` cases run the same
on the card."""

import time

import pytest
import torch

from crt_bench import control, harness
from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.ops.kernels import decode

SMALL = {
    "vhs_batch2048": dict(batch=4, pool=2, warmup_steps=1, trace_steps=2,
                          issue_samples=1,
                          check={"slots": 4, "steps": 1, "within": 2}),
    "nes_live60": dict(warmup_ticks=1, trace_steps=3, issue_samples=2,
                       check={"ticks": 2}),
    "vhs_video": dict(chunk=4, pool=4, warmup_chunks=1, trace_steps=1,
                      issue_samples=1, check={"chunks": 1, "within": 1}),
}
SEED = 2**31 + 11
SPEC = harness.load_spec()
# the live and video drivers are held here too, though no cell of
# BENCHMARK.json runs them yet (PERF.md, Open questions)
SPEC_ALL = dict(
    SPEC,
    configs=SPEC["configs"] + [dict(
        name="nes_832x624", file="crt_bench/configs/nes_832x624.json")],
    workloads=SPEC["workloads"] + [
        dict(name="nes_live60", config="nes_832x624", traffic="live60"),
        dict(name="vhs_video", config="ntscvhs_640x480", traffic="video8")],
    end_to_end=SPEC["end_to_end"] + [
        dict(name="live_frame_ms_p95", unit="ms", workloads=["nes_live60"]),
        dict(name="video_frames_per_s", unit="frames/s",
             workloads=["vhs_video"])],
    per_layer=SPEC["per_layer"] + [
        dict(name="step_issue_ms.live", unit="ms", moves="live_frame_ms_p95",
             workloads=["nes_live60"])])


def run(workload, device="cpu", sut=None, traced=False, seed=SEED):
    return harness.run_cell(workload, seed, 0.05, traced,
                            torch.device(device), time.perf_counter(),
                            sut=sut, spec=SPEC_ALL,
                            traffic_over=SMALL[workload])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def test_the_small_sizes_cover_every_cell():
    assert set(SMALL) == {w["name"] for w in SPEC_ALL["workloads"]}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_port_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in harness.metrics_of(
        SPEC_ALL, workload, "end_to_end")}


def test_a_traced_run_reads_its_spans():
    res = run("nes_live60", traced=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    # no device on the CPU: only the host-clock metric has something to read
    assert set(res["metrics"]) == {"step_issue_ms.live"}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload):
    res = run(workload, sut=control.Control())
    assert not res["correct"]
    assert res["checks"]["elements_differing"]["value"] > 0


def unchanged(cfg, state, img, **kw):
    return state


def half(step):
    """The step over the first half of the slots; the rest unchanged."""
    def call(cfg, state, img, **kw):
        h = state.analog.shape[0] // 2
        cut = {k: v[:h] if torch.is_tensor(v) and v.ndim else v
               for k, v in kw.items()}
        new = step(cfg, pipeline._map(state, lambda x: x[:h]), img[:h],
                   **cut)
        return pipeline.CRTState(*(torch.cat([a, b[h:]])
                                   for a, b in zip(new, state)))
    return call


def altered(decode_rows):
    """K2's answer with one pixel of one line altered in every frame."""
    def call(*a, **k):
        out = decode_rows(*a, **k)
        out[:, 100, 5, 0] ^= 1
        return out
    return call


FAULTS = [("vhs_batch2048", "unchanged"), ("vhs_batch2048", "half"),
          ("vhs_batch2048", "altered"), ("nes_live60", "unchanged"),
          ("nes_live60", "altered"), ("vhs_video", "unchanged"),
          ("vhs_video", "altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(pipeline, "step", unchanged)
    elif fault == "half":
        monkeypatch.setattr(pipeline, "step", half(pipeline.step))
    else:
        monkeypatch.setattr(decode, "decode_rows",
                            altered(decode.decode_rows))
    res = run(workload)
    assert not res["correct"]
    assert res["failed"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_port_is_correct_on_the_card(workload, card):
    res = run(workload, card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_the_device(card):
    res = run("vhs_batch2048", card, traced=True)
    assert res["correct"]
    assert res["device"]["busy_s"] > 0
    for name in ("modulate_device_ms.batch", "demodulate_device_ms.batch",
                 "decode_rows_roofline_pct.batch",
                 "encode_rows_roofline_pct.batch", "device_idle_pct.batch"):
        assert name in res["metrics"], name


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct_on_the_card(workload, card):
    res = run(workload, card, sut=control.Control())
    assert not res["correct"]
