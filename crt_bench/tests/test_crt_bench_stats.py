"""The benchmark's arithmetic, its work counts and its comparison, on the
CPU."""

import numpy as np
import pytest
import torch

from crt_bench import check, readers, stats, work
from crt_bench.trace import Trace


def test_percentile_is_over_every_value_and_interpolates():
    vals = list(range(1, 101))          # 1..100
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile(vals, 50) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95) == 7.0
    rng = np.random.default_rng(3)
    x = rng.exponential(size=1001)
    assert stats.percentile(x, 95) == pytest.approx(np.percentile(x, 95))
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_over_the_whole_window():
    assert stats.rate(1024 * 300, 4.0) == 76800.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_clip_and_gaps():
    assert stats.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5), (5, 5)]) == [
        (0, 2.5), (3, 4)]
    busy = [(1, 2), (1.5, 3), (6, 7), (9, 12)]
    assert stats.covered(stats.clip(busy, [(0, 10)])) == 4
    # two walls, the pacing between them left out
    assert stats.clip(busy, [(0, 4), (5, 8)]) == [(1, 3), (6, 7)]
    assert stats.gaps(busy, [(0, 10)]) == [(3, 6), (7, 9), (0, 1)]


def test_idle_share_is_the_traced_union_over_the_untraced_wall():
    # two traced steps inside a window of 0..100 us: the union of the
    # device's operations is 30 us (10..30 with an overlap, 50..60), 15 us
    # a step, against 20 us a step with the profiler off: 25 % idle
    tr = Trace(device=[("k", 10, 25), ("k", 20, 30), ("m", 50, 60),
                       ("late", 150, 160)],
               launched_in={"modulate": [("k", 10, 25)]}, spans={},
               walls=[(0, 50), (50, 100)], wall_s_per_step=20e-6, steps=2,
               issue_ms=[3.0, 5.0], cell={}, host_ops=[], window=(0, 100))
    assert readers.idle_pct(tr) == pytest.approx(25.0)
    assert readers.span_device_ms(tr, "modulate") == pytest.approx(7.5e-3)
    assert readers.ops_per_step(tr) == 2
    assert readers.issue_ms(tr) == 4.0
    assert readers.span_device_ms(tr, "demodulate") is None


def test_open_loop_latency_runs_from_the_due_time():
    now = [0.0]
    took = {0: 2.0}

    def serve(i):
        now[0] += took.get(i, 0.5)

    def sleep(s):
        now[0] += s

    due, done = stats.open_loop(5, 1.0, serve, lambda: now[0], sleep, 0.0)
    assert due == [0.0, 1.0, 2.0, 3.0, 4.0]
    # request 0 stalls two periods: 1 and 2 are sent late, at once
    lat = [d - u for u, d in zip(due, done)]
    assert lat == pytest.approx([2.0, 1.5, 1.0, 0.5, 0.5])


def test_work_counts_at_hand_worked_shapes():
    # K1: 1 frame of 2x2 RGB, 1 row of 2 samples, cc 4: image 12 B, sy 4,
    # tables 2 * 4 * 4, gain and base 8, out 2; 2 samples * 43 ops
    assert work.encode_rows(1, 2, 2, 1, 2, 4) == (58, 86)
    assert work.encode_rows(1, 2, 2, 1, 2, 4, band=False) == (58, 62)
    # K2: 1 frame, 1 line of H 10: rows 5 * 10 B, shift 4, waves 32,
    # bright and contrast 8, 2 pixels out 6; 4 * 158 + 2 * 44 ops
    assert work.decode_rows(1, 1, 10, 4, 2, 4) == (100, 720)
    # the VHS batch shapes: 640x480 in, 236 rows of 753 samples, 240 lines
    # of 910 samples, 640 pixels out; at B 1024, and at the cell's 2048
    # twice as much
    assert work.encode_rows(1024, 480, 640, 236, 753, 4) == (
        1_134_399_488, 7_824_838_656)
    assert work.decode_rows(1024, 240, 910, 753, 640, 4) == (
        710_041_600, 36_159_651_840)
    assert work.encode_rows(2048, 480, 640, 236, 753, 4) == (
        2_268_798_976, 15_649_677_312)
    assert work.decode_rows(2048, 240, 910, 753, 640, 4) == (
        1_420_083_200, 72_319_303_680)
    t, by = work.bound_s(710_041_600, 36_159_651_840)
    assert by == "operations"
    assert t == pytest.approx(36_159_651_840 / 56.71e12)
    t, by = work.bound_s(1_134_399_488, 7_824_838_656)
    assert by == "bytes" and t == pytest.approx(1_134_399_488 / 3.35e12)


def test_judge_counts_elements_and_answers():
    a = torch.zeros((3, 4, 5), dtype=torch.int32)
    b = a.clone()
    b[1, 2, 3] = 1
    b[2, 0, 0] = -1
    b[2, 1, 0] = 7
    checks, fields, failed = check.judge([("x", a, b),
                                          ("y", a[:, 0], a[:, 0])])
    assert checks == {"elements_differing": {"value": 3, "limit": 0}}
    assert fields == {"x": 3, "y": 0} and failed == 2
    checks, fields, failed = check.judge([("x", a[:, :2], b)])
    assert failed == 3 and fields["x"] == b.numel()
    assert check.lines(checks, fields) == [
        f"x {b.numel()}", f"check elements_differing: {b.numel()} (limit 0)"]
