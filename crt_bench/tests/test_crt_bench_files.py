"""BENCHMARK.json and the files it names: every configuration, traffic
mix, driver and per-layer metric is a file of its own, found by name, and
the entries keep the shape the benchmark's checker reads."""

import re

import pytest

from crt_bench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_the_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "crt_bench/run.py"]
    assert SPEC["paths"] == ["crt_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_entries():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("crt_bench/configs/")
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(w in CELLS for w in m.get("workloads", []))
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["workloads"]
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_finds_its_files_and_reports(workload):
    cell, conf, traffic = harness.cell_files(SPEC, workload)
    drv = harness.driver(traffic)
    for fn in ("setup", "window", "more", "release", "replay"):
        assert callable(getattr(drv, fn))
    e2e = harness.metrics_of(SPEC, workload, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = harness.metrics_of(SPEC, workload, "per_layer")
    assert layer
    for m in layer:
        assert callable(harness.reader(m["name"]).read)
        # the metric moves an end-to-end metric this cell reports
        assert m["moves"] in {e["name"] for e in e2e}


def test_a_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="metrics/no_such"):
        harness.reader("no_such")
    with pytest.raises(KeyError):
        harness.cell_files(SPEC, "no_such_cell")
