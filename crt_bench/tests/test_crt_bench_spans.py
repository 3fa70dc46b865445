"""The readers of the port's own spans (``crt_bench/spans.py``), on the
CPU: the device operations launched inside each ``ntsc.`` span and the
idle time by the span in flight, on a trace made by hand; and the
benchmark's other readers, which read the same with the port's spans in
the trace as without them."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from crt_bench import harness, spans, trace
from crt_bench.trace import Trace

SPEC = harness.load_spec()
# the per-layer metrics that read no program span
OTHERS = ("step_issue_ms.batch", "modulate_device_ms.batch",
          "demodulate_device_ms.batch", "decode_rows_roofline_pct.batch",
          "encode_rows_roofline_pct.batch", "device_idle_pct.batch")
CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, parent=None, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, id=id, cpu_parent=parent,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def hand_made_events(with_program_spans=True):
    """Two steps (0-45, 45-100 us).  The field span (0-20) launches a
    where at 5 (device 10-15) and, at 6, an operation that runs after the
    window; the encode span (20-40) launches K1 at 25 (30-45) and a copy
    at 26 (45-48); the decode span (50-70) launches K2 at 55 (60-80); a
    launch at 90, in no program span, runs at 95-99.  The profiler also
    draws the field span on the device's timeline (10-15)."""
    where = ev("aten::where", 4, 7)
    field = ev("ntsc.modulate.field", 0, 20)
    encode = ev("ntsc.modulate.encode", 20, 40)
    decode = ev("ntsc.demodulate.decode", 50, 70)
    events = [
        ev(trace.WINDOW, 0, 100), ev("crt_bench.step", 0, 45),
        ev("crt_bench.step", 45, 100), ev("crt_bench.modulate", 0, 40),
        ev("crt_bench.demodulate", 50, 70), where,
        ev("cudaLaunchKernel", 5, 6, id=1, parent=where),
        ev("cudaLaunchKernel", 6, 7, id=6, parent=where),
        ev("cudaLaunchKernel", 25, 26, id=2, parent=encode),
        ev("cudaMemcpyAsync", 26, 27, id=3, parent=encode),
        ev("cudaLaunchKernel", 55, 56, id=4, parent=decode),
        ev("cudaLaunchKernel", 90, 91, id=5),
        ev("where_kernel<signed char>", 10, 15, CUDA, 1),
        ev("where_kernel<signed char>", 150, 160, CUDA, 6),
        ev("void (anonymous namespace)::encode_rows_kernel<4>(int)", 30,
           45, CUDA, 2),
        ev("Memcpy DtoD (Device -> Device)", 45, 48, CUDA, 3),
        ev("void (anonymous namespace)::decode_rows_kernel<4>(int)", 60,
           80, CUDA, 4),
        ev("elementwise_kernel", 95, 99, CUDA, 5)]
    if with_program_spans:
        events += [field, encode, decode,
                   ev("ntsc.modulate.field", 10, 15, CUDA, 7,
                      annotation=True)]
    return events


def probe_of(events):
    probe = trace.Probe({}, torch.device("cpu"))
    probe.prof = types.SimpleNamespace(events=lambda: events)
    probe.t0 = 0.0
    return probe


def read(probe):
    _, conf, traffic = harness.cell_files(SPEC, "vhs_batch2048")
    return trace.read(probe, [(0, 45e-6), (45e-6, 100e-6)], [(0, 60e-6)],
                      1, [3.0, 5.0], dict(conf=conf, traffic=traffic))


def test_a_program_span_reads_the_work_launched_inside_it(capsys):
    probe = probe_of(hand_made_events())      # found up the call stack
    tr = read(probe)
    assert tr.steps == 2
    ms = {n: spans.program_span_device_ms(tr, n)
          for n in ("ntsc.modulate.field", "ntsc.modulate.encode",
                    "ntsc.demodulate.decode", "ntsc.demodulate.place")}
    assert ms == {"ntsc.modulate.field": pytest.approx(2.5e-3),
                  "ntsc.modulate.encode": pytest.approx(9e-3),
                  "ntsc.demodulate.decode": pytest.approx(10e-3),
                  "ntsc.demodulate.place": None}
    ops = spans.program(tr)
    assert [o[3] for o in ops["ntsc.modulate.encode"]] == [
        "encode_rows_kernel", "Memcpy DtoD"]
    assert [o[3] for o in ops["ntsc.modulate.field"]] == ["aten::where"]
    assert "aten::where 0.0025" in capsys.readouterr().err
    # gaps 0-10 and 15-30 start in the field span; 48-60, 80-95 and
    # 99-100 in none
    assert spans.idle_by_span(tr) == [["outside", pytest.approx(28e-6)],
                                      ["ntsc.modulate.field",
                                       pytest.approx(25e-6)]]


def test_nothing_to_read_without_the_probe_or_the_spans():
    made = Trace(device=[("k", 10, 15)], launched_in={}, spans={},
                 walls=[(0, 50)], wall_s_per_step=1e-4, steps=1,
                 issue_ms=[], cell={}, host_ops=[], window=(0, 50))
    assert spans.program(made) == {}
    assert spans.program_span_device_ms(made, "ntsc.modulate.field") is None
    assert spans.idle_by_span(made) == [["outside", pytest.approx(45e-6)]]
    probe = probe_of(hand_made_events(with_program_spans=False))
    tr = read(probe)
    assert spans.program(tr) == {}
    assert spans.program_span_device_ms(tr, "ntsc.modulate.field") is None


def others(tr):
    return {m: harness.reader(m).read(tr) for m in OTHERS}


def test_the_other_readers_read_the_same_with_the_program_spans():
    """On the hand-made trace, whose device timeline also draws a program
    span: no device operation, metric or breakdown line takes it in."""
    with_spans = read(probe_of(hand_made_events()))
    without = read(probe_of(hand_made_events(with_program_spans=False)))
    assert not any(n.startswith("ntsc.") for n, _, _ in with_spans.device)
    assert with_spans.device == without.device
    got = others(with_spans)
    assert got == others(without)
    assert got["modulate_device_ms.batch"] == pytest.approx(11.5e-3)
    assert trace.breakdown(with_spans)["device_ops"] == \
        trace.breakdown(without)["device_ops"]


def test_the_other_readers_read_the_same_on_a_recorded_cpu_trace():
    """A trace recorded on the CPU through the harness's probe, the steps
    opening the port's spans: the same trace with the spans taken out
    reads the same."""
    from ntsc_crt_tpu_torch.utils import profiling

    def stage(name):
        with profiling.span(name):
            return torch.arange(64).sum()

    def modulate():
        with profiling.span("modulate"):
            return stage("modulate.field") + stage("modulate.encode")

    def demodulate():
        with profiling.span("demodulate"):
            return stage("demodulate.decode")

    def step():
        with profiling.span("step"):
            return mod.modulate() + mod.demodulate()

    mod = types.SimpleNamespace(step=step, modulate=modulate,
                                demodulate=demodulate)
    recorded = trace.Probe({n: (mod, n) for n in ("step", "modulate",
                                                  "demodulate")},
                           torch.device("cpu"))
    recorded.begin()
    for _ in range(2):
        mod.step()
    recorded.finish()
    events = recorded.prof.events()
    assert {e.name for e in events if e.name.startswith("ntsc.")} == {
        "ntsc.step", "ntsc.modulate", "ntsc.modulate.field",
        "ntsc.modulate.encode", "ntsc.demodulate", "ntsc.demodulate.decode"}
    stubbed = probe_of([e for e in events if not e.name.startswith("ntsc.")])
    stubbed.t0 = recorded.t0
    walls = [(recorded.t0, recorded.t1)]
    trs = [trace.read(p, walls, walls, 1, [1.0], {})
           for p in (recorded, stubbed)]
    assert trs[0].steps == trs[1].steps == 2
    assert others(trs[0]) == others(trs[1])
