"""The port's stage spans (``utils/profiling.py`` ``span``) on the CPU.

Under torch.profiler each step records ``ntsc.step``, which holds
``ntsc.modulate`` and ``ntsc.demodulate``, which hold their stages in
order, once a step (VHS's ``ntsc.modulate.field`` twice: the field, then
the sync kill), each nested in its parent by the event's ``cpu_parent``.
With no profiler no range is entered, and the spans change nothing the
step computes.

The kernels' plain versions on the CPU run as thousands of small torch
ops (K5's march alone some 200,000 at a VHS field's size), and the
profiler's parse of them takes a minute: under the profiler each kernel
replays the result of the unprofiled run for the same inputs, which it
computes anew where the inputs differ.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.ops.kernels import ccf, decode, encode, hsync, vhs
from ntsc_crt_tpu_torch.utils import profiling

torch.set_num_threads(1)  # the tier runs several workers on few cores

ROOT = Path(__file__).resolve().parents[1]
DEMODULATE = ["noise", "vsync", "line_scan", "decode", "place"]
MODULATE = {"NTSCVHS": ["field", "encode"],
            "NTSC": ["field", "encode"], "NES": ["encode"]}


def _key(x):
    if torch.is_tensor(x):
        return str(x.dtype), tuple(x.shape), x.numpy().tobytes()
    if isinstance(x, (tuple, list)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    return repr(x)


def _replayed(fn):
    """fn, its result kept by its inputs' bytes and given back for the
    same inputs."""
    seen = {}

    def call(*a, **k):
        key = _key((a, k))
        if key not in seen:
            seen[key] = fn(*a, **k)
        return seen[key]
    return call


@pytest.fixture
def replay(monkeypatch):
    for mod, name in ((encode, "encode_rows"), (decode, "decode_rows"),
                      (hsync, "hsync_chase"), (ccf, "ccf_ema"),
                      (vhs, "vhs_region_b_entries")):
        monkeypatch.setattr(mod, name, _replayed(getattr(mod, name)))


def _inputs(cfg, steps, B=2):
    rng = np.random.default_rng(len(cfg.name))
    if cfg.kind == "nes":
        imgs = rng.integers(0, 512, (steps, B, 24, 32), dtype=np.uint16)
    else:
        imgs = rng.integers(0, 256, (steps, B, 24, 32, 3), dtype=np.uint8)
    return [(torch.as_tensor(img), *(torch.tensor([i, i + 1],
                                                  dtype=torch.int32)
                                     for _ in range(3)))
            for i, img in enumerate(imgs)]


def _run(cfg, steps):
    """The states after each of `steps` steps of B 2 slots at 64x48."""
    st = pipeline.init_batch(cfg, 2, 64, 48, device="cpu")
    out = []
    for args in _inputs(cfg, steps):
        st = pipeline.step_batch(cfg, st, *args, noise=12)
        out.append(st)
    return out


def _children(event, names):
    return [c.name for c in sorted(event.cpu_children,
                                   key=lambda c: c.time_range.start)
            if c.name in names]


@pytest.mark.parametrize("name", sorted(MODULATE))
def test_spans_nest_as_the_step_does_and_change_nothing(name, replay):
    cfg = systems.SYSTEMS[name]
    plain = _run(cfg, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _run(cfg, 2)
    for a, b in zip(plain, traced):
        for k in a._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    spans = [e for e in prof.events() if e.name.startswith("ntsc.")]
    mod = ["ntsc.modulate." + s for s in MODULATE[name]]
    dem = ["ntsc.demodulate." + s for s in DEMODULATE]
    steps = [e for e in spans if e.name == "ntsc.step"]
    assert len(steps) == 2
    assert len(spans) == 2 * (3 + len(mod) + len(dem))
    names = {e.name for e in spans}
    for step in steps:
        assert step.cpu_parent is None or \
            not step.cpu_parent.name.startswith("ntsc.")
        assert _children(step, names) == ["ntsc.modulate", "ntsc.demodulate"]
        for half, stages in zip(
                sorted((c for c in step.cpu_children if c.name in names),
                       key=lambda c: c.time_range.start), (mod, dem)):
            assert half.cpu_parent is step
            assert _children(half, names) == stages
            for c in half.cpu_children:
                if c.name in names:
                    assert c.cpu_parent is half
                    assert half.time_range.start <= c.time_range.start
                    assert c.time_range.end <= half.time_range.end


def test_no_range_is_entered_without_a_profiler(monkeypatch, replay):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    _run(systems.NTSC, 1)
    with profiling.span("x"):
        pass
    # the same call under a profiler does enter it
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered"):
            profiling.span("x")


def test_a_traced_cpu_step_never_imports_the_kernel_build():
    code = (
        "import sys, torch\n"
        "from torch.profiler import ProfilerActivity, profile\n"
        "from ntsc_crt_tpu_torch.models import pipeline, systems\n"
        "cfg = systems.NTSC\n"
        "st = pipeline.init_batch(cfg, 1, 64, 48, device='cpu')\n"
        "img = torch.zeros((1, 24, 32, 3), dtype=torch.uint8)\n"
        "z = torch.zeros(1, dtype=torch.int32)\n"
        "with profile(activities=[ProfilerActivity.CPU]):\n"
        "    pipeline.step_batch(cfg, st, img, z, z, z, noise=12)\n"
        "assert 'ntsc_crt_tpu_torch.ops.kernels.build' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
