"""CUDA graphs of the frame step (``models/graphs.py``).

On the CPU: the key (a host-int knob of another value keeps it, a build
switch, a blend or a tensor knob changes it), the eager cases (CPU
tensors, an active profiler, an active line split), and a stand-in step
captured and replayed on a stand-in graph that records torch's ops and
replays them into the same tensors, as a CUDA graph would: the replay
against the same step run op by op, the fresh tensors of the eager calls,
the cloned small state, ``GRAPHS`` and the launch counts, and a capture
refused where a graph op reads the caller's field.

The tests marked `gpu` hold the replayed step to the step run op by op,
at 0 differing bytes and state words, over 6 steps with alternating
images and changing parities, at B 1, 3 and 64, on NTSC-VHS with
head switching, the bloom build with blend and scanlines, NES, PV1K
(5-sample chroma) and knobs as (B,) tensors; that a step leaves the
state of the steps before it alone; that a profiled step runs eager with
every stage span; and that a capture that fails runs eager.  No JAX here:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \\
        tests/test_torch_graphs.py -m gpu
"""

import contextlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import graphs, pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.modulate import _b
from ntsc_crt_tpu_torch.ops.kernels import build
from ntsc_crt_tpu_torch.parallel import spatial

torch.set_num_threads(1)  # the tier runs several workers on few cores

VHS = systems.NTSCVHS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh():
    graphs.reset()
    yield
    graphs.reset()


def step_kw(**kw):
    """A step's keywords as pipeline.step completes them."""
    return {**pipeline.step.__wrapped__.__kwdefaults__, **kw}


# --- the key -----------------------------------------------------------------


def small_state(B=2):
    return pipeline.init_batch(VHS, B, 8, 6, device="cpu")


def img_of(B=2):
    return torch.zeros((B, 4, 5, 3), dtype=torch.uint8)


def test_a_host_int_knob_of_another_value_keeps_the_key():
    st, img = small_state(), img_of()
    base = graphs.key(VHS, st, img, step_kw(noise=24))
    for kw in (dict(noise=3), dict(field=1, frame=1, hue=40),
               dict(noise=24, mon=MonitorParams(hue=7, contrast=10,
                                                saturation=3)),
               dict(noise=24, do_aberration=0, dot_crawl_offset=5)):
        assert graphs.key(VHS, st, img, step_kw(**kw)) == base, kw
    other = st._replace(hsync=st.hsync + 5, rn=st.rn * 3)
    assert graphs.key(VHS, other, img, step_kw(noise=24)) == base


CHANGES = {
    "do_bloom": dict(do_bloom=True), "eq_mode": dict(eq_mode="conv7"),
    "do_vsync": dict(do_vsync=False), "do_hsync": dict(do_hsync=False),
    "v_fac": dict(v_fac=4), "draw_border": dict(draw_border=True),
    "optimized": dict(optimized=False), "raw": dict(raw=True),
    "blend": dict(mon=MonitorParams(blend=1)),
    "scanlines": dict(mon=MonitorParams(scanlines=1)),
    "noise_tensor": dict(noise=torch.full((2,), 24, dtype=torch.int32)),
    "hue_tensor": dict(mon=MonitorParams(hue=torch.zeros(2,
                                                         dtype=torch.int32))),
}


@pytest.mark.parametrize("change", list(CHANGES.values()),
                         ids=list(CHANGES))
def test_a_build_switch_or_a_knob_kind_changes_the_key(change):
    st, img = small_state(), img_of()
    assert graphs.key(VHS, st, img, step_kw(**change)) != \
        graphs.key(VHS, st, img, step_kw(noise=24))


def test_the_batch_or_the_system_changes_the_key():
    kw = step_kw()
    base = graphs.key(VHS, small_state(), img_of(), kw)
    assert graphs.key(VHS, small_state(3), img_of(3), kw) != base
    assert graphs.key(systems.NTSC, small_state(), img_of(), kw) != base


# --- the eager cases ---------------------------------------------------------


def counted_body(calls):
    def body(cfg, state, img, **kw):
        calls.append(kw)
        return state
    return body


def test_cpu_tensors_run_eager_and_count():
    calls = []
    graphs.run(counted_body(calls), VHS, small_state(), img_of(), step_kw())
    assert len(calls) == 1
    assert graphs.GRAPHS == {"eager_cpu": 1}
    assert graphs.eager_reason(small_state()) == "cpu"
    assert pipeline.step.__wrapped__.__name__ == "step"
    assert pipeline.GRAPHS is graphs.GRAPHS


def test_an_active_profiler_runs_eager():
    calls = []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert graphs.eager_reason(small_state()) == "profiler"
        graphs.run(counted_body(calls), VHS, small_state(), img_of(),
                   step_kw())
    assert graphs.GRAPHS == {"eager_profiler": 1} and len(calls) == 1


def test_an_active_line_split_runs_eager():
    calls = []
    with spatial.line_sharding(["cpu", "cpu"]):
        assert graphs.eager_reason(small_state()) == "spatial"
        graphs.run(counted_body(calls), VHS, small_state(), img_of(),
                   step_kw())
    assert graphs.GRAPHS == {"eager_spatial": 1} and len(calls) == 1
    with spatial.line_sharding(["cpu"]):        # a group of one: no split
        assert graphs.eager_reason(small_state()) == "cpu"


# --- a stand-in step on a stand-in graph -------------------------------------


class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, args, kwargs or {}, out))
        return out


class StandInGraph:
    """torch.cuda.CUDAGraph's part in graphs.py, on the CPU: capture records
    each torch op as it runs; a replay runs them again into the tensors the
    capture made (the first replay, straight after the capture, has nothing
    left to do).  View ops alias, empty tensors are left as they are."""
    replays = 0

    def __init__(self):
        self.ops, self.done = [], True

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.mode = _Record(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        if self.done:
            self.done = False
            return
        StandInGraph.replays += 1
        for func, args, kwargs, out in self.ops:
            if func.is_view or func in graphs._NO_DATA:
                continue
            got = func(*args, **kwargs)
            for o, g in zip(tree_leaves(out), tree_leaves(got)):
                if torch.is_tensor(o) and o is not g:
                    o.copy_(g)


@pytest.fixture
def stand_in_card(monkeypatch):
    """graphs.py's CUDA calls on the CPU: the stand-in graph, no streams,
    no reason to run eager."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(graphs, "eager_reason", lambda state: None)
    StandInGraph.replays = 0


def _field(analog, img, t):
    build.LAUNCHES["field"] += 1
    return analog + t[:, None, None] + img.sum(dim=(1, 2, 3),
                                               dtype=torch.int8)[:, None, None]


def _noise(x, rn, out=None):
    build.LAUNCHES["noise"] += 1
    got = (x.sum(dim=1, dtype=torch.int32), rn * 3 + 1)
    if out is None:
        return got
    for o, g in zip(out, got):
        o.copy_(g)
    return out


def _place(out_prev, line):
    build.LAUNCHES["place"] += 1
    return out_prev + line.to(torch.uint8)[:, None, None, None]


def stand_in_step(cfg, state, img, *, field, noise, mon, reads=False, **_):
    """A step's shape: graph ops on the knobs and the small state, a kernel
    launched inside a graph, and the three eager calls; `reads` puts a read
    of the caller's field in a graph."""
    build.LAUNCHES["table"] += 1
    B, dev = state.analog.shape[0], state.analog.device
    noise = _b(noise, B, dev)
    t = (_b(field, B, dev) * 3 + noise + _b(mon.hue, B, dev)).to(torch.int8)
    if reads:
        t = t + state.analog[:, 0, 0]
    analog = graphs.eager(_field, state.analog, img, t)
    # a view at an offset of the eager call's fresh field
    line, rn = graphs.eager(_noise, analog.view(analog.shape[0], -1)[:, 2:],
                            state.rn, keep=(0, 1))
    line = line + state.hsync
    out = graphs.eager(_place, state.out, line)
    return state._replace(analog=analog, out=out, hsync=line, rn=rn + 1,
                          vsync=state.vsync + noise)


def stand_in_inputs(i, B=3, tensors=False):
    g = torch.Generator().manual_seed(i)
    img = torch.randint(0, 256, (B, 4, 5, 3), generator=g, dtype=torch.uint8)
    if tensors:
        return img, dict(field=torch.arange(B) % 2 + i, noise=torch.arange(
            B, dtype=torch.int32) * i, mon=MonitorParams(
                hue=torch.full((B,), i, dtype=torch.int64)))
    return img, dict(field=i % 2, noise=5 * i, mon=MonitorParams(hue=i))


@pytest.mark.parametrize("tensors", [False, True], ids=["ints", "tensors"])
def test_a_stand_in_step_replays_as_it_runs_op_by_op(stand_in_card,
                                                     tensors):
    kw = step_kw()
    st_g = st_e = pipeline.init_batch(VHS, 3, 8, 6, device="cpu")
    step = graphs.graphed(stand_in_step)
    counts = []
    for i in range(5):
        img, k = stand_in_inputs(i, tensors=tensors)
        before = [x.clone() for x in st_g]
        build.LAUNCHES.clear()
        new_g = step(VHS, st_g, img, **{**kw, **k})
        counts.append(dict(build.LAUNCHES))
        build.LAUNCHES.clear()
        st_e = stand_in_step(VHS, st_e, img, **{**kw, **k})
        assert dict(build.LAUNCHES) == counts[-1], i
        for name, g, e in zip(st_e._fields, new_g, st_e):
            assert torch.equal(g, e), (i, name)
        for name, b, x in zip(st_g._fields, before, st_g):
            assert torch.equal(b, x), f"step {i} wrote the caller's {name}"
        st_g = new_g
    assert graphs.GRAPHS == {"eager_first": 1, "captures": 1, "replays": 3}
    assert counts[0] == dict(table=1, field=1, noise=1, place=1)
    assert all(c == counts[0] for c in counts)
    plan = next(iter(graphs._CACHE.values()))
    assert plan.launches == {"table": 1}       # counted at capture
    # a graph before and after each eager call; none where no op runs
    # between two (the field's view is not an op)
    assert len(plan.graphs) == 4 and plan.graphs[1] is None
    assert len(plan.empty) == 1     # held: its pool outlives it otherwise
    assert StandInGraph.replays == 3 * 3
    # the returned small state is the caller's own, not a graph's
    assert not any(x is y for x, y in zip(new_g[2:], plan.outputs[2:]))


def test_a_graph_op_on_the_callers_field_refuses_the_capture(stand_in_card):
    kw = step_kw(reads=True)
    st = pipeline.init_batch(VHS, 3, 8, 6, device="cpu")
    step = graphs.graphed(stand_in_step)
    for i in range(3):
        img, k = stand_in_inputs(i)
        build.LAUNCHES.clear()
        got = step(VHS, st, img, **{**kw, **k})
        assert dict(build.LAUNCHES) == dict(table=1, field=1, noise=1,
                                            place=1)
        want = stand_in_step(VHS, st, img, **{**kw, **k})
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        st = got
    assert graphs.GRAPHS == {"eager_first": 1, "eager_failed": 2}
    (reason,) = graphs.FAILURES.values()
    assert "the caller's analog" in reason


def test_the_kept_outputs_go_into_out_on_the_cpu_too():
    """K11's and K13's wrappers write into the buffers a graph keeps
    (graphs.eager's keep) on either path."""
    from ntsc_crt_tpu_torch.models import modulate
    from ntsc_crt_tpu_torch.ops.kernels import noise
    x = torch.arange(-60, 60, dtype=torch.int8).reshape(2, 60)
    one = torch.ones(2, dtype=torch.int32)
    args = (x, one[:1].repeat(50), one[:1].repeat(50) * 3, one * 7, one * 40)
    kw = dict(shift=16, ga=5, gc=3)
    out = (torch.empty_like(x), torch.empty_like(one))
    want = noise.inject_noise(*args, **kw)
    got = noise.inject_noise(*args, **kw, out=out)
    assert got is out and all(torch.equal(g, w) for g, w in zip(got, want))
    cfg = systems.NES
    st = pipeline.init_batch(cfg, 2, 8, 6, device="cpu")
    ppu = torch.randint(0, 512, (2, 240, 256), dtype=torch.int32).to(
        torch.uint16)
    calls = []

    def keep_args(fn, *a, keep=(), **k):
        calls.append((a, k))
        return fn(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "eager", keep_args)
        modulate.modulate_nes(cfg, st.analog, ppu, hue=3, dot_crawl_offset=1)
    (a, k), = calls
    ccf = torch.full((2, cfg.cc_vper, cfg.cc_samples), -1, dtype=torch.int32)
    field, got = modulate._nes_field(*a, **k, out=(None, ccf))
    want = modulate._nes_field(*a, **k)
    assert got is ccf and torch.equal(got, want[1])
    assert torch.equal(field, want[0])


def test_keys_beyond_the_limit_drop_the_oldest(stand_in_card):
    st = pipeline.init_batch(VHS, 3, 8, 6, device="cpu")
    step = graphs.graphed(stand_in_step)
    img, k = stand_in_inputs(0)
    for v in range(graphs.MAX_KEYS + 1):
        step(VHS, st, img, **step_kw(v_fac=v, **k))
    assert len(graphs._CACHE) == graphs.MAX_KEYS
    assert not any(dict(key[-1]).get("v_fac") == 0 for key in graphs._CACHE)


# --- on the card -------------------------------------------------------------


CASES = {
    "vhs": (VHS, dict(noise=24, do_aberration=1)),
    "bloom": (systems.NTSC, dict(noise=24, do_bloom=True, mon=MonitorParams(
        blend=1, scanlines=1, saturation=10))),
    "nes": (systems.NES, dict(noise=12)),
    "pv1k": (systems.PV1K, dict(noise=12)),
    "tensor_knobs": (VHS, None),
}


def card_images(cfg, B, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if cfg.kind == "nes":
        return torch.randint(0, 512, (B, 240, 256), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint16)
    return torch.randint(0, 256, (B, 480, 640, 3), generator=g, device=dev,
                         dtype=torch.uint8)


def card_kw(case, B, i, dev):
    """Step i's keywords: the converter's parities from each slot's own
    offset, the dot crawl, an int knob that changes every step (or, for
    `tensor_knobs`, every knob a (B,) tensor)."""
    s = torch.arange(B, device=dev, dtype=torch.int32) + i
    kw = dict(field=s % 2, frame=(s // 2) % 2, dot_crawl_offset=s % 3)
    if case == "tensor_knobs":
        return dict(kw, noise=(s * 7) % 40, do_aberration=s % 2,
                    hue=s * 11, mon=MonitorParams(
                        hue=s * 5, brightness=s % 4 - 2, contrast=180 - s,
                        saturation=10 + s % 3, black_point=s % 2,
                        white_point=100 - s % 5))
    kw.update(CASES[case][1], hue=7 * i)
    kw["mon"] = kw.get("mon", MonitorParams(saturation=10))._replace(
        brightness=i)
    return kw


def same_state(got, want, tag):
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), \
            f"{tag} {name}: {int((g != w).sum())} elements differ"


def replay_against_eager(cfg, case, B, dev, steps=6):
    imgs = [card_images(cfg, B, dev, s) for s in (1, 2)]
    st_g = st_e = pipeline.init_batch(cfg, B, 640, 480, device=dev)
    for i in range(steps):
        kw = card_kw(case, B, i, dev)
        build.LAUNCHES.clear()
        st_g = pipeline.step(cfg, st_g, imgs[i % 2], **kw)
        got = dict(build.LAUNCHES)
        build.LAUNCHES.clear()
        st_e = pipeline.step.__wrapped__(cfg, st_e, imgs[i % 2], **kw)
        assert got == dict(build.LAUNCHES), f"step {i}"
        torch.cuda.synchronize()
        same_state(st_g, st_e, f"{case} B {B} step {i}")
    return st_g


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_the_replayed_step_matches_the_step_op_by_op(cuda, case, B):
    replay_against_eager(CASES[case][0], case, B, cuda)
    assert graphs.GRAPHS == {"eager_first": 1, "captures": 1,
                             "replays": 4}, (graphs.GRAPHS, graphs.FAILURES)


@pytest.mark.gpu
def test_a_step_leaves_the_state_before_it_alone(cuda):
    imgs = [card_images(VHS, 3, cuda, s) for s in (1, 2)]
    st = pipeline.init_batch(VHS, 3, 640, 480, device=cuda)
    for i in range(5):
        new = pipeline.step(VHS, st, imgs[i % 2], **card_kw("vhs", 3, i,
                                                              cuda))
        kept = [x.clone() for x in new]
        pipeline.step(VHS, new, imgs[(i + 1) % 2],
                      **card_kw("vhs", 3, i + 1, cuda))
        torch.cuda.synchronize()
        for name, k, x in zip(new._fields, kept, new):
            assert torch.equal(k, x), \
                f"step {i + 1} changed step {i}'s {name}"
        st = new
    assert graphs.GRAPHS["replays"] >= 6


@pytest.mark.gpu
def test_a_profiled_step_runs_eager_with_every_span(cuda):
    from torch.profiler import ProfilerActivity, profile
    st = replay_against_eager(VHS, "vhs", 3, cuda, steps=3)
    img = card_images(VHS, 3, cuda, 1)
    kw = card_kw("vhs", 3, 3, cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = pipeline.step(VHS, st, img, **kw)
        torch.cuda.synchronize()
    assert graphs.GRAPHS["eager_profiler"] == 1
    names = {e.name for e in prof.events()}
    spans = {"ntsc.step", "ntsc.modulate", "ntsc.modulate.field",
             "ntsc.modulate.encode", "ntsc.demodulate"} | {
        f"ntsc.demodulate.{s}" for s in ("noise", "vsync", "line_scan",
                                        "decode", "place")}
    assert spans <= names, spans - names
    same_state(got, pipeline.step.__wrapped__(VHS, st, img, **kw), "traced")


def _syncing(fn):
    def call(*a, **k):
        out = fn(*a, **k)
        int(out[0][0])                      # reads a value on the host
        return out
    return call


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["sync", "reads_the_field"])
def test_a_capture_that_fails_runs_eager(cuda, monkeypatch, how):
    kw = {}
    if how == "sync":
        monkeypatch.setattr(dem, "_find_vsync", _syncing(dem._find_vsync))
    else:
        kw = dict(do_vsync=False, do_hsync=False)  # vsync from the fresh field
    imgs = [card_images(VHS, 3, cuda, s) for s in (1, 2)]
    st_g = st_e = pipeline.init_batch(VHS, 3, 640, 480, device=cuda)
    for i in range(4):
        k = dict(card_kw("vhs", 3, i, cuda), **kw)
        st_g = pipeline.step(VHS, st_g, imgs[i % 2], **k)
        st_e = pipeline.step.__wrapped__(VHS, st_e, imgs[i % 2], **k)
        torch.cuda.synchronize()
        same_state(st_g, st_e, f"{how} step {i}")
    assert graphs.GRAPHS == {"eager_first": 1, "eager_failed": 3}
    (reason,) = graphs.FAILURES.values()
    assert reason
    monkeypatch.undo()
    graphs.reset()
    replay_against_eager(VHS, "vhs", 3, cuda, steps=4)
    assert graphs.GRAPHS["replays"] == 2, graphs.FAILURES
