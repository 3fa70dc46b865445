"""CUDA graphs of the frame step (``pipeline.step``).

On a CUDA card a step issues a few hundred small launches: the (B,) and
(B, L) torch ops around the kernels, the vsync search and the line scan,
VHS's noise draws, the kernels between.  `run` captures them as CUDA
graphs (``torch.cuda.CUDAGraph``) on a key's second call and replays them
on every later one.  The calls that read or write the caller's frame-sized
tensors stay eager: those tensors change address from call to call, and
copying them in and out would cost more than a graph saves.  Each is made
through `eager`, which under a capture ends the graph, runs the call and
records it, to be made again between the graphs' replays with the next
call's own tensors:

* the modulator's field: K1's field mode (the NTSC family), K13 (NES), or
  the skeleton, burst and K1 block of the other RGB encoders.  It reads
  the caller's image and field and writes the fresh field that the step
  returns;
* K11, which reads that field and writes the noisy field into a buffer the
  graphs keep (``keep``: on a replay the call writes into the outputs it
  returned at capture, passed as ``out``);
* the row placement (K6), which reads the lines the graphs decoded and the
  caller's previous output, and writes the fresh output that the step
  returns.

A replay fills the key's static inputs (the state's small tensors, `SMALL`,
by ``copy_``; each knob, `KNOBS` and `MON_KNOBS`, by ``fill_`` from a host
int or ``copy_`` from a tensor), replays a graph, makes an eager call,
replays the next graph and so on, then clones the small state that the
graphs wrote, so that no tensor it returns is overwritten by a later call.

The key (`key`) holds the configuration; the shapes, dtypes, strides and
devices of the inputs; whether each knob is a tensor; the build switches;
and blend and scanlines where they are host ints, since they pick K6's
template.  No other knob's value enters it.  A key's first call runs
eager, its second captures, later ones replay; `MAX_KEYS` keys are kept,
the least recently used dropped first.

The step runs eager (`eager_reason`) under a profiler (the ``ntsc.``
spans need each op's own launching call), inside a
``spatial.line_sharding`` group, on CPU tensors, and for a key whose
capture failed.  A capture fails where a graph's op would touch a caller's
frame-sized tensor or an eager call's fresh output (checked at capture,
for torch's ops and for the kernels' launches), or where CUDA refuses an
op while capturing (a synchronize).  `GRAPHS` counts captures, replays and
each eager reason (``eager_<reason>``); `FAILURES` holds each failed key's
reason.  ``build.LAUNCHES`` counts a replay's launches as the eager step
would: each replay adds those counted while its graphs were captured.
"""

from __future__ import annotations

import collections
import functools
import inspect
import threading
import traceback
import warnings
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ntsc_crt_tpu_torch.ops.fixedpoint import host_i32, i32
from ntsc_crt_tpu_torch.parallel import spatial

# the step's keywords that reach the step only through modulate._b: a
# static (B,) int32 input each
KNOBS = ("field", "frame", "hue", "noise", "as_color", "dot_crawl_offset",
         "do_aberration", "border_color")
# MonitorParams' fields read through _b; blend and scanlines pick K6's
# template as host ints: such an int enters the key, a tensor is a static
# input
MON_KNOBS = ("hue", "brightness", "contrast", "saturation", "black_point",
             "white_point")
PLACE_KNOBS = ("blend", "scanlines")
# the state's small tensors: static inputs, cloned out of the graphs
SMALL = ("ccf", "hsync", "vsync", "rn", "randstate")
MAX_KEYS = 8

GRAPHS: collections.Counter = collections.Counter()
FAILURES: dict = {}
_CACHE: collections.OrderedDict = collections.OrderedDict()
_SEEN, _FAILED = "seen", "failed"
_local = threading.local()
# ops that read no element of their tensor arguments
_NO_DATA = {torch.ops.aten.empty_like.default,
            torch.ops.aten.new_empty.default,
            torch.ops.aten.new_empty_strided.default}


class Uncapturable(Exception):
    """A graph's op would touch a tensor that changes from call to call."""


def is_host_int(x) -> bool:
    return isinstance(x, (int, np.integer))


def eager(fn: Callable, *args, keep: tuple = (), **kw):
    """fn(*args, **kw): a call that reads or writes a caller's frame-sized
    tensor.  Under a capture it ends the graph, runs, and is recorded to be
    made again after that graph on each replay.  `keep`: the positions of
    fn's outputs that later graph ops read; fn then takes ``out=`` (a tuple
    like its return value, None where an output is fresh) and writes those
    outputs there on a replay."""
    cap = getattr(_local, "capture", None)
    if cap is None:
        return fn(*args, **kw)
    return cap.hole(fn, args, kw, keep)


def graphed(step_fn: Callable) -> Callable:
    """step_fn(cfg, state, img, **kw) called through `run`, its keywords
    completed by their defaults; step_fn stays reachable as ``__wrapped__``
    (the step run op by op)."""
    defaults = {k: p.default for k, p in
                inspect.signature(step_fn).parameters.items()
                if p.kind is p.KEYWORD_ONLY}

    @functools.wraps(step_fn)
    def step(cfg, state, img, **kw):
        return run(step_fn, cfg, state, img, {**defaults, **kw})
    return step


def eager_reason(state) -> Optional[str]:
    """Why a step on `state` runs eager, from what the call shows, or None
    where it may replay."""
    if torch.autograd._profiler_enabled():
        return "profiler"
    if spatial.active():
        return "spatial"
    if state.analog.device.type != "cuda":
        return "cpu"
    return None


def _monitor(kw: dict):
    from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
    return kw.get("mon") or MonitorParams()


def key(cfg, state, img, kw: dict) -> tuple:
    """What a capture holds fixed: the configuration; the shapes, dtypes and
    devices of the image and the state, and the strides of the image and
    the frame-sized state (the small state is copied); whether each knob is a
    tensor; blend and scanlines where they are host ints; every other
    keyword's value (the build switches)."""
    def geo(t):
        return tuple(t.shape), t.dtype, t.device

    def frame(t):
        return geo(t) + (t.stride(),)

    def kind(x):
        return "int" if is_host_int(x) else "tensor"

    mon = _monitor(kw)
    return (cfg, frame(img), frame(state.analog), frame(state.out),
            tuple(geo(getattr(state, n)) for n in SMALL),
            tuple((n, kind(kw[n])) for n in KNOBS),
            tuple((n, kind(getattr(mon, n))) for n in MON_KNOBS),
            tuple((n, int(getattr(mon, n)) if is_host_int(getattr(mon, n))
                   else "tensor") for n in PLACE_KNOBS),
            tuple(sorted((n, v) for n, v in kw.items()
                         if n not in KNOBS and n != "mon")))


def run(step_fn: Callable, cfg, state, img, kw: dict):
    """step_fn(cfg, state, img, **kw), replayed as CUDA graphs where the
    call allows it (module docstring)."""
    reason = eager_reason(state)
    if reason is not None:
        GRAPHS["eager_" + reason] += 1
        return step_fn(cfg, state, img, **kw)
    k = key(cfg, state, img, kw)
    entry = _CACHE.get(k)
    if entry is None:
        _CACHE[k] = _SEEN
        while len(_CACHE) > MAX_KEYS:
            _CACHE.popitem(last=False)
        GRAPHS["eager_first"] += 1
        return step_fn(cfg, state, img, **kw)
    _CACHE.move_to_end(k)
    if entry is _FAILED:
        GRAPHS["eager_failed"] += 1
        return step_fn(cfg, state, img, **kw)
    if entry is _SEEN:
        return _capture(k, step_fn, cfg, state, img, kw)
    GRAPHS["replays"] += 1
    return entry.replay(state, img, kw)


def _capture(k, step_fn, cfg, state, img, kw):
    """The key's capture, made on its second call; the call's result, or
    the eager step's where the capture fails."""
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only
    counted = collections.Counter(build.LAUNCHES)
    plan = Plan(state, kw)
    try:
        out = plan.capture(step_fn, cfg, state, img, kw)
    except Exception as e:  # noqa: BLE001 - any failure falls back
        build.LAUNCHES.clear()
        build.LAUNCHES.update(counted)
        # the innermost frame of the step's own code names the op
        tb = traceback.extract_tb(e.__traceback__)
        own = [f for f in tb if "ntsc_crt_tpu_torch" in f.filename
               and Path(f.filename).name != "graphs.py"]
        where = (own or tb)[-1]
        FAILURES[k] = (f"{type(e).__name__} at {Path(where.filename).name}:"
                       f"{where.lineno}: {e}")[:400]
        _CACHE[k] = _FAILED
        GRAPHS["eager_failed"] += 1
        return step_fn(cfg, state, img, **kw)
    _CACHE[k] = plan
    GRAPHS["captures"] += 1
    return out


def reset() -> None:
    """Drop every captured key, failure and count."""
    _CACHE.clear()
    FAILURES.clear()
    GRAPHS.clear()


# --- a key's static inputs ---------------------------------------------------


def _put(buf: torch.Tensor, x) -> None:
    """A knob into its (B,) int32 buffer, as modulate._b would make it."""
    if is_host_int(x):
        buf.fill_(host_i32(x))
    else:
        buf.copy_(torch.broadcast_to(i32(x, device=buf.device), buf.shape))


class Inputs:
    """A key's static inputs: a buffer for each of the state's small
    tensors, and a (B,) int32 buffer for each knob (blend and scanlines
    only where they are tensors)."""

    def __init__(self, state, kw: dict):
        dev = state.analog.device
        B = state.analog.shape[0] if state.analog.ndim == 3 else 1
        mon = _monitor(kw)
        self.small = {n: torch.empty(getattr(state, n).shape,
                                     dtype=getattr(state, n).dtype,
                                     device=dev) for n in SMALL}
        self.knobs = {n: torch.empty(B, dtype=torch.int32, device=dev)
                      for n in KNOBS}
        self.mon = {n: torch.empty(B, dtype=torch.int32, device=dev)
                    for n in MON_KNOBS + PLACE_KNOBS
                    if n in MON_KNOBS or not is_host_int(getattr(mon, n))}

    def fill(self, state, kw: dict) -> None:
        """This call's values into the buffers."""
        mon = _monitor(kw)
        for n, buf in self.small.items():
            buf.copy_(getattr(state, n))
        for n, buf in self.knobs.items():
            _put(buf, kw[n])
        for n, buf in self.mon.items():
            _put(buf, getattr(mon, n))

    def step_args(self, state, kw: dict):
        """The step's state and keywords with the buffers in place of the
        caller's small tensors and knobs."""
        return (state._replace(**self.small),
                dict(kw, **self.knobs, mon=_monitor(kw)._replace(**self.mon)))


# --- what an eager call reads from the call's own tensors --------------------


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Ref(NamedTuple):
    """A view of one of the call's own frame-sized tensors: the caller's
    ("img", "analog", "out") or an eager call's fresh output ((call,
    output)), the offset counted from that tensor's own."""
    src: object
    shape: tuple
    stride: tuple
    offset: int

    def bind(self, sources: dict) -> torch.Tensor:
        t = sources[self.src]
        if (not self.offset and tuple(t.shape) == self.shape
                and t.stride() == self.stride):
            return t
        return t.as_strided(self.shape, self.stride,
                            t.storage_offset() + self.offset)


def _bind(x, sources: dict):
    """x with every Ref replaced by its view of this call's tensors."""
    if type(x) is Ref:
        return x.bind(sources)
    if type(x) in (tuple, list):
        return type(x)(_bind(v, sources) for v in x)
    if type(x) is dict:
        return {k: _bind(v, sources) for k, v in x.items()}
    return x


def _outputs(out) -> tuple:
    return out if type(out) is tuple else (out,)


def _fresh(index: int, out, keep: tuple):
    """((call, output), tensor) of each fresh tensor an eager call
    returned."""
    return [((index, j), t) for j, t in enumerate(_outputs(out))
            if j not in keep and torch.is_tensor(t)]


class Call:
    """An eager call between two graphs: its function, its arguments with
    Refs for the call's own tensors, and the outputs it keeps (None where
    it keeps none)."""

    def __init__(self, index: int, fn: Callable, args, kw: dict,
                 keep: tuple, kept: Optional[tuple]):
        self.index, self.fn, self.args, self.kw = index, fn, args, kw
        self.keep, self.kept = keep, kept

    def __call__(self, sources: dict) -> None:
        kw = _bind(self.kw, sources)
        if self.kept is not None:
            kw["out"] = self.kept
        out = self.fn(*_bind(self.args, sources), **kw)
        sources.update(_fresh(self.index, out, self.keep))


# --- capture -----------------------------------------------------------------


class _Guard(TorchDispatchMode):
    """Fails a capture where a graph's op would read or write one of the
    call's own tensors (view ops only alias them)."""

    def __init__(self, capture):
        super().__init__()
        self.capture = capture

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # a mode's __torch_dispatch__ is otherwise wrapped to skip dynamo,
        # whose first use imports it: seconds of a capture's time
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not (func.is_view or func in _NO_DATA):
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    self.capture.refuse(str(func), _ptr(t))
            self.capture.ops += 1
        return func(*args, **kwargs)


def _what(src) -> str:
    if isinstance(src, str):
        return f"the caller's {src}"
    return f"output {src[1]} of eager call {src[0]}"


class Capture:
    """A step's capture under way: the graphs so far (None for one that
    captured no work) and the eager calls between them.  Each graph is
    replayed as soon as it is captured, so that the eager call after it
    reads real values and the capturing call returns the step's result."""

    def __init__(self, dev: torch.device, sources: dict):
        self.dev = dev
        self.sources: dict = {}
        self.ranges: list = []      # (first byte, end, source), newest last
        self._own(sources.items())
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        self.graphs: list = []
        self.calls: list = []
        # graphs that captured no work, held: the last graph of a pool to
        # die frees the pool, which later captures still use
        self.empty: list = []
        self.launches: collections.Counter = collections.Counter()
        self.graph = None
        self._stream = self._guard = None

    def _own(self, sources) -> None:
        """Mark each (source, tensor)'s storage as the call's own: no graph
        op may touch it, and an eager call binds it anew each call."""
        for src, t in sources:
            self.sources[src] = t
            p = _ptr(t)
            if p:
                self.ranges.append((p, p + t.untyped_storage().nbytes(),
                                    src))

    def source(self, p) -> object:
        """The call's own tensor that byte address p lies in, or None."""
        for lo, hi, src in reversed(self.ranges):
            if p is not None and lo <= p < hi:
                return src
        return None

    def refuse(self, what: str, p) -> None:
        src = self.source(p)
        if src is not None:
            raise Uncapturable(f"{what} in a graph touches {_what(src)}")

    def check_launch(self, name: str, pointers) -> None:
        """build.launch's check of a kernel launched into a graph."""
        for p in pointers:
            self.refuse(name, p)

    def begin(self) -> None:
        from ntsc_crt_tpu_torch.ops.kernels import build
        self.before = collections.Counter(build.LAUNCHES)
        self.ops = 0
        self.graph = torch.cuda.CUDAGraph()
        self._guard = None
        self._stream = torch.cuda.stream(self.stream)
        self._stream.__enter__()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")
        # guarded after capture_begin: its own tensor ops are not the step's
        self._guard = _Guard(self)
        self._guard.__enter__()
        build.capture_check = self.check_launch

    def _finish(self, g) -> None:
        """End g's capture: the guard, then the capture, then the stream."""
        from ntsc_crt_tpu_torch.ops.kernels import build
        build.capture_check = None
        try:
            if self._guard is not None:
                self._guard.__exit__(None, None, None)
                self._guard = None
            with warnings.catch_warnings():
                # a graph with no work is expected, and dropped by end()
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                g.capture_end()
        finally:
            self._stream.__exit__(None, None, None)

    def end(self) -> None:
        from ntsc_crt_tpu_torch.ops.kernels import build
        g, self.graph = self.graph, None
        self._finish(g)
        delta = build.LAUNCHES - self.before
        self.launches.update(delta)
        if self.ops or delta:
            g.replay()
            self.graphs.append(g)
        else:
            self.graphs.append(None)
            self.empty.append(g)

    def close(self) -> None:
        """End a capture that an exception left open."""
        if self.graph is None:
            return
        g, self.graph = self.graph, None
        try:
            self._finish(g)
        except Exception:  # noqa: BLE001 - the capture is dropped anyway
            pass

    def hole(self, fn: Callable, args, kw: dict, keep: tuple):
        """An eager call: end the graph, template the arguments, run it."""
        self.end()
        index = len(self.calls)
        targs, tkw = self._template(args), self._template(kw)
        out = fn(*args, **kw)
        outs = _outputs(out)
        kept = (tuple(t if j in keep else None for j, t in enumerate(outs))
                if keep else None)
        self.calls.append(Call(index, fn, targs, tkw, keep, kept))
        self._own(_fresh(index, out, keep))
        self.begin()
        return out

    def _template(self, x):
        """x with a Ref in place of each view of the call's own tensors."""
        if torch.is_tensor(x):
            src = self.source(_ptr(x))
            if src is None:
                return x
            base = self.sources[src]
            if x.dtype != base.dtype:
                raise Uncapturable(f"a view of {_what(src)} as {x.dtype}")
            return Ref(src, tuple(x.shape), x.stride(),
                       x.storage_offset() - base.storage_offset())
        if type(x) in (tuple, list):
            return type(x)(self._template(v) for v in x)
        if type(x) is dict:
            return {k: self._template(v) for k, v in x.items()}
        return x


class Plan:
    """One key's step: its static inputs, graphs and eager calls, and the
    returned state's template (a Ref for the fresh field and output, a
    graph's tensor, cloned on return, for the small state)."""

    def __init__(self, state, kw: dict):
        self.dev = state.analog.device
        self.inputs = Inputs(state, kw)
        self.graphs: list = []
        self.calls: list = []
        self.empty: list = []
        self.launches: collections.Counter = collections.Counter()
        self.outputs = None

    def capture(self, step_fn: Callable, cfg, state, img, kw: dict):
        with torch.cuda.device(self.dev):
            self.inputs.fill(state, kw)
            st, skw = self.inputs.step_args(state, kw)
            cap = Capture(self.dev, dict(img=img, analog=state.analog,
                                         out=state.out))
            _local.capture = cap
            try:
                cap.begin()
                new = step_fn(cfg, st, img, **skw)
                cap.end()
            finally:
                _local.capture = None
                cap.close()
            outputs = []
            for name, t in zip(new._fields, new):
                ref = cap._template(t)
                if name in ("analog", "out") and type(ref) is not Ref:
                    raise Uncapturable(f"the step's {name} lies in a "
                                       "graph's memory")
                outputs.append(ref)
            self.outputs = type(new)(*outputs)
            self.graphs, self.calls = cap.graphs, cap.calls
            self.empty, self.launches = cap.empty, cap.launches
            return self._result(cap.sources)

    def replay(self, state, img, kw: dict):
        from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only
        with torch.cuda.device(self.dev):
            self.inputs.fill(state, kw)
            sources = dict(img=img, analog=state.analog, out=state.out)
            for i, g in enumerate(self.graphs):
                if g is not None:
                    g.replay()
                if i < len(self.calls):
                    self.calls[i](sources)
            build.LAUNCHES.update(self.launches)
            return self._result(sources)

    def _result(self, sources: dict):
        return type(self.outputs)(*(
            x.bind(sources) if type(x) is Ref else x.clone()
            for x in self.outputs))
