"""Scanline (spatial) sharding: one frame's lines split over a group of
cards for the row-independent kernels.

Counterpart of ``ntsc_crt_tpu/parallel/spatial.py``.  Frames ride the
`data` axis (parallel/mesh.py: each data chunk on its own card); within a
chunk, the kernels whose rows are independent — K1 encode_rows, K2
decode_rows in every mode, and K7, K8 and K9 through their op entry points
— split their lines (or flattened rows) into contiguous blocks, one on each
card of the chunk's spatial group.  Each block is copied to its card, the
kernel runs there unchanged, and each result is copied back to the group's
first card (the chunk's home) and joined.  Everything else runs whole on
the home card: the noise, vsync, the line scan (K3, K4), bloom_line_width
(its EMA is serial over lines), K5 and the row placement (K6), as the JAX
package keeps K3, K4 and K6 whole under spatial partitioning
(demodulate.py:381, :716, :1164).

    with spatial.line_sharding([dev0, dev1]):      # or mesh.make_mesh(1, 2)
        states = pipeline.step_batch(cfg, states, imgs, ...)   # on dev0

The copies are ordinary cross-device ``Tensor.to`` calls: PyTorch orders a
copy between cards after the work queued on the source card's current
stream and before the work queued after it on the destination card's, so a
shard's kernel waits for its block and the copy back waits for the kernel,
and the host never waits.  Cards in a group may repeat (one card standing
in for several): a block is then a slice of the home tensor and no copy is
made.

What the JAX module has that this one does not, and why:

* ``shard_lines`` is an XLA sharding constraint on an intermediate.  Eager
  torch ops run where their tensors are, so the plain stages between the
  kernels run whole on the chunk's home card.
* ``shard_batch_entries_call`` (K5's batch on `data`, whole over `spatial`)
  is not needed: each data chunk already runs K5 whole on its own card.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

_CTX: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "ntsc_crt_spatial_group", default=None)
# test hook: called as _INSPECT(tag, [(device, lo, hi), ...]) for every
# sharded call — the kernel's name and each shard's card and line (or row)
# range
_INSPECT: Optional[Callable] = None


def split_bounds(n: int, k: int):
    """[lo, hi) of each of k contiguous chunks of n items (frame slots,
    lines or rows); the first n % k chunks take one item more."""
    if n < k:
        raise ValueError(f"{n} slots cannot fill {k} devices")
    q, r = divmod(n, k)
    bounds, lo = [], 0
    for i in range(k):
        hi = lo + q + (i < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


@contextlib.contextmanager
def line_sharding(devices: Optional[Sequence]):
    """Split the row-independent kernels' lines over `devices`, in order,
    inside the context; the first is the home card that holds the chunk.
    A group of one, or None, deactivates the split."""
    group = None if devices is None or len(devices) < 2 else \
        tuple(torch.device(d) for d in devices)
    tok = _CTX.set(group)
    try:
        yield
    finally:
        _CTX.reset(tok)


def active() -> bool:
    return _CTX.get() is not None


def _shards(tag: str, call, n: int, block):
    """call(block(lo, hi) moved to its card) for each of the active
    group's blocks [lo, hi) of n lines, with fewer shards where n is
    smaller than the group; returns the results, each copied back to the
    home card."""
    group = _CTX.get()
    shards = [(dev, lo, hi) for dev, (lo, hi)
              in zip(group, split_bounds(n, min(len(group), n)))]
    outs = []
    for dev, lo, hi in shards:
        args = {k: v.to(dev).contiguous() for k, v in block(lo, hi).items()}
        outs.append(call(args).to(group[0]))
    if _INSPECT is not None:
        _INSPECT(tag, shards)
    return outs


def shard_rows_call(fn, *args, **static):
    """Run a row-independent kernel dispatch over the active group.

    `fn(*args, **static)` must treat dim 0 of every argument and of its one
    output tensor as independent rows (the flattened batch x line rows that
    K7, K8 and K9 take).  Outside a line_sharding context this is a plain
    call.  Under one, the rows split into contiguous blocks over the
    group's cards (no padding: the blocks may differ by one row); each block
    runs on its card and the results are joined on the home card."""
    group = _CTX.get()
    if group is None or args[0].shape[0] == 0:
        return fn(*args, **static)
    outs = _shards(fn.__name__, lambda a: fn(*a.values(), **static),
                   args[0].shape[0],
                   lambda lo, hi: {i: a[lo:hi] for i, a in enumerate(args)})
    return torch.cat(outs)


def shard_lines_call(fn, *args, halo: Optional[dict] = None,
                     whole: tuple = (), **kw):
    """Run a per-line kernel — one that takes (B, lines, ...) tensors, as
    K1 and K2 do — over the active group: fn(*args, **kw), its output's
    dim 1 the lines.

    Each tensor argument (by position, or by name among kw) is per line
    and taken at lines [lo, hi) of each block on dim 1 (K1's sy and carrier
    tables; K2's shifts, waves, bright, contrast and bloom steps), except
    those that `whole` names, copied whole to every card (per-slot values,
    and K1's image, which any line may read), and those that `halo` maps
    to k, taken at [lo, hi + k) on dim 1, for a kernel whose line l reads
    rows l .. l + k (K2's rows, k = row0 + 1: line l reads rows l + row0
    and l + row0 + 1).  Other arguments are host values, passed as they
    are.  Outside a line_sharding context this is a plain call."""
    halo = halo or {}
    named = {**dict(enumerate(args)), **kw}
    tensors = {k: v for k, v in named.items() if torch.is_tensor(v)}
    per_line = [k for k in tensors if k not in halo and k not in whole]
    n = tensors[per_line[0]].shape[1]
    group = _CTX.get()
    if group is None or n == 0:
        return fn(*args, **kw)

    def block(lo, hi):
        return {k: v if k in whole else v[:, lo:hi + halo.get(k, 0)]
                for k, v in tensors.items()}

    def call(blocks):
        full = {**named, **blocks}
        return fn(*(full[i] for i in range(len(args))),
                  **{k: full[k] for k in kw})
    outs = _shards(fn.__name__, call, n, block)
    return torch.cat(outs, dim=1)
