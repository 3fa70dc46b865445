"""Frame slots split over CUDA cards, and each frame's lines over a group.

Counterpart of ``ntsc_crt_tpu/parallel/mesh.py``.  A mesh is an n_data x
n_spatial grid of cards (make_mesh).  On the `data` axis frames are
independent apart from each slot's small cross-frame state (sync
estimates, ccf EMA, PRNG streams, blend buffer), so a batch of slots splits
into contiguous chunks, one a mesh row, and chunk d lives and steps on its
row's first card, mesh[d][0]; no step needs another chunk's data.  On the
`spatial` axis the row's cards split each frame's lines for the
row-independent kernels (parallel/spatial.py): chunk d steps inside
``spatial.line_sharding(mesh[d])``.

    m = mesh.make_mesh(2, 2)               # cuda:0-3: chunks on 0 and 2
    chunks = mesh.init_batch(cfg, 512, 640, 480, devices=m)
    step = mesh.make_sharded_step(cfg, m, noise=12)
    chunks = step(chunks, imgs, fields, frames, dcos)
    states = mesh.gather(chunks)          # one CRTState of all 512 slots

A list of devices stands for an n x 1 mesh (slots only).  devices=None
means every CUDA card, and raises where there is none.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import SystemConfig
from ntsc_crt_tpu_torch.parallel import spatial
from ntsc_crt_tpu_torch.parallel.spatial import split_bounds


def resolve_devices(devices=None) -> List[torch.device]:
    """`devices` as torch.devices; None means every CUDA card."""
    if devices is None:
        pipeline.resolve_device(None)          # raises without a card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices given")
    return devices


class Mesh:
    """An n_data x n_spatial grid of torch.devices: row d is data chunk d's
    spatial group, its first card the chunk's home.  `shape` maps the axis
    names to the grid's sizes, as jax.sharding.Mesh.shape does."""

    def __init__(self, rows: Sequence[Sequence[torch.device]]):
        self.rows = [list(r) for r in rows]
        self.shape = {spatial.DATA_AXIS: len(self.rows),
                      spatial.SPATIAL_AXIS: len(self.rows[0])}

    def __getitem__(self, d: int) -> List[torch.device]:
        return self.rows[d]

    def __len__(self) -> int:
        return len(self.rows)


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices=None) -> Mesh:
    """The devices as an n_data x n_spatial grid, row by row; n_data=None
    puts every device not on `spatial` on `data`.  devices=None means
    every CUDA card, and raises where there is none."""
    devices = resolve_devices(devices)
    if n_data is None:
        n_data = len(devices) // max(n_spatial, 1)
    if n_data < 1 or n_spatial < 1 or n_data * n_spatial != len(devices):
        raise ValueError(f"{n_data}x{n_spatial} != {len(devices)} devices")
    return Mesh([devices[d * n_spatial:(d + 1) * n_spatial]
                 for d in range(n_data)])


def as_mesh(devices=None) -> Mesh:
    """A Mesh as it is; a device list (or None: every card) as n x 1."""
    if isinstance(devices, Mesh):
        return devices
    return Mesh([[d] for d in resolve_devices(devices)])


def init_batch(cfg: SystemConfig, batch: int, outw: int, outh: int,
               devices=None) -> List[pipeline.CRTState]:
    """`batch` per-slot states as contiguous chunks, one on each device of
    a list, or on the first card of each row of a Mesh, with the noise
    streams of pipeline.init_batch (rn = 194 + slot, randstate = 1 + slot,
    numbered over the whole batch)."""
    homes = [row[0] for row in as_mesh(devices)]
    chunks = []
    for dev, (lo, hi) in zip(homes, split_bounds(batch, len(homes))):
        st = pipeline.crt_init(cfg, outw, outh, batch=hi - lo, device=dev)
        chunks.append(st._replace(
            rn=torch.arange(194 + lo, 194 + hi, dtype=torch.int32,
                            device=dev),
            randstate=torch.arange(1 + lo, 1 + hi, dtype=torch.int32,
                                   device=dev)))
    return chunks


def gather(chunks: Sequence[pipeline.CRTState]) -> pipeline.CRTState:
    """The chunks merged into one batched state on the first chunk's
    device."""
    dev = chunks[0].analog.device
    return pipeline.CRTState(*(torch.cat([x.to(dev) for x in leaves])
                               for leaves in zip(*chunks)))


def make_batched_step(cfg: SystemConfig, *, noise=0,
                      mon: Optional[MonitorParams] = None, **step_kw):
    """fn(states, imgs, fields, frames, dcos) -> states: the full step over
    a frame batch on the batch's device (pipeline.step_batch).  imgs: uint8
    (B, h, w, 3) or uint16 (B, h, w) for NES.  Extra keyword args
    (do_bloom, eq_mode, do_aberration, ...) forward to pipeline.step."""
    mon = mon or MonitorParams()

    def fn(states, imgs, fields, frames, dcos):
        return pipeline.step_batch(cfg, states, imgs, fields, frames, dcos,
                                   noise=noise, mon=mon, **step_kw)

    return fn


def make_sharded_step(cfg: SystemConfig, devices=None, *, noise=0,
                      mon: Optional[MonitorParams] = None, **step_kw):
    """fn(chunks, imgs, fields, frames, dcos) -> chunks: each device of a
    list, or each row of a Mesh, steps its chunk of the slots (from
    init_batch) on the chunk's card, a row splitting each frame's lines
    over its cards (spatial.line_sharding).  imgs, fields, frames and
    dcos (and any (B,) tensor among noise and the `mon` knobs) cover the
    whole batch on any device; each chunk's rows are copied to its device.
    Each torch op runs on its tensors' card and each kernel launch makes
    its tensors' card current (build.launch), so the current device does
    not matter.  The step holds no synchronization: one host thread queues
    card after card, and a card runs while the host queues the next.  So
    the split gains only where a chunk's device time is longer than the
    host's time to queue a step; at NTSC batch 512 it is not, and the split
    is slower than one card (chip_smoke.time_mesh, time_spatial)."""
    grid = as_mesh(devices)
    mon = mon or MonitorParams()

    def fn(chunks, imgs, fields, frames, dcos):
        if len(chunks) != len(grid):
            raise ValueError(f"{len(chunks)} chunks for {len(grid)} "
                             "devices")
        out, lo = [], 0
        for row, st in zip(grid, chunks):
            hi = lo + st.analog.shape[0]

            def part(x):
                return x[lo:hi].to(row[0]) \
                    if torch.is_tensor(x) and x.ndim else x
            with spatial.line_sharding(row):
                out.append(pipeline.step_batch(
                    cfg, st, *(part(x) for x in (imgs, fields, frames, dcos)),
                    noise=part(noise),
                    mon=MonitorParams(*(part(k) for k in mon)), **step_kw))
            lo = hi
        if lo != imgs.shape[0]:
            raise ValueError(f"chunks hold {lo} slots, the batch "
                             f"{imgs.shape[0]}")
        return out

    return fn
