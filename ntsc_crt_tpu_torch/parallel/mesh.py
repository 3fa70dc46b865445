"""Frame slots split over CUDA cards.

Counterpart of ``ntsc_crt_tpu/parallel/mesh.py`` on its data axis.  Frames
are independent apart from each slot's small cross-frame state (sync
estimates, ccf EMA, PRNG streams, blend buffer), so a batch of slots splits
into contiguous chunks, one a card, and each card steps its own chunk; no
step needs another card's data.  There is no mesh object and no spatial
(scanline) axis: each card decodes its slots whole.

    chunks = mesh.init_batch(cfg, 512, 640, 480, devices=["cuda:0", "cuda:1"])
    step = mesh.make_sharded_step(cfg, ["cuda:0", "cuda:1"], noise=12)
    chunks = step(chunks, imgs, fields, frames, dcos)
    states = mesh.gather(chunks)          # one CRTState of all 512 slots

devices=None means every CUDA card, and raises where there is none.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import SystemConfig


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


def split_bounds(batch: int, n: int):
    """[lo, hi) of each of n contiguous chunks of `batch` slots; the first
    batch % n chunks take one slot more."""
    if batch < n:
        raise ValueError(f"{batch} slots cannot fill {n} devices")
    q, r = divmod(batch, n)
    bounds, lo = [], 0
    for i in range(n):
        hi = lo + q + (i < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def init_batch(cfg: SystemConfig, batch: int, outw: int, outh: int,
               devices=None) -> List[pipeline.CRTState]:
    """`batch` per-slot states as contiguous chunks, one on each device,
    with the noise streams of pipeline.init_batch (rn = 194 + slot,
    randstate = 1 + slot, numbered over the whole batch)."""
    devices = resolve_devices(devices)
    chunks = []
    for dev, (lo, hi) in zip(devices, split_bounds(batch, len(devices))):
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
    """fn(chunks, imgs, fields, frames, dcos) -> chunks: each device steps
    its chunk of the slots (from init_batch).  imgs, fields, frames and
    dcos (and any (B,) tensor among noise and the `mon` knobs) cover the
    whole batch on any device; each chunk's rows are copied to its device.
    Each torch op runs on its tensors' card and each kernel launch makes
    its tensors' card current (build.launch), so the current device does
    not matter.  The step holds no synchronization: one host thread queues
    card after card, and a card runs while the host queues the next.  So
    the split gains only where a chunk's device time is longer than the
    host's time to queue a step; at NTSC batch 512 it is not, and the split
    is slower than one card (chip_smoke.time_mesh)."""
    devices = resolve_devices(devices)
    mon = mon or MonitorParams()

    def fn(chunks, imgs, fields, frames, dcos):
        if len(chunks) != len(devices):
            raise ValueError(f"{len(chunks)} chunks for {len(devices)} "
                             "devices")
        out, lo = [], 0
        for dev, st in zip(devices, chunks):
            hi = lo + st.analog.shape[0]

            def part(x):
                return x[lo:hi].to(dev) \
                    if torch.is_tensor(x) and x.ndim else x
            out.append(pipeline.step_batch(
                cfg, st, *(part(x) for x in (imgs, fields, frames, dcos)),
                noise=part(noise), mon=MonitorParams(*(part(k) for k in mon)),
                **step_kw))
            lo = hi
        if lo != imgs.shape[0]:
            raise ValueError(f"chunks hold {lo} slots, the batch "
                             f"{imgs.shape[0]}")
        return out

    return fn
