"""Move the carried state between the JAX package and the port.

This system has no weights: the CRT state (and the monitor knobs) is its
only persistent data.  Both packages name its leaves alike, so a JAX
``CRTState._asdict()`` of numpy arrays (``np.asarray`` of each leaf) becomes
the port's state on any device, and back.  device=None means the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.pipeline import CRTState, resolve_device

_DTYPES = dict(analog=torch.int8, out=torch.uint8, ccf=torch.int32,
               hsync=torch.int32, vsync=torch.int32, rn=torch.int32,
               randstate=torch.int32)


def state_from_numpy(leaves: dict, device=None) -> CRTState:
    """CRTState from a dict of numpy arrays keyed by leaf name."""
    device = resolve_device(device)
    return CRTState(**{
        k: torch.as_tensor(np.array(leaves[k]), device=device)
        .to(_DTYPES[k]).contiguous()
        for k in CRTState._fields})


def state_to_numpy(state: CRTState) -> dict:
    """dict of numpy arrays keyed by leaf name."""
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}


def mon_from_numpy(knobs: dict, device=None) -> MonitorParams:
    """MonitorParams from ints or numpy arrays; arrays become int32 tensors
    on `device`, scalars stay ints."""
    device = resolve_device(device)

    def one(v):
        a = np.asarray(v)
        if a.ndim == 0:
            return int(a)
        return torch.as_tensor(a.astype(np.int32), device=device)
    return MonitorParams(**{k: one(v) for k, v in knobs.items()})


def mon_to_numpy(mon: MonitorParams) -> dict:
    """dict of int32 numpy values keyed by knob name."""
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.int32(v))
            for k, v in mon._asdict().items()}
