"""K5 ``vhs_region_b_entries``: the serial crt_rand march of VHS noise
region B.

From each entry's state st (a uint32 carried as its int32 bit pattern),
every step t emits st and moves to st2 = st*A^2 + C2 (two crt_rand calls)
or, when m1*H + t > 19H - 1 with m1 = (st2 >> 1) % 20, to st3 = st*A^3 + C3
(three calls) — crt_core.c:343-357 with C's && short circuit.

Replaces ``ntsc_crt_tpu/ops/pallas/vhs_scan.py::vhs_region_b_entries``.
The entry states come as (B, n_steps), one entry's steps contiguous (the
JAX function gives (n_steps, B)); states are int32 bit patterns where the
JAX function takes and gives uint32.  A CPU tensor runs the plain torch
loop below; a CUDA tensor launches csrc/vhs.cu, which walks each entry's
LCG positions with one warp.
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops import lcg


A2 = (lcg.RAND_A * lcg.RAND_A) & lcg.MASK32             # two calls composed
C2 = (lcg.RAND_A * lcg.RAND_B + lcg.RAND_B) & lcg.MASK32
A3 = (A2 * lcg.RAND_A) & lcg.MASK32                     # three calls
C3 = (lcg.RAND_A * C2 + lcg.RAND_B) & lcg.MASK32


def step(st: torch.Tensor, t: int, H: int) -> torch.Tensor:
    """One region-B step from uint32 values in int64, t the step index."""
    st2 = (lcg.mul_u32(A2, st) + C2) & lcg.MASK32
    st3 = (lcg.mul_u32(A3, st) + C3) & lcg.MASK32
    m1 = (st2 >> 1) % 20
    return torch.where(m1 * H + t > 19 * H - 1, st3, st2)


def vhs_region_b_entries(st0: torch.Tensor, *, n_steps: int,
                         H: int) -> torch.Tensor:
    """st0 int32 (B,) bit patterns.  Returns the int32 (B, n_steps) entry
    state of every step."""
    if st0.device.type == "cpu":
        return vhs_region_b_entries_plain(st0, n_steps=n_steps, H=H)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = st0.device
    B = st0.shape[0]
    build.check("st0", st0, torch.int32, (B,), dev)
    if not (B >= 1 and n_steps >= 1 and H >= 1
            and 20 * H + n_steps < 2**31):
        raise ValueError(f"vhs_region_b_entries: bad sizes B={B} "
                         f"n_steps={n_steps} H={H}")
    out = torch.empty((B, n_steps), dtype=torch.int32, device=dev)
    build.launch("ntsc_vhs_region_b_entries", dev, st0.data_ptr(),
                 out.data_ptr(), B, n_steps, H)
    return out


def vhs_region_b_entries_plain(st0, *, n_steps: int, H: int) -> torch.Tensor:
    """The same march in plain torch, one vectorised step at a time."""
    st = lcg.u32(st0)
    out = torch.empty(tuple(st.shape) + (n_steps,), dtype=torch.int64,
                      device=st.device)
    for t in range(n_steps):
        out[..., t] = st
        st = step(st, t, H)
    return lcg.to_i32(out)
