"""Closed-form evaluation of the reference's sequential noise LCG.

Counterpart of ``ntsc_crt_tpu/ops/lcg.py``.  The reference injects
per-sample noise from a 32-bit LCG carried across frames
(crt_core.c:346-367):

    rn = 214019 * rn + 140327895;              // per sample, sequential
    s  = analog[i] + ((((rn >> 16) & 0xff) - 0x7f) * noise >> 8);

which has the closed form rn_k = A^k * rn_0 + B * (A^{k-1} + ... + 1)
(mod 2^32), so the whole stream is one elementwise pass over two constant
tables.  torch has no full uint32 arithmetic, so uint32 values ride int64
masked with 0xFFFFFFFF.

The VHS tracking noise draws from ``crt_rand``, the deterministic stand-in
for libc rand() that the JAX package and its test oracle share:
state = state*1103515245 + 12345 (mod 2^32), output = state >> 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LCG_A = 214019
LCG_B = 140327895
RAND_A = 1103515245
RAND_B = 12345
MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=8)
def _lcg_tables(n: int, a: int, b: int) -> tuple[np.ndarray, np.ndarray]:
    """(A^k mod 2^32, B * sum_{j<k} A^j mod 2^32) for k = 1..n, uint32.

    uint64 arithmetic wraps mod 2^64; reducing mod 2^32 afterwards is exact
    because mod 2^32 factors through mod 2^64.
    """
    apow = np.cumprod(np.full(n, a, dtype=np.uint64))          # A^1..A^n
    geo = np.cumsum(np.concatenate([[np.uint64(1)], apow[:-1]]))  # S_1..S_n
    return (
        (apow & MASK32).astype(np.uint32),
        ((np.uint64(b) * geo) & MASK32).astype(np.uint32),
    )


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern as its uint32 value, in int64."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value in int64 back to its int32 bit pattern."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul_u32(a, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for uint32 values in int64, without int64 overflow:
    the high half of `a` contributes only its low 16 product bits.  `a` is
    a tensor or an int; an int stays a scalar operand, since making it a
    device tensor would copy it from the host and stall on the stream."""
    if not torch.is_tensor(a):
        a = int(a)
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lcg_state(rn0: torch.Tensor, k: int, a: int = LCG_A,
              b: int = LCG_B) -> torch.Tensor:
    """rn_k from int32 seeds rn0 (any shape), as int32."""
    apow, csum = _lcg_tables(k, a, b)
    return to_i32(mul_u32(int(apow[-1]), u32(rn0)) + int(csum[-1]))


def noise_bytes(rn0: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """((rn_k >> 16 & 0xff) - 0x7f for k=1..n as int32, final state int32)
    for one int32 seed — the per-sample extraction at crt_core.c:359-362."""
    apow, csum = _lcg_tables(n, LCG_A, LCG_B)
    dev = rn0.device
    stream = mul_u32(torch.as_tensor(apow.astype(np.int64), device=dev),
                     u32(rn0)) + torch.as_tensor(csum.astype(np.int64),
                                                 device=dev)
    byte = ((stream >> 16) & 0xFF).to(torch.int32) - 0x7F
    return byte, lcg_state(rn0, n)


def crt_rand_out(state: torch.Tensor) -> torch.Tensor:
    """crt_rand's output, the 31-bit value state >> 1, from an int32 bit
    pattern (or a uint32 value in int64)."""
    return (u32(state) >> 1).to(torch.int32)


def crt_rand_step(state: torch.Tensor) -> torch.Tensor:
    """One crt_rand transition of int32 bit patterns, wrapping."""
    return to_i32(mul_u32(RAND_A, u32(state)) + RAND_B)


def crt_rand_stream(state0: torch.Tensor,
                    n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n sequential crt_rand() values from int32 seeds state0 (any shape):
    (values int32 state0.shape + (n,), in [0, 2^31), final state int32)."""
    apow, csum = _lcg_tables(n, RAND_A, RAND_B)
    dev = state0.device
    stream = (mul_u32(torch.as_tensor(apow.astype(np.int64), device=dev),
                      u32(state0)[..., None])
              + torch.as_tensor(csum.astype(np.int64), device=dev)) & MASK32
    return crt_rand_out(stream), to_i32(stream[..., -1])
