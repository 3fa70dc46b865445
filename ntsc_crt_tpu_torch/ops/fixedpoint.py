"""Integer fixed-point primitives with exact C89 semantics, on torch tensors.

Counterpart of ``ntsc_crt_tpu/ops/fixedpoint.py``.  The reference is
integer-only, so bit-exact parity needs C's *truncating* division and
remainder (torch's ``//`` and ``%`` floor, like Python's, and serve only
``posmod``), arithmetic right shifts of negative int32 (torch's ``>>`` on
signed tensors) and two's-complement int32 wrap.

Reference citations:
  - 14-bit sine/cosine table interpolation: crt_core.c:19-61
  - 11-bit fixed point e^x:                crt_ntsc.c:25-83
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# 2*pi == 16384 in the 14-bit angle domain (crt_core.h:135-137)
T14_2PI = 16384
T14_MASK = T14_2PI - 1
T14_PI = T14_2PI // 2

# ---------------------------------------------------------------------------
# C integer semantics helpers
# ---------------------------------------------------------------------------


def i32(x, device=None) -> torch.Tensor:
    """`x` as an int32 tensor, wrapping mod 2^32 like jnp.asarray(x, int32)."""
    t = torch.as_tensor(x, device=device)
    if t.dtype == torch.int32:
        return t
    if t.is_floating_point():
        raise TypeError(f"i32 takes integers, got {t.dtype}")
    t = t.to(torch.int64)
    return (((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def cdiv(a, b) -> torch.Tensor:
    """C truncating integer division."""
    return torch.div(i32(a), b if isinstance(b, int) else i32(b),
                     rounding_mode="trunc")


def crem(a, b) -> torch.Tensor:
    """C truncating remainder (sign follows the dividend, like C's %)."""
    return torch.fmod(i32(a), b if isinstance(b, int) else i32(b))


def posmod(a, n) -> torch.Tensor:
    """((a % n) + n) % n with C truncating %, always in [0, n) — the
    reference's POSMOD macro (crt_core.c:17)."""
    r = crem(a, n)
    return torch.where(r < 0, r + n, r)


def host_i32(v: int) -> int:
    """A host int wrapped to int32, as the card holds it."""
    return ((int(v) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def host_tdiv(a: int, b: int) -> int:
    """C truncating division on host Python ints."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


# ---------------------------------------------------------------------------
# 14-bit angle sine/cosine (crt_core.c:19-61)
# ---------------------------------------------------------------------------

# significant points on sine wave (15-bit), crt_core.c:19-24
_SIGPSIN15 = np.array(
    [0x0000,
     0x0C88, 0x18F8, 0x2528, 0x30F8, 0x3C50, 0x4718, 0x5130, 0x5A80,
     0x62F0, 0x6A68, 0x70E0, 0x7640, 0x7A78, 0x7D88, 0x7F60, 0x8000,
     0x7F60],
    dtype=np.int32,
)


@functools.lru_cache(maxsize=None)
def _sin_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_SIGPSIN15, device=device)


def _sintabil8(n: torch.Tensor) -> torch.Tensor:
    """Linear interpolation over the quarter-wave table (crt_core.c:26-39).
    Out-of-range lanes (the untaken side of a select) are clipped."""
    tab = _sin_table(n.device)
    f = n & 0xFF
    i = ((n >> 8) & 0xFF).clamp(0, 16).long()
    a = tab[i]
    b = tab[i + 1]
    return a + (((b - a) * f) >> 8)


def sincos14(n) -> tuple[torch.Tensor, torch.Tensor]:
    """14-bit interpolated (sin, cos), each 15-bit — crt_sincos14
    (crt_core.c:42-61).  Any int32 angle is accepted (masked)."""
    n = i32(n) & T14_MASK
    h = n & ((T14_2PI >> 1) - 1)
    hi = h > ((T14_2PI >> 2) - 1)
    c = torch.where(hi, -_sintabil8(h - (T14_2PI >> 2)),
                    _sintabil8((T14_2PI >> 2) - h))
    s = torch.where(hi, _sintabil8((T14_2PI >> 1) - h), _sintabil8(h))
    flip = n > ((T14_2PI >> 1) - 1)
    return torch.where(flip, -s, s), torch.where(flip, -c, c)


def np_sincos14(n) -> tuple[np.ndarray, np.ndarray]:
    """Host-numpy crt_sincos14 with the same integer semantics as sincos14,
    for building constant tables (int32 results)."""
    n = np.asarray(n, np.int64) & T14_MASK
    tab = _SIGPSIN15.astype(np.int64)

    def interp(m):
        f = m & 0xFF
        i = np.clip((m >> 8) & 0xFF, 0, 16)
        return tab[i] + ((tab[i + 1] - tab[i]) * f >> 8)

    h = n & ((T14_2PI >> 1) - 1)
    hi = h > ((T14_2PI >> 2) - 1)
    c = np.where(hi, -interp(h - (T14_2PI >> 2)), interp((T14_2PI >> 2) - h))
    s = np.where(hi, interp((T14_2PI >> 1) - h), interp(h))
    flip = n > ((T14_2PI >> 1) - 1)
    return (np.where(flip, -s, s).astype(np.int32),
            np.where(flip, -c, c).astype(np.int32))


def host_sincos14(n: int) -> tuple[int, int]:
    """Host-int crt_sincos14 for init-time coefficient derivation."""
    s, c = np_sincos14(n)
    return int(s), int(c)


# ---------------------------------------------------------------------------
# 11-bit fixed-point e^x (crt_ntsc.c:25-83)
# ---------------------------------------------------------------------------

EXP_P = 11
EXP_ONE = 1 << EXP_P
EXP_MASK = EXP_ONE - 1
EXP_PI = 6434

_E11 = [EXP_ONE, 5567, 15133, 41135, 111817]  # e^0..e^4 (crt_ntsc.c:32-38)


def host_expx(n: int) -> int:
    """Fixed-point e^x on host ints (expx, crt_ntsc.c:41-83); only used to
    derive the IIR coefficients."""
    def mul(x: int, y: int) -> int:
        return (x * y) >> EXP_P

    if n == 0:
        return EXP_ONE
    neg = n < 0
    if neg:
        n = -n
    idx = n >> EXP_P
    res = EXP_ONE
    for _ in range(idx // 4):
        res = mul(res, _E11[4])
    idx &= 3
    if idx > 0:
        res = mul(res, _E11[idx])
    n &= EXP_MASK
    nxt = EXP_ONE
    acc = 0
    dl = 1
    for i in range(1, 17):
        acc += host_tdiv(nxt, dl)
        nxt = mul(nxt, n)
        dl *= i
        if dl > nxt or nxt <= 0 or dl <= 0:
            break
    res = mul(res, acc)
    if neg:
        res = host_tdiv(EXP_ONE << EXP_P, res)
    return res
