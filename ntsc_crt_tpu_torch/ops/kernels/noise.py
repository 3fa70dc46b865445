"""K11 ``inject_noise`` and K12 ``vhs_noise_bc``: the decoder's noise
stage.

K11: the reference adds a byte of a 32-bit LCG to every sample
(crt_core.c:346-367): state_i = apow[i] * rn + csum[i] (mod 2^32), the
closed form of stepping x -> ga * x + gc from rn, and

    out[i] = clamp(analog[i] + (((state_i >> shift) & 0xFF) - 0x7F) * noise
                   >> 8, -127, 127)

for the first n = len(apow) samples of each slot; the samples past n are
copied.  NTSC's LCG takes (ga, gc) = (214019, 140327895) and shift 16; the
VHS tracking noise's region A reads the first crt_rand call of each sample,
every second state of crt_rand from the head state (ga, gc = two calls)
and bits 17..24 (crt_rand's output is state >> 1).  K11 also returns
state_{n-1}, the state after the last sample.

K12: regions B and C of the VHS tracking noise (crt_core.c:343-366 under
CRT_VHS_NOISE), the last nB + nC samples of each slot, from the entry state
of each sample: region B's from K5 (ops/kernels/vhs.py), region C's from
one more K5 step and the three-call stream (a3, c3).  Every draw of the
sample follows from its entry state: the noise byte, the band's upper edge
m1 = (st2 >> 1) % 20 and, where that passes, its lower edge, which pick the
band sinusoid cs[band_line - 10] or the noise knob.  K12 writes its region
of x in place and returns the state after the last call and the last rand
value.

Neither has a Pallas kernel: the JAX package leaves both to XLA's fused
elementwise pass (``ntsc_crt_tpu/models/demodulate.py:128`` ``_inject_noise``
and ``:150`` ``_inject_noise_vhs``).  States are uint32 carried as their
int32 bit patterns.  A CPU tensor runs the plain torch versions below (the
closed forms in int64); a CUDA tensor launches csrc/noise.cu.
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops import lcg
from ntsc_crt_tpu_torch.ops.kernels import vhs


def _i32(v: int) -> int:
    """A uint32 host value as the int32 bit pattern a C int takes."""
    v &= lcg.MASK32
    return v - (1 << 32) if v >> 31 else v


def inject_noise(analog: torch.Tensor, apow: torch.Tensor, csum: torch.Tensor,
                 rn: torch.Tensor, noise: torch.Tensor, *, shift: int,
                 ga: int, gc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """analog int8 (B, N); apow, csum int32 (n,), 1 <= n <= N, the stream's
    factors (entry i+1 is entry i stepped by x -> ga * x + gc); rn and
    noise int32 (B,); 0 <= shift <= 24.  Returns (int8 (B, N), state_{n-1}
    int32 (B,))."""
    B, N = analog.shape
    n = apow.shape[0]
    if not (1 <= n <= N and csum.shape == apow.shape and 0 <= shift <= 24):
        raise ValueError(f"inject_noise: bad sizes N={N} n={n} "
                         f"csum={tuple(csum.shape)} shift={shift}")
    if analog.device.type == "cpu":
        return inject_noise_plain(analog, apow, csum, rn, noise, shift=shift,
                                  ga=ga, gc=gc)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = analog.device
    build.check("analog", analog, torch.int8, (B, N), dev)
    for name, t in (("apow", apow), ("csum", csum)):
        build.check(name, t, torch.int32, (n,), dev)
    for name, t in (("rn", rn), ("noise", noise)):
        build.check(name, t, torch.int32, (B,), dev)
    out = torch.empty_like(analog)
    last = torch.empty_like(rn)
    build.launch("ntsc_inject_noise", dev, analog.data_ptr(), out.data_ptr(),
                 apow.data_ptr(), csum.data_ptr(), rn.data_ptr(),
                 noise.data_ptr(), last.data_ptr(), B, N, n, shift,
                 _i32(ga), _i32(gc))
    return out, last


def inject_noise_plain(analog, apow, csum, rn, noise, *, shift: int, ga: int,
                       gc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The closed form in int64: the byte reads bits shift..shift+7 only, so
    the factors are reduced mod 2^(shift + 8) and the product stays inside
    int64.  (ga, gc) are implied by the tables."""
    n = apow.shape[0]
    m = (1 << (shift + 8)) - 1
    a = (apow.to(torch.int64) & m)[None]
    c = (csum.to(torch.int64) & m)[None]
    stream = a * (rn.to(torch.int64) & m)[:, None] + c
    byte = ((stream >> shift) & 0xFF).to(torch.int32) - 0x7F
    s = analog[:, :n].to(torch.int32) + ((byte * noise[:, None]) >> 8)
    out = analog.clone()
    out[:, :n] = s.clamp(-127, 127).to(torch.int8)
    last = lcg.to_i32(lcg.mul_u32(lcg.u32(apow[-1]), lcg.u32(rn))
                      + lcg.u32(csum[-1]))
    return out, last


def vhs_noise_bc(x: torch.Tensor, entB: torch.Tensor, a3: torch.Tensor,
                 c3: torch.Tensor, cs: torch.Tensor, band_line: torch.Tensor,
                 noise: torch.Tensor, *,
                 H: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x int8 (B, N), read and written in place over its last nBC = nB + nC
    samples a slot (n0 = N - nBC); entB int32 (B, nB), region B's entry
    states (K5); a3, c3 int32 (nC,), region C's three-call stream from its
    entry state; cs int32 (8, nBC), the band sinusoid `cs >> 8` for
    band_line 10..17 over regions B+C; band_line (10..17) and noise int32
    (B,); H the line length.  Returns (x, the state after the last call
    int32 (B,), the last rand value int32 (B,))."""
    B, N = x.shape
    nB, nC = entB.shape[1], a3.shape[0]
    if not (nB >= 1 and nC >= 1 and nB + nC <= N and H >= 1
            and tuple(cs.shape) == (8, nB + nC)
            and 20 * H + nB < 2**31 and 6 * H + N < 2**31):
        raise ValueError(f"vhs_noise_bc: bad sizes N={N} nB={nB} nC={nC} "
                         f"cs={tuple(cs.shape)} H={H}")
    if x.device.type == "cpu":
        return vhs_noise_bc_plain(x, entB, a3, c3, cs, band_line, noise, H=H)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = x.device
    build.check("x", x, torch.int8, (B, N), dev)
    build.check("entB", entB, torch.int32, (B, nB), dev)
    for name, t in (("a3", a3), ("c3", c3)):
        build.check(name, t, torch.int32, (nC,), dev)
    build.check("cs", cs, torch.int32, (8, nB + nC), dev)
    for name, t in (("band_line", band_line), ("noise", noise)):
        build.check(name, t, torch.int32, (B,), dev)
    st_final = torch.empty_like(noise)
    rn_out = torch.empty_like(noise)
    build.launch("ntsc_vhs_noise_bc", dev, x.data_ptr(), entB.data_ptr(),
                 a3.data_ptr(), c3.data_ptr(), cs.data_ptr(),
                 band_line.data_ptr(), noise.data_ptr(), st_final.data_ptr(),
                 rn_out.data_ptr(), B, N, nB, nC, H)
    return x, st_final, rn_out


def vhs_noise_bc_plain(x, entB, a3, c3, cs, band_line, noise, *,
                       H: int) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The same draws in plain torch, int64 for the uint32 states."""
    N = x.shape[1]
    n0 = N - cs.shape[1]
    ent, r1, band = vhs_noise_bc_draws(entB, a3, c3, N=N, H=H)
    st_final = lcg.to_i32(lcg.mul_u32(vhs.A3, ent[:, -1]) + vhs.C3)
    csb = cs[(band_line - 10).long()]                     # (B, nB + nC)
    nn = torch.where(band, csb, noise[:, None])
    s = x[:, n0:] + (((((r1 >> 16) & 0xFF) - 0x7F) * nn) >> 8)
    x[:, n0:] = s.clamp_(-127, 127)
    return x, st_final, r1[:, -1]


def vhs_noise_bc_draws(entB, a3, c3, *, N: int, H: int):
    """Regions B+C's draws: each sample's entry state (uint32 in int64),
    noise draw r1 (int32) and whether both band tests pass (bool), all
    (B, nB + nC); the samples are the last nB + nC of N."""
    nB = entB.shape[1]
    stC0 = vhs.step(lcg.u32(entB[:, -1]), nB - 1, H)    # region C's entry
    entC = (lcg.mul_u32(lcg.u32(a3)[None], stC0[:, None])
            + lcg.u32(c3)[None]) & lcg.MASK32
    ent = torch.cat([lcg.u32(entB), entC], dim=1)
    r1 = lcg.crt_rand_out(lcg.mul_u32(lcg.RAND_A, ent) + lcg.RAND_B)
    st2 = (lcg.mul_u32(vhs.A2, ent) + vhs.C2) & lcg.MASK32
    m1 = ((st2 >> 1) % 20).to(torch.int32)
    iBC = torch.arange(N - ent.shape[1], N, dtype=torch.int32,
                       device=entB.device)[None]
    cond1 = m1 * H > N - 6 * H - iBC
    rC = lcg.crt_rand_out(lcg.mul_u32(lcg.RAND_A, st2) + lcg.RAND_B)
    cond2 = H * (1 + rC % 8) < N - iBC                    # call 3 if cond1
    return ent, r1, cond1 & cond2
