"""Frozen: the plain versions of the port's kernels K1-K6 and K11-K13
(``ntsc_crt_tpu_torch/ops/kernels/*.py``) as they stood when the benchmark
was defined; K2 in its 3-band mode only."""

from __future__ import annotations

import functools

import numpy as np
import torch

from crt_bench.reference import fastpath, filters, lcg
from crt_bench.reference.fixedpoint import cdiv, crem, posmod, sincos14


# K1

def rgb_to_yiq(pix: torch.Tensor):
    """crt_ntsc.c:307-310 — int32 elementwise over (..., 3) pixels."""
    r, g, b = pix[..., 0], pix[..., 1], pix[..., 2]
    fy = (19595 * r + 38470 * g + 7471 * b) >> 14
    fi = (39059 * r - 18022 * g - 21103 * b) >> 14
    fq = (13894 * r - 34275 * g + 20382 * b) >> 14
    return fy, fi, fq


def encode_rows_plain(img, sy, modI, modQ, gain, base, *, coefs,
                      xo_mod: int, destw: int) -> torch.Tensor:
    """The same function in plain torch: resample, then one vectorised march
    along x for the IIR."""
    B, w = img.shape[0], img.shape[2]
    dev = img.device
    sx = (torch.arange(destw, device=dev) * w) // destw
    bi = torch.arange(B, device=dev)[:, None, None]
    pix = img[bi, sy.long()[:, :, None], sx].to(torch.int32)
    fy, fi, fq = rgb_to_yiq(pix)                          # (B, desth, destw)
    if coefs is not None:
        yiq = filters.iir_lowpass_rows_plain(
            torch.stack([fy, fi, fq], dim=-2),
            torch.tensor(coefs, dtype=torch.int32, device=dev))
        fy, fi, fq = yiq.unbind(-2)
    fi = (fi * fastpath.tile_period(modI, destw, xo_mod)) >> 4
    fq = (fq * fastpath.tile_period(modQ, destw, xo_mod)) >> 4
    ire = base[:, None, None] + (((fy + fi + fq) * gain[:, None, None]) >> 10)
    return ire.clamp(0, 110).to(torch.int8)


# K2

def decode_rows_plain(rows, shifts, waveI, waveQ, bright, contrast, *,
                      row0: int, coefs, av_len: int, outw: int,
                      eq_float: bool = False) -> torch.Tensor:
    """K2, 3-band EQ: align, demodulate, one vectorised EQ march over every
    row and channel, lerp, YIQ -> RGB.  eq_float marches the EQ in float32
    without its truncations (the benchmark's control)."""
    B, L = shifts.shape
    H = rows.shape[2]
    n = av_len
    ext = torch.cat([rows[:, row0:row0 + L], rows[:, row0 + 1:row0 + L + 1]],
                    dim=2).reshape(B * L, 2 * H)
    sig = fastpath.shift_rows(ext, shifts.reshape(-1),
                              av_len).reshape(B, L, av_len)
    wv_i = fastpath.tile_period(waveI, n)
    wv_q = fastpath.tile_period(waveQ, n)
    stacked = torch.stack([sig + bright[..., None], (sig * wv_i) >> 9,
                           (sig * wv_q) >> 9], dim=2)    # (B, L, 3, n)
    per_chan = [torch.tensor([c[k] for c in coefs], dtype=torch.int32,
                             device=rows.device) for k in range(5)]
    march = (filters.eq_threeband_rows_float if eq_float
             else filters.eq_threeband_rows_plain)
    eqd = march(stacked, *per_chan)
    oy, oi, oq = eqd[:, :, 0] << 4, eqd[:, :, 1] >> 3, eqd[:, :, 2] >> 3
    yv = fastpath.lerp_resample(oy, outw, 2)
    iv = fastpath.lerp_resample(oi, outw, 14)
    qv = fastpath.lerp_resample(oq, outw, 14)
    ct = contrast[..., None]
    r = (((yv + 3879 * iv + 2556 * qv) >> 12) * ct) >> 8
    g = (((yv - 1126 * iv - 2605 * qv) >> 12) * ct) >> 8
    b = (((yv - 4530 * iv + 7021 * qv) >> 12) * ct) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


# K3

def hsync_chase_plain(rows2, active_l, hsync0, *, W: int, c0: int,
                      thresh: int, H: int) -> torch.Tensor:
    """The same chase in plain torch: one vectorised window probe per line."""
    B, L, HP = rows2.shape
    tW = 2 * W
    off = torch.arange(tW, device=rows2.device)
    hs = hsync0.to(torch.int32)
    out = torch.empty((B, L), dtype=torch.int32, device=rows2.device)
    for l in range(L):
        x = (hs + c0).long()[:, None] + off                # (B, 2W)
        win = torch.gather(rows2[:, l], 1, x.clamp(0, HP - 1))
        win = torch.where((x >= 0) & (x < HP), win.to(torch.int32), 0)
        hit = torch.cumsum(win, 1, dtype=torch.int32) <= thresh
        j = torch.where(hit.any(1), hit.to(torch.int32).argmax(1), tW)
        hs = torch.where(active_l[:, l], posmod(j - W + hs, H), hs)
        out[:, l] = hs
    return out


# K4

def ccf_ema_plain(per_cls, vper_l, active_l, ccf0):
    """The same EMA in plain torch: one step per line, vectorised over the
    batch and the phase classes."""
    B, L, m, CC = per_cls.shape
    bi = torch.arange(B, device=per_cls.device)
    vper_l = vper_l.long()
    ccf = ccf0.clone()
    ccr_l = torch.empty((B, L, CC), dtype=torch.int32, device=per_cls.device)
    for l in range(L):
        vp = vper_l[:, l]
        ccr = ccf[bi, vp]
        new = ccr
        for mm in range(m):
            new = cdiv(new * 127, 128) + per_cls[:, l, mm]
        ccr = torch.where(active_l[:, l, None], new, ccr)
        ccf[bi, vp] = ccr
        ccr_l[:, l] = ccr
    return ccf, ccr_l


# K5

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


def vhs_region_b_entries_plain(st0, *, n_steps: int, H: int) -> torch.Tensor:
    """The same march in plain torch, one vectorised step at a time."""
    st = lcg.u32(st0)
    out = torch.empty(tuple(st.shape) + (n_steps,), dtype=torch.int64,
                      device=st.device)
    for t in range(n_steps):
        out[..., t] = st
        st = step(st, t, H)
    return lcg.to_i32(out)


# K11, K12

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


def vhs_noise_bc_plain(x, entB, a3, c3, cs, band_line, noise, *,
                       H: int) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The same draws in plain torch, int64 for the uint32 states."""
    N = x.shape[1]
    n0 = N - cs.shape[1]
    ent, r1, band = vhs_noise_bc_draws(entB, a3, c3, N=N, H=H)
    st_final = lcg.to_i32(lcg.mul_u32(A3, ent[:, -1]) + C3)
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
    stC0 = step(lcg.u32(entB[:, -1]), nB - 1, H)    # region C's entry
    entC = (lcg.mul_u32(lcg.u32(a3)[None], stC0[:, None])
            + lcg.u32(c3)[None]) & lcg.MASK32
    ent = torch.cat([lcg.u32(entB), entC], dim=1)
    r1 = lcg.crt_rand_out(lcg.mul_u32(lcg.RAND_A, ent) + lcg.RAND_B)
    st2 = (lcg.mul_u32(A2, ent) + C2) & lcg.MASK32
    m1 = ((st2 >> 1) % 20).to(torch.int32)
    iBC = torch.arange(N - ent.shape[1], N, dtype=torch.int32,
                       device=entB.device)[None]
    cond1 = m1 * H > N - 6 * H - iBC
    rC = lcg.crt_rand_out(lcg.mul_u32(lcg.RAND_A, st2) + lcg.RAND_B)
    cond2 = H * (1 + rC % 8) < N - iBC                    # call 3 if cond1
    return ent, r1, cond1 & cond2


# K6

def place_rows_uniform_plain(rgb, old, field_px, *, blend: bool,
                             scanlines: int, ratio: int, fp: int,
                             bloom_dx=None, bloom_scan=None,
                             av_len: int = None) -> torch.Tensor:
    """The stacked form in plain torch: one plane per slot j of the
    (L, ratio) row groups, interleaved at the end."""
    B, L, w, _ = rgb.shape
    old_stk = old.reshape(B, L, ratio, w, 3)
    fb = field_px > 0                                     # (B,)
    fb4 = fb[:, None, None, None]
    k = torch.arange(L, device=rgb.device)
    prev = (k - 1).clamp(min=0)                           # line k - 1
    bloom = bloom_dx is not None
    if bloom:   # (B, L, w): the pixels each line draws (crt_core.c:555)
        p = torch.arange(w, dtype=torch.int32, device=rgb.device)
        drawn = (bloom_scan[..., None] + p * bloom_dx[..., None]
                 < ((av_len - 1) << 12))[..., None]
    planes = []
    for j in range(ratio):
        shifted = fp > 0 and j < fp
        src = torch.where(fb4, rgb[:, prev], rgb) if shifted else rgb
        if blend or bloom:
            # the previous contents of the source line's beg row
            old_beg = old_stk[:, :, 0]
            if fp:
                obf = old_stk[:, :, fp]
                old_beg = torch.where(fb4, obf[:, prev] if shifted else obf,
                                      old_beg)
        if blend:
            src = (src >> 1) + (old_beg >> 1)             # crt_core.c:608
        if bloom:
            d = torch.where(fb4, drawn[:, prev], drawn) if shifted else drawn
            src = torch.where(d, src, old_beg)
        keep = torch.where(fb, (j - fp) % ratio >= ratio - scanlines,
                           j >= ratio - scanlines)[:, None].expand(B, L)
        if shifted:
            keep = keep | ((k == 0)[None] & fb[:, None])  # rows above the field
        if fp > 0 and j > fp and j >= ratio - scanlines:
            # bottom clip (crt_core.c:432): the last group's duplicates stay
            keep = keep | ((k == L - 1)[None] & fb[:, None])
        planes.append(torch.where(keep[..., None, None], old_stk[:, :, j],
                                  src))
    return torch.stack(planes, dim=2).reshape(B, ratio * L, w, 3)


# K13

# amplified IRE levels (crt_nes.c:26-40) as [l][e][lum]
_NES_T = np.array(
    [-12042, 0, 34406, 81427,          # 0d 1d 2d 3d
     -17203, -8028, 19497, 57342,      # emphasized
     43581, 75693, 112965, 112965,     # 00 10 20 30
     26951, 52181, 83721, 83721],      # emphasized
    dtype=np.int64).reshape(2, 2, 4)


# the emphasis bits active at phase class (phase >> 1) % 6 (crt_nes.c:26-30)
_NES_ACTIVE = np.array([0o300, 0o100, 0o500, 0o400, 0o600, 0o200])


@functools.lru_cache(maxsize=1)
def square_sum_table() -> np.ndarray:
    """S[p, u] = sum_{j<4} square_sample(p, u + j) for p = pixel & 0x1FF
    and u = phase % 12, int32 (512, 12): square_sample (crt_nes.c:21-61) is
    _NES_T[l][e][lum] with lum the pixel's bits 4-5, e whether an emphasis
    bit is active at the phase, and l 1 at hue 0x00, 0 at 0x0D, else
    whether (hue + phase) % 12 < 6; hues 0x0E and 0x0F are black."""
    p = np.arange(512)[:, None]
    phase = np.arange(12)[None, :]
    hue = p & 0x0F
    v = ((hue + phase) % 12 < 6).astype(np.int64)
    e = ((p & 0o700) & _NES_ACTIVE[(phase >> 1) % 6]) > 0
    lvl = np.where(hue == 0x00, 1, np.where(hue == 0x0D, 0, v))
    one = np.where(hue >= 0x0E, 0, _NES_T[lvl, e.astype(np.int64),
                                          (p >> 4) & 3])
    return sum(np.roll(one, -j, axis=1) for j in range(4)).astype(np.int32)


@functools.lru_cache(maxsize=16)
def burst_sines(device: torch.device) -> torch.Tensor:
    """sincos14's sine >> 10 at every burst angle -359..359 degrees (the
    angle is reduced % 360 first, crt_nes.c:123-130), int32 (719,), on
    `device`."""
    n = torch.arange(-359, 360, dtype=torch.int32)
    return (sincos14(cdiv(n * 8192, 180))[0] >> 10).to(device)


@functools.lru_cache(maxsize=16)
def square_table(device: torch.device) -> torch.Tensor:
    """square_sum_table() on `device`, copied once (a host copy in every
    step would stall the stream)."""
    return torch.as_tensor(square_sum_table(), device=device)


def wrap_i8(x: torch.Tensor) -> torch.Tensor:
    """C signed-char assignment (wrap mod 256): the NES encoder stores
    unclamped IRE sums (crt_nes.c:190-191)."""
    return (((x + 128) & 255) - 128).to(torch.int8)


def square_sum4(p: torch.Tensor, phase0: torch.Tensor) -> torch.Tensor:
    """sum_{j<4} square_sample(p, phase0 + j) (crt_nes.c:21-61), exact —
    the JAX package's closed form (modulate.py:755-815).

    square_sample is IRE[l][e][lum], bilinear in the bits (l, e) for a fixed
    lum, so the 4-phase sum is 4*T00 + L*(T10-T00) + E*(T01-T00) +
    LE*(T11-T10-T01+T00) with L, E, LE the sums of l_j, e_j, l_j*e_j; each
    lum table is bilinear in lum's two bits; the emphasis masks
    {0300,0100,0500,0400,0600,0200} reduce to k = (phase>>1) % 6: bit6 iff
    k<=2, bit7 iff k==0 or k>=4, bit8 iff 2<=k<=4.  p, phase0: broadcastable
    non-negative int32; no clamp (|S| <= 4*112965)."""
    hue_p = p & 0x0F
    lum0 = (p >> 4) & 1
    lum1 = (p >> 5) & 1
    lum01 = lum0 & lum1
    e6, e7, e8 = (p >> 6) & 1, (p >> 7) & 1, (p >> 8) & 1
    is0 = (hue_p == 0x00).to(torch.int32)
    not13 = (hue_p != 0x0D).to(torch.int32)

    def blin(t):  # a 4-entry table, bilinear in the lum bits
        c0, c1, c2, c3 = (int(t[0]), int(t[1] - t[0]), int(t[2] - t[0]),
                          int(t[3] - t[2] - t[1] + t[0]))
        return c0 + c1 * lum0 + c2 * lum1 + c3 * lum01

    T = _NES_T
    t00 = blin(T[0, 0])
    d10 = blin(T[1, 0] - T[0, 0])
    d01 = blin(T[0, 1] - T[0, 0])
    d11 = blin(T[1, 1] - T[1, 0] - T[0, 1] + T[0, 0])

    u = crem(phase0, 12)
    z = hue_p + u                             # <= 26: two range reductions
    z = z - torch.where(z >= 12, 12, 0)
    z = z - torch.where(z >= 12, 12, 0)
    L = E = LE = 0
    for j in range(4):
        mj = u + j
        k = (mj - torch.where(mj >= 12, 12, 0)) >> 1     # (phase>>1) % 6
        zj = z + j
        v = ((zj - torch.where(zj >= 12, 12, 0)) < 6).to(torch.int32)
        a6 = (k <= 2).to(torch.int32)
        a7 = ((k == 0) | (k >= 4)).to(torch.int32)
        a8 = ((k >= 2) & (k <= 4)).to(torch.int32)
        e = (e6 & a6) | (e7 & a7) | (e8 & a8)
        l = is0 | (v & not13)
        L = L + l
        E = E + e
        LE = LE + (l & e)
    total = (t00 << 2) + L * d10 + E * d01 + LE * d11
    return torch.where(hue_p >= 0x0E, 0, total)           # black columns


def nes_phase(rows: torch.Tensor, dco: torch.Tensor, vp: int) -> torch.Tensor:
    """phasetab[(row + dco) % vp] = 4 * class (B, n), with C's %: a
    negative class matches no entry and reads 0, as the JAX package's
    onehot_pick does."""
    cls = crem(rows[None, :] + dco[:, None], vp)
    return torch.where(cls >= 0, 4 * cls, 0)


def nes_square_plain(analog, ppu, table, dco, black_point, white_point,
                     border_color, hue, sines, *, xo: int, yo: int,
                     destw: int, desth: int, draw_border: bool, box, vp: int,
                     black_level: int, skeleton, burst_box, cc: int,
                     vert_step: int, burst_level: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pass in plain torch: the burst table by its angles, the skeleton
    and the burst by slices, the closed form (square_sum4) on every picture
    sample, so the square table is not read."""
    del table
    dev = analog.device
    H = analog.shape[2]
    h, w = ppu.shape[1], ppu.shape[2]
    sync_beg, sync_end, sep_row, sep_end, sync_level, blank_level = skeleton
    yv = torch.arange(vp, dtype=torch.int32, device=dev)[None, :, None]
    xv = torch.arange(cc, dtype=torch.int32, device=dev)
    n_ang = crem(hue[:, None, None] + xv * (360 // cc)
                 + (yv + dco[:, None, None]) * vert_step + 33, 360)
    b32 = (blank_level + sines[(n_ang + 359).long()] * burst_level) >> 5
    burst = b32.to(torch.int8)
    analog.fill_(blank_level)
    analog[:, :sep_row, sync_beg:sync_end] = sync_level
    analog[:, sep_row:, sync_beg:sep_end] = sync_level
    r0, nr, c0, nc = burst_box
    cls = (torch.arange(nr, device=dev) + r0) % vp
    t = (torch.arange(nc, device=dev) + c0) % cc
    analog[:, r0:r0 + nr, c0:c0 + nc] = burst[:, cls][:, :, t]
    ppu = ppu.to(torch.int32) & 0x1FF
    black_point = black_point[:, None, None]
    white_point = white_point[:, None, None]

    def to_ire(p, phase):
        ire = black_level + black_point + square_sum4(p, phase)
        return wrap_i8(cdiv(ire * white_point, 100) >> 12)  # crt_nes.c:190

    if draw_border:
        # rows box[0]..box[1]-1, columns box[2]..H, drawn before the picture
        # overwrites the middle; the first border column is pixel 0xf0
        nb0, nb1, c0 = box
        tb = torch.arange(H - c0, dtype=torch.int32, device=dev)
        phb = nes_phase(torch.arange(nb0, nb1, dtype=torch.int32,
                                     device=dev), dco, vp) + 6
        pb = torch.where(tb == 0, 0xF0, border_color[:, None, None] & 0x1FF)
        analog[:, nb0:nb1, c0:] = to_ire(pb, phb[..., None] + 3 * tb)

    sy = ((torch.arange(desth, device=dev) * h) // desth).clamp(max=h - 1)
    sx = (torch.arange(destw, device=dev) * w) // destw
    p = ppu[:, sy][:, :, sx]                              # (B, desth, destw)
    ph0 = nes_phase(torch.arange(desth, dtype=torch.int32, device=dev) + yo,
                    dco, vp)
    xphase = 3 * (torch.arange(destw, dtype=torch.int32, device=dev) % 4)
    return (fastpath.store_active(analog, to_ire(p, ph0[..., None] + xphase),
                                  xo, yo), b32 << 7)
