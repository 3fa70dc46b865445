"""K13 ``nes_square``: NES's square-wave encoder pass (crt_nes.c:106-201).

For every slot the pass writes every sample of the analog field in place,
in the reference's order (a later source wins):

- the skeleton (setup_field, crt_nes.c:81-104): blank, with sync over
  [sync_beg, sync_end) of each row, [sync_beg, sep_end) from row sep_row on;
- the colour burst over burst_box (crt_nes.c:123-130): at row class y =
  row % vp and column class k = column % cc, (blank_level + sine(n) *
  burst_level) >> 5 for the angle n = (hue + 360 / cc * k + (y + dco) *
  vert_step + 33) % 360 with C's %; the pass also returns it << 7, the ccf
  export;
- with draw_border, the border (NES_BORDER, crt_nes.c:138-161): rows
  box[0] .. box[1] - 1, columns box[2] .. H - 1, pixel 0xF0 in the first
  column and border_color & 0x1FF after it, at phase ph(row) + 6 +
  3*(column - box[2]);
- the picture: sample (y, x), y < desth, x < destw, reads the PPU pixel
  p = ppu[b, sy, sx] & 0x1FF (sy = min(y*h // desth, h - 1), sx = x*w //
  destw) at phase ph(yo + y) + 3*(x % 4), where ph(row) = 4 * ((row + dco)
  % vp) with C's %, a negative class reading 0; with S the sum of
  square_sample over four consecutive phases (crt_nes.c:21-61), it stores
  the C signed-char wrap of cdiv((black_level + black_point + S) *
  white_point, 100) >> 12 in wrapping int32 (crt_nes.c:190) at the flat
  field offset (yo + y)*H + xo + x (``fastpath.store_active``'s indexing: a
  row past H spills into the next row, offsets past the field are
  dropped).

No Pallas kernel: the JAX package leaves the pass to XLA
(``ntsc_crt_tpu/models/modulate.py:755`` ``_nes_square_sum4`` and ``:818``
``modulate_nes``), evaluating square_sample in closed form and resampling
through one-hot matmuls, as a TPU has no cheap gather.  square_sample reads
only bits 0-8 of the pixel and the phase mod 12, so the kernel looks the
4-phase sum up in a 512 x 12 table (``square_table``, cached per card), and
the burst's sines in a 719-entry one (``burst_sines``).  A CPU tensor runs
``nes_square_plain``, the closed form in plain torch, which reads no square
table; a CUDA tensor launches csrc/nes.cu.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ntsc_crt_tpu_torch.ops import fastpath
from ntsc_crt_tpu_torch.ops.fixedpoint import cdiv, crem, sincos14


# amplified IRE levels (crt_nes.c:26-40) as [l][e][lum]
_NES_T = np.array(
    [-12042, 0, 34406, 81427,          # 0d 1d 2d 3d
     -17203, -8028, 19497, 57342,      # emphasized
     43581, 75693, 112965, 112965,     # 00 10 20 30
     26951, 52181, 83721, 83721],      # emphasized
    dtype=np.int64).reshape(2, 2, 4)
# the emphasis bits active at phase class (phase >> 1) % 6 (crt_nes.c:26-30)
_NES_ACTIVE = np.array([0o300, 0o100, 0o500, 0o400, 0o600, 0o200])
MAX_DESTW = 4096       # csrc/nes.cu tabulates sx in shared memory


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


def _check(analog, ppu, table, params, sines, *, xo, yo, destw, desth, box,
           vp, skeleton, burst_box, cc):
    B, V, H = analog.shape
    sync_beg, sync_end, _, sep_end = skeleton[:4]
    r0, nr, c0, nc = burst_box
    if not (tuple(sines.shape) == (719,) and 1 <= cc <= 360
            and 1 <= vp * cc <= 64 and 0 <= sync_beg <= sync_end <= H
            and sync_beg <= sep_end <= H and 0 <= r0 and 0 <= nr
            and r0 + nr <= V and 0 <= c0 and 0 <= nc and c0 + nc <= H):
        raise ValueError(f"nes_square: bad skeleton {skeleton}, burst "
                         f"classes {vp} x {cc} or burst_box {burst_box}")
    if not (ppu.dim() == 3 and ppu.shape[0] == B
            and 1 <= ppu.shape[1] <= 65535 and 1 <= ppu.shape[2] <= 65535
            and ppu.shape[1] * ppu.shape[2] < 2**31):
        raise ValueError(f"nes_square: ppu {tuple(ppu.shape)} is not "
                         f"(B={B}, h, w) with 1 <= h, w <= 65535, h*w < 2^31")
    if not (1 <= destw <= min(H, MAX_DESTW) and 1 <= desth <= 32767
            and 0 <= xo < H and 0 <= yo < V and 1 <= vp <= 1 << 20
            and 0 <= box[0] <= box[1] <= V and 0 <= box[2] < H):
        raise ValueError(f"nes_square: bad geometry V={V} H={H} xo={xo} "
                         f"yo={yo} destw={destw} desth={desth} vp={vp} "
                         f"box={box}")
    if tuple(table.shape) != (512, 12) or any(
            tuple(t.shape) != (B,) for t in params):
        raise ValueError("nes_square: table must be (512, 12) and the knobs "
                         f"(B={B},)")


def nes_square(analog: torch.Tensor, ppu: torch.Tensor, table: torch.Tensor,
               dco: torch.Tensor, black_point: torch.Tensor,
               white_point: torch.Tensor, border_color: torch.Tensor,
               hue: torch.Tensor, sines: torch.Tensor, *, xo: int, yo: int,
               destw: int, desth: int, draw_border: bool,
               box: tuple[int, int, int], vp: int, black_level: int,
               skeleton: tuple, burst_box: tuple, cc: int, vert_step: int,
               burst_level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """analog int8 (B, V, H), every sample written in place (what it held
    is not read); ppu (B, h, w) PPU pixels (uint16; any integer type, of
    which bits 0-8 are read); table int32 (512, 12), square_table(); dco,
    black_point, white_point, border_color, hue int32 (B,); sines int32
    (719,), burst_sines(); the picture at (yo, xo), destw <= H wide and
    desth rows; box = (first row, end row, first column) of the border,
    drawn if draw_border; vp the dot-crawl period; skeleton = (sync_beg,
    sync_end, sep_row, sep_end, sync_level, blank_level); burst_box =
    (first row, rows, first column, columns), cc its column classes,
    vert_step and burst_level its angle step and level.  Returns (analog,
    the ccf export int32 (B, vp, cc))."""
    params = (dco, black_point, white_point, border_color, hue)
    _check(analog, ppu, table, params, sines, xo=xo, yo=yo, destw=destw,
           desth=desth, box=box, vp=vp, skeleton=skeleton,
           burst_box=burst_box, cc=cc)
    kw = dict(xo=xo, yo=yo, destw=destw, desth=desth, draw_border=draw_border,
              box=box, vp=vp, black_level=black_level, skeleton=skeleton,
              burst_box=burst_box, cc=cc, vert_step=vert_step,
              burst_level=burst_level)
    if analog.device.type == "cpu":
        return nes_square_plain(analog, ppu, table, *params, sines, **kw)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = analog.device
    B, V, H = analog.shape
    h, w = ppu.shape[1], ppu.shape[2]
    if ppu.dtype not in (torch.uint16, torch.int16):
        ppu = (ppu.to(torch.int32) & 0x1FF).to(torch.int16)
    ppu = ppu.contiguous()
    build.check("analog", analog, torch.int8, (B, V, H), dev)
    build.check("ppu", ppu, ppu.dtype, (B, h, w), dev)
    build.check("table", table, torch.int32, (512, 12), dev)
    for name, t in zip(("dco", "black_point", "white_point", "border_color",
                        "hue"), params):
        build.check(name, t, torch.int32, (B,), dev)
    build.check("sines", sines, torch.int32, (719,), dev)
    ccf = torch.empty((B, vp, cc), dtype=torch.int32, device=dev)
    build.launch("ntsc_nes_square", dev, analog.data_ptr(), ppu.data_ptr(),
                 table.data_ptr(), *(t.data_ptr() for t in params),
                 sines.data_ptr(), ccf.data_ptr(), B, V, H, h, w, xo, yo,
                 destw, desth, vp, black_level, int(draw_border), *box,
                 *skeleton, *burst_box, cc, vert_step, burst_level)
    return analog, ccf


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
