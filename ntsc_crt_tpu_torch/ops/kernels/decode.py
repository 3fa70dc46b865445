"""K2 ``decode_rows``, the per-line decode, and ``bloom_line_width``, the
bloom build's line energy.

Per (frame, line) row: sig[t] = concat(rows[b, row0 + l], rows[b, row0 + l
+ 1])[shift + t] (the reference's flat `sig[pos + i]` reads,
crt_core.c:538-543); Y = sig + bright, I/Q = sig * wave[t % cc] >> 9; an
EQ per channel — the 3-band equalizer (crt_core.c:206-233) or, with
``coefs=("conv", taps)``, the FIR of the USE_CONVOLUTION build
(crt_core.c:96-147, 4-sample chroma only); oy << 4, oi >> 3, oq >> 3; the
lerp scan conversion to outw pixels; YIQ -> RGB, contrast and clamp
(crt_core.c:555-611).

Bloom mode (``bloom_dx``/``bloom_lidx``, crt_core.c:512-532): row r draws
pixel p from samples t = max((p * dx[r]) >> 12, 0) and t + 1 instead of the
static map; the caller has folded the line's EQ start lidx into `shifts`
and the wave tables.  As in the TPU kernel (decode_fused.py:231-266) the EQ
runs on zero input from av_len to the next multiple of its 32-sample chunk
(40 for 5-sample chroma), both sources clamp to that length, and the right
source reads zero where t + 1 == av_len - 1 - lidx: the reference never
writes out[AV_LEN - 1].  Pixels past the drawn line are masked later, in
row placement.

Replaces ``ntsc_crt_tpu/ops/pallas/decode_fused.py::decode_fused_rows`` in
all three modes; ``bloom_line_width`` replaces the line sums and the
lax.scan of ``ntsc_crt_tpu/models/demodulate.py:869-887``.  A CPU tensor
runs the plain torch versions below (the portable decode of
``models/demodulate.py:983-1086``); a CUDA tensor launches csrc/decode.cu
(K2) or csrc/bloom.cu (``bloom_line_width``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ntsc_crt_tpu_torch.ops import fastpath, filters
from ntsc_crt_tpu_torch.ops.fixedpoint import cdiv
from ntsc_crt_tpu_torch.ops.kernels import rowfilters

# kernel launches since the last reset (read by chip_smoke.py), one count
# per mode: each launch adds to exactly one of the three decode counts
LAUNCHES = 0              # 3-band EQ, static scan conversion
CONV_LAUNCHES = 0         # convolution EQ, static scan conversion
BLOOM_LAUNCHES = 0        # bloom scan conversion, either EQ
LINE_WIDTH_LAUNCHES = 0   # bloom_line_width


def eq_len(av_len: int, cc: int) -> int:
    """Samples the bloom-mode EQ runs: av_len rounded up to the TPU
    kernel's chunk (decode_fused.py:68-72, 302-303)."""
    chunk = 32 if cc == 4 else 40
    return -(-av_len // chunk) * chunk


def _eq_code(coefs) -> tuple[int, list[int]]:
    """(eq selector, host ints) as ntsc_decode_rows takes them."""
    if coefs[0] == "conv":
        weights, shift = filters._CONV_EQ_KERNELS[coefs[1]]
        return coefs[1], [*weights, shift]
    return 0, [int(v) for c in coefs for v in c]


def decode_rows(rows: torch.Tensor, shifts: torch.Tensor, waveI: torch.Tensor,
                waveQ: torch.Tensor, bright: torch.Tensor,
                contrast: torch.Tensor, *, row0: int, coefs, av_len: int,
                outw: int, bloom_dx: torch.Tensor = None,
                bloom_lidx: torch.Tensor = None) -> torch.Tensor:
    """rows int8 (B, NR, H) with NR >= row0 + L + 1; shifts int32 (B, L),
    each line's active-video start; waveI/waveQ int32 (B, L, cc), cc = 4 or
    5; bright/contrast int32 (B, L); coefs three filters.EQCoefs (Y, I, Q)
    or ("conv", taps) with taps 4..7 (cc = 4 only); bloom_dx/bloom_lidx
    int32 (B, L), together, for bloom mode.  Returns uint8 (B, L, outw, 3).
    Samples past the two rows read as 0."""
    conv = coefs[0] == "conv"
    if conv and coefs[1] not in filters._CONV_EQ_KERNELS:
        raise ValueError(f"decode_rows: no {coefs[1]}-tap convolution EQ")
    if (bloom_dx is None) != (bloom_lidx is None):
        raise ValueError("decode_rows: bloom_dx and bloom_lidx go together")
    if rows.device.type == "cpu":
        return decode_rows_plain(rows, shifts, waveI, waveQ, bright, contrast,
                                 row0=row0, coefs=coefs, av_len=av_len,
                                 outw=outw, bloom_dx=bloom_dx,
                                 bloom_lidx=bloom_lidx)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    global LAUNCHES, CONV_LAUNCHES, BLOOM_LAUNCHES
    dev = rows.device
    B, NR, H = rows.shape
    L, cc = shifts.shape[1], waveI.shape[2]
    build.check("rows", rows, torch.int8, (B, NR, H), dev)
    build.check("shifts", shifts, torch.int32, (B, L), dev)
    build.check("waveI", waveI, torch.int32, (B, L, cc), dev)
    build.check("waveQ", waveQ, torch.int32, (B, L, cc), dev)
    build.check("bright", bright, torch.int32, (B, L), dev)
    build.check("contrast", contrast, torch.int32, (B, L), dev)
    bloom = bloom_dx is not None
    if bloom:
        build.check("bloom_dx", bloom_dx, torch.int32, (B, L), dev)
        build.check("bloom_lidx", bloom_lidx, torch.int32, (B, L), dev)
    if cc not in (4, 5) or (conv and cc != 4):
        raise ValueError(f"decode_rows: cc must be 4 or 5 (4 with the "
                         f"convolution EQ), got {cc}")
    if not (row0 >= 0 and NR >= row0 + L + 1 and 2 <= av_len <= H
            and outw >= 1):
        raise ValueError(f"decode_rows: bad geometry NR={NR} row0={row0} "
                         f"L={L} H={H} av_len={av_len} outw={outw}")
    out = torch.empty((B, L, outw, 3), dtype=torch.uint8, device=dev)
    eq, ints = _eq_code(coefs)
    k = (ctypes.c_int * len(ints))(*ints)
    build.launch("ntsc_decode_rows", dev, rows.data_ptr(), shifts.data_ptr(),
                 waveI.data_ptr(), waveQ.data_ptr(), bright.data_ptr(),
                 contrast.data_ptr(), bloom_dx.data_ptr() if bloom else None,
                 bloom_lidx.data_ptr() if bloom else None, ctypes.addressof(k),
                 out.data_ptr(), B, L, NR, H, row0, av_len,
                 eq_len(av_len, cc) if bloom else av_len, outw, cc, eq)
    if bloom:
        BLOOM_LAUNCHES += 1
    elif conv:
        CONV_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def decode_rows_plain(rows, shifts, waveI, waveQ, bright, contrast, *,
                      row0: int, coefs, av_len: int, outw: int,
                      bloom_dx=None, bloom_lidx=None) -> torch.Tensor:
    """The same decode in plain torch: align, demodulate, one vectorised EQ
    march over every row and channel, gather-lerp, YIQ -> RGB."""
    B, L = shifts.shape
    H, cc = rows.shape[2], waveI.shape[2]
    bloom = bloom_dx is not None
    n = eq_len(av_len, cc) if bloom else av_len
    ext = torch.cat([rows[:, row0:row0 + L], rows[:, row0 + 1:row0 + L + 1]],
                    dim=2).reshape(B * L, 2 * H)
    sig = fastpath.shift_rows(ext, shifts.reshape(-1),
                              av_len).reshape(B, L, av_len)
    sig = torch.nn.functional.pad(sig, (0, n - av_len))
    wv_i = fastpath.tile_period(waveI, n)
    wv_q = fastpath.tile_period(waveQ, n)
    stacked = torch.stack([sig + bright[..., None], (sig * wv_i) >> 9,
                           (sig * wv_q) >> 9], dim=2)    # (B, L, 3, n)
    if coefs[0] == "conv":
        eqd = filters.eq_convolution(stacked, coefs[1])
    else:
        per_chan = [torch.tensor([c[k] for c in coefs], dtype=torch.int32,
                                 device=rows.device) for k in range(5)]
        eqd = rowfilters.eq_threeband_rows_plain(stacked, *per_chan)
    oy, oi, oq = eqd[:, :, 0] << 4, eqd[:, :, 1] >> 3, eqd[:, :, 2] >> 3
    if bloom:
        p = torch.arange(outw, dtype=torch.int32, device=rows.device)
        pos = p * bloom_dx[..., None]                     # (B, L, outw)
        t = (pos >> 12).clamp(min=0)
        ia = t.clamp(max=n - 1).long()
        ib = (t + 1).clamp(max=n - 1).long()
        zero = t + 1 == (av_len - 1 - bloom_lidx)[..., None]
        Rw = pos & 0xFFF
        Lw = 0xFFF - Rw

        def lerp(v, sh):
            a = torch.gather(v, 2, ia)
            b = torch.where(zero, 0, torch.gather(v, 2, ib))
            return ((a * Lw) >> sh) + ((b * Rw) >> sh)

        yv, iv, qv = lerp(oy, 2), lerp(oi, 14), lerp(oq, 14)
    else:
        yv = fastpath.lerp_resample(oy, outw, 2)
        iv = fastpath.lerp_resample(oi, outw, 14)
        qv = fastpath.lerp_resample(oq, outw, 14)
    ct = contrast[..., None]
    r = (((yv + 3879 * iv + 2556 * qv) >> 12) * ct) >> 8
    g = (((yv - 1126 * iv - 2605 * qv) >> 12) * ct) >> 8
    b = (((yv - 4530 * iv + 7021 * qv) >> 12) * ct) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def decode_rows_plain_any_shift(rows, shifts, waveI, waveQ, bright, contrast,
                                **kw) -> torch.Tensor:
    """decode_rows_plain for shifts below 0 as well (it takes shifts >= 0),
    the reference the kernel is held to at such shifts: every line becomes
    a frame of its own whose two field rows hold D zeros, D >=
    -min(shifts), then the line's two rows, and its shift moves D later.
    The kernel reads 0 before a line's first sample as after its second
    row."""
    B, L = shifts.shape
    H, row0 = rows.shape[2], kw["row0"]
    D = 2 * max(0, -int(shifts.min()))
    ext = torch.cat([rows[:, row0:row0 + L], rows[:, row0 + 1:row0 + L + 1]],
                    dim=2)
    ext = torch.nn.functional.pad(ext, (D, 0)).reshape(B * L, 2, H + D // 2)
    one = lambda v: v.reshape(B * L, 1, *v.shape[2:])  # noqa: E731
    kw = {n: one(v) if torch.is_tensor(v) else v for n, v in kw.items()}
    out = decode_rows_plain(ext, one(shifts + D), one(waveI), one(waveQ),
                            one(bright), one(contrast), **dict(kw, row0=0))
    return out.reshape(B, L, *out.shape[2:])


def bloom_steps(rng: np.random.Generator, B: int, L: int, av_len: int,
                outw: int, cc: int) -> dict:
    """Bloom tables that reach every rule of the bloom walk, for holding
    the kernel to its plain version: per row an EQ start lidx and a pixel
    step dx of one of five kinds — the decoder's (near the drawn width),
    past the EQ's end (meets the forced-zero sample, clamps at n_eq - 1),
    0, negative, any int32 (p * dx wraps) — the last three moving the
    source back.  int32 numpy arrays (B, L) under bloom_dx / bloom_lidx."""
    lidx = rng.integers(2, 12, (B, L))
    width = av_len - 2 * lidx + rng.integers(-6, 7, (B, L))
    n_eq = eq_len(av_len, cc)
    kinds = np.stack([(width << 12) // outw,
                      np.full((B, L), ((n_eq + 6) << 12) // outw),
                      np.zeros((B, L), np.int64),
                      -rng.integers(1, 1 << 14, (B, L)),
                      rng.integers(-2**31, 2**31, (B, L))])
    dx = np.take_along_axis(kinds, rng.integers(0, 5, (1, B, L)), 0)[0]
    return dict(bloom_dx=dx.astype(np.int32),
                bloom_lidx=lidx.astype(np.int32))


def bloom_line_width(rows: torch.Tensor, xpos_l: torch.Tensor,
                     max_e: torch.Tensor, *, row0: int,
                     av_len: int) -> torch.Tensor:
    """The beam-energy EMA of the bloom build with the line sums that drive
    it (crt_core.c:512-520).  Line l's sum s is the sum of field row
    row0 + l over [xpos, xpos + av_len) clipped to the row, plus row
    row0 + l + 1 over [0, xpos + av_len - H) (the spill); then prev_e =
    prev_e*123/128 + (((max_e >> 1) - s) << 10) / max_e per line, from
    16384/8, C truncating divisions in wrapping int32.  rows int8 (B, NR,
    H), NR >= row0 + L + 1; xpos_l int32 (B, L); max_e int32 (B,).  Returns
    prev_e int32 (B, L).  A zero max_e divides to -1, as XLA defines it.
    A CUDA tensor launches csrc/bloom.cu."""
    if rows.device.type == "cpu":
        return bloom_line_width_plain(rows, xpos_l, max_e, row0=row0,
                                      av_len=av_len)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    global LINE_WIDTH_LAUNCHES
    dev = rows.device
    B, NR, H = rows.shape
    L = xpos_l.shape[-1]
    build.check("rows", rows, torch.int8, (B, NR, H), dev)
    build.check("xpos_l", xpos_l, torch.int32, (B, L), dev)
    build.check("max_e", max_e, torch.int32, (B,), dev)
    if not (B >= 1 and L >= 1 and H >= 1 and 0 <= row0
            and NR >= row0 + L + 1):
        raise ValueError(f"bloom_line_width: bad sizes B={B} L={L} NR={NR} "
                         f"H={H} row0={row0}")
    if rows.data_ptr() % 16:
        raise ValueError("bloom_line_width: rows must be 16-byte aligned")
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    build.launch("ntsc_bloom_line_width", dev, rows.data_ptr(),
                 xpos_l.data_ptr(), max_e.data_ptr(), out.data_ptr(), B, L,
                 NR, H, row0, av_len)
    LINE_WIDTH_LAUNCHES += 1
    return out


def _cdiv_total(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """cdiv with d == 0 giving -1 and INT_MIN / -1 giving INT_MIN."""
    odd = (d == 0) | (d == -1)
    q = cdiv(a, torch.where(odd, 1, d))
    return torch.where(d == 0, -1, torch.where(d == -1, -a, q))


def bloom_ema_plain(sums: torch.Tensor, max_e: torch.Tensor) -> torch.Tensor:
    """The EMA chain from the line sums, a torch loop over the lines."""
    drive = _cdiv_total(((max_e[:, None] >> 1) - sums) << 10,
                        max_e[:, None].expand_as(sums))
    e = torch.full_like(max_e, 16384 // 8)
    out = torch.empty_like(sums)
    for l in range(sums.shape[1]):
        e = cdiv(e * 123, 128) + drive[:, l]
        out[:, l] = e
    return out


def bloom_line_width_plain(rows: torch.Tensor, xpos_l: torch.Tensor,
                           max_e: torch.Tensor, *, row0: int,
                           av_len: int) -> torch.Tensor:
    """bloom_line_width in plain torch: each line's sum by two masked passes
    over the rows, as the JAX decoder forms its s_sum (demodulate.py:
    869-878), then the chain."""
    L, H = xpos_l.shape[-1], rows.shape[-1]
    iota = torch.arange(H, dtype=torch.int32, device=rows.device)
    xa = xpos_l[..., None]                                # (B, L, 1)
    in_w = (iota >= xa) & (iota < xa + av_len)
    in_spill = iota < xa + av_len - H
    sums = (torch.where(in_w, rows[:, row0:row0 + L], 0).sum(
                2, dtype=torch.int32)
            + torch.where(in_spill, rows[:, row0 + 1:row0 + L + 1], 0).sum(
                2, dtype=torch.int32))
    return bloom_ema_plain(sums, max_e)
