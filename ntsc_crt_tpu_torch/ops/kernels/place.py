"""K6 ``place_rows_uniform``: row placement when every line covers `ratio`
output rows.

The reference stores each decoded line at its `beg` row, duplicates it up
to `end - scanlines`, optionally 50/50-blending against the previous frame
(crt_core.c:552-664).  With outh == ratio * L and host-known knobs this is
the stacked form of ``ntsc_crt_tpu/models/demodulate.py::_place_rows_uniform``
(:1183-1226): output row r = ratio*k + j reads line k - (j < fp and the
frame is an odd field), blends against old[beg], and keeps the previous
contents in the scanline gap and at the odd field's top and bottom clips.

Bloom mode (``bloom_dx``/``bloom_scan``, crt_core.c:512-555): pixel p of
line k is drawn iff scan[k] + p * dx[k] < (av_len - 1) << 12 in wrapping
int32 (the reference's loop bound); a pixel not drawn keeps the previous
contents of its source line's `beg` row — the row the blend reads — in the
line's row and its duplicates.  This is what the general placement does
with the `valid` plane (``ntsc_crt_tpu/models/demodulate.py:1314-1319``),
which the JAX package leaves to XLA's gathers.

Replaces ``ntsc_crt_tpu/ops/pallas/place_rows.py::place_rows_uniform`` and
``place_rows_uniform_tiled``.  A CPU tensor runs the plain torch version
below (the stacked form); a CUDA tensor launches csrc/place.cu.

``place_rows_general`` is K6's general mode, the placement off that gate
(any outh: the live 832x624 window's 624 rows of 240 lines, v_fac, a
downscale; blend and scanlines per slot): each output row takes the last
line that covers it, ``models/demodulate.py::_place_rows_general``, which
is its plain version on a CPU tensor (with ``bloom_drawn``'s `valid`
plane in bloom mode); a CUDA tensor launches csrc/place.cu's
``ntsc_place_rows_general``, which works out each row's line itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ntsc_crt_tpu_torch.ops.fixedpoint import host_i32


def place_rows_uniform(rgb: torch.Tensor, old: torch.Tensor,
                       field_px: torch.Tensor, *, blend: bool,
                       scanlines: int, ratio: int, fp: int,
                       bloom_dx: torch.Tensor = None,
                       bloom_scan: torch.Tensor = None,
                       av_len: int = None) -> torch.Tensor:
    """rgb uint8 (B, L, w, 3) decoded lines; old uint8 (B, ratio*L, w, 3)
    the previous output; field_px int32 (B,), > 0 on an odd field; blend,
    0 <= scanlines < ratio and the odd-field shift 0 <= fp < ratio are host
    values; bloom_dx/bloom_scan int32 (B, L) and the host av_len, together,
    for bloom mode.  Returns the new uint8 (B, ratio*L, w, 3) output."""
    if not (ratio >= 1 and 0 <= scanlines < ratio and 0 <= fp < ratio):
        raise ValueError(f"place_rows_uniform: bad ratio={ratio} "
                         f"scanlines={scanlines} fp={fp}")
    bloom = bloom_dx is not None
    if bloom != (bloom_scan is not None) or bloom != (av_len is not None):
        raise ValueError("place_rows_uniform: bloom_dx, bloom_scan and "
                         "av_len go together")
    kw = dict(blend=blend, scanlines=scanlines, ratio=ratio, fp=fp,
              bloom_dx=bloom_dx, bloom_scan=bloom_scan, av_len=av_len)
    if rgb.device.type == "cpu":
        return place_rows_uniform_plain(rgb, old, field_px, **kw)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = rgb.device
    B, L, w, _ = rgb.shape
    build.check("rgb", rgb, torch.uint8, (B, L, w, 3), dev)
    build.check("old", old, torch.uint8, (B, ratio * L, w, 3), dev)
    build.check("field_px", field_px, torch.int32, (B,), dev)
    if bloom:
        build.check("bloom_dx", bloom_dx, torch.int32, (B, L), dev)
        build.check("bloom_scan", bloom_scan, torch.int32, (B, L), dev)
        if not 1 <= av_len <= 1 << 19:     # (av_len - 1) << 12 fits int32
            raise ValueError(f"place_rows_uniform: bad av_len={av_len}")
    out = torch.empty_like(old)
    build.launch("ntsc_place_rows_uniform", dev, rgb.data_ptr(),
                 old.data_ptr(), field_px.data_ptr(),
                 bloom_dx.data_ptr() if bloom else None,
                 bloom_scan.data_ptr() if bloom else None, out.data_ptr(), B,
                 L, ratio, w * 3, fp, int(bool(blend)), scanlines,
                 av_len if bloom else 0, mode="bloom" if bloom else None)
    return out


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


def place_rows_general(rgb: torch.Tensor, old: torch.Tensor,
                       beg_l: torch.Tensor, end_l: torch.Tensor,
                       active_l: torch.Tensor, *, blend, scanlines,
                       bloom_dx: torch.Tensor = None,
                       bloom_scan: torch.Tensor = None,
                       av_len: int = None) -> torch.Tensor:
    """rgb uint8 (B, L, w, 3) decoded lines; old uint8 (B, outh, w, 3) the
    previous output; beg_l, end_l int32 (B, L) each line's first row and
    the row past its last, active_l bool (B, L); blend and scanlines each a
    host int or an int32 (B,) tensor; bloom_dx/bloom_scan int32 (B, L) and
    the host av_len, together, for bloom lines.  Returns the new uint8 (B,
    outh, w, 3) output: row r takes the last active line l with beg_l <= r
    < max(beg_l + 1, min(end_l, outh) - scanlines), or keeps old's row."""
    B, L, w, _ = rgb.shape
    outh = old.shape[1]
    want = dict(rgb=(rgb, torch.uint8, (B, L, w, 3)),
                old=(old, torch.uint8, (B, outh, w, 3)),
                beg_l=(beg_l, torch.int32, (B, L)),
                end_l=(end_l, torch.int32, (B, L)),
                active_l=(active_l, torch.bool, (B, L)))
    for name, x in (("blend", blend), ("scanlines", scanlines)):
        if torch.is_tensor(x):
            want[name] = (x, torch.int32, (B,))
        elif not isinstance(x, (int, np.integer)):
            raise TypeError(f"place_rows_general: {name} must be a host int "
                            f"or an int32 (B,) tensor, got {type(x)}")
    bloom = bloom_dx is not None
    if bloom != (bloom_scan is not None) or bloom != (av_len is not None):
        raise ValueError("place_rows_general: bloom_dx, bloom_scan and "
                         "av_len go together")
    if bloom:
        want.update(bloom_dx=(bloom_dx, torch.int32, (B, L)),
                    bloom_scan=(bloom_scan, torch.int32, (B, L)))
        if not 1 <= av_len <= 1 << 19:     # (av_len - 1) << 12 fits int32
            raise ValueError(f"place_rows_general: bad av_len={av_len}")
    if min(L, outh, w) < 1:
        raise ValueError(f"place_rows_general: bad L={L} outh={outh} w={w}")
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"place_rows_general: {name} must be {dtype} "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    kw = dict(blend=blend, scanlines=scanlines, bloom_dx=bloom_dx,
              bloom_scan=bloom_scan, av_len=av_len)
    if rgb.device.type == "cpu":
        return place_rows_general_plain(rgb, old, beg_l, end_l, active_l,
                                        **kw)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = rgb.device
    for name, (x, dtype, shape) in want.items():
        build.check(name, x, dtype, shape, dev)

    def knob(x):        # (pointer, host value)
        return (x.data_ptr(), 0) if torch.is_tensor(x) else (None,
                                                             host_i32(x))
    (blend_p, blend_i), (scan_p, scan_i) = knob(blend), knob(scanlines)
    out = torch.empty_like(old)
    build.launch("ntsc_place_rows_general", dev, rgb.data_ptr(),
                 old.data_ptr(), beg_l.data_ptr(), end_l.data_ptr(),
                 active_l.data_ptr(), blend_p, scan_p,
                 bloom_dx.data_ptr() if bloom else None,
                 bloom_scan.data_ptr() if bloom else None, out.data_ptr(), B,
                 L, outh, w * 3, blend_i, scan_i, av_len if bloom else 0,
                 mode="bloom" if bloom else None)
    return out


def place_rows_general_plain(rgb, old, beg_l, end_l, active_l, *, blend,
                             scanlines, bloom_dx=None, bloom_scan=None,
                             av_len: int = None) -> torch.Tensor:
    """``demodulate._place_rows_general`` with the same arguments as
    place_rows_general; bloom lines become its `valid` plane
    (``demodulate.bloom_drawn``)."""
    from ntsc_crt_tpu_torch.models import demodulate as dem  # it imports us

    valid = (None if bloom_dx is None else
             dem.bloom_drawn(bloom_dx, bloom_scan, av_len, rgb.shape[2]))
    return dem._place_rows_general(rgb, old, beg_l, end_l, active_l, blend,
                                   scanlines, old.shape[1], valid=valid)
