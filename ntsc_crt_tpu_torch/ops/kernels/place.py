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
"""

from __future__ import annotations

import torch

# kernel launches since the last reset (read by chip_smoke.py), one count
# per mode
LAUNCHES = 0              # every pixel drawn
BLOOM_LAUNCHES = 0        # bloom: each line's drawn width from (dx, scan)


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

    global LAUNCHES, BLOOM_LAUNCHES
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
                 av_len if bloom else 0)
    if bloom:
        BLOOM_LAUNCHES += 1
    else:
        LAUNCHES += 1
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
