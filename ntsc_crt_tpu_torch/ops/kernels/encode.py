"""K1 ``encode_rows``: the active-video encode of every picture row.

Per output row (b, y) and sample t: the nearest-neighbour source pixel
img[b, sy[b, y], t*w // destw] goes RGB -> YIQ (crt_ntsc.c:307-310), through
the per-channel 1-pole IIR bandlimit (crt_ntsc.c:117-126), I/Q times the
carrier table at phase (t + xo) % cc then >> 4 (crt_ntsc.c:316-317), and
ire = base + ((y + i + q) * gain >> 10) clamped to 0..110 (crt_ntsc.c:318).

Replaces ``ntsc_crt_tpu/ops/pallas/encode_fused.py::encode_fused_rows``.  A
CPU tensor runs the plain torch version below (the portable encode of
``models/modulate.py:424-434``); a CUDA tensor launches csrc/encode.cu.
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops import fastpath
from ntsc_crt_tpu_torch.ops.kernels import rowfilters

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0


def rgb_to_yiq(pix: torch.Tensor):
    """crt_ntsc.c:307-310 — int32 elementwise over (..., 3) pixels."""
    r, g, b = pix[..., 0], pix[..., 1], pix[..., 2]
    fy = (19595 * r + 38470 * g + 7471 * b) >> 14
    fi = (39059 * r - 18022 * g - 21103 * b) >> 14
    fq = (13894 * r - 34275 * g + 20382 * b) >> 14
    return fy, fi, fq


def encode_rows(img: torch.Tensor, sy: torch.Tensor, modI: torch.Tensor,
                modQ: torch.Tensor, gain: torch.Tensor, base: torch.Tensor,
                *, coefs, xo_mod: int, destw: int) -> torch.Tensor:
    """img uint8 (B, h, w, 3); sy int32 (B, desth) source row of each output
    row; modI/modQ int32 (B, desth, cc) carrier tables of each row with the
    phase sign folded in (cc = 4 or 5); gain/base int32 (B,); coefs
    (cY, cI, cQ) ints, or None without bandlimiting; xo_mod = xo % cc.
    Returns int8 (B, desth, destw).
    """
    if img.device.type == "cpu":
        return encode_rows_plain(img, sy, modI, modQ, gain, base,
                                 coefs=coefs, xo_mod=xo_mod, destw=destw)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    global LAUNCHES
    dev = img.device
    B, h, w = img.shape[0], img.shape[1], img.shape[2]
    desth, cc = sy.shape[1], modI.shape[-1]
    build.check("img", img, torch.uint8, (B, h, w, 3), dev)
    build.check("sy", sy, torch.int32, (B, desth), dev)
    build.check("modI", modI, torch.int32, (B, desth, cc), dev)
    build.check("modQ", modQ, torch.int32, (B, desth, cc), dev)
    build.check("gain", gain, torch.int32, (B,), dev)
    build.check("base", base, torch.int32, (B,), dev)
    if cc not in (4, 5):
        raise ValueError(f"encode_rows: cc must be 4 or 5, got {cc}")
    out = torch.empty((B, desth, destw), dtype=torch.int8, device=dev)
    cY, cI, cQ = coefs if coefs is not None else (0, 0, 0)
    build.launch("ntsc_encode_rows", dev, img.data_ptr(), sy.data_ptr(),
                 modI.data_ptr(), modQ.data_ptr(), gain.data_ptr(),
                 base.data_ptr(), out.data_ptr(), B, h, w, desth, destw, cc,
                 xo_mod, int(coefs is not None), cY, cI, cQ)
    LAUNCHES += 1
    return out


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
        yiq = rowfilters.iir_lowpass_rows_plain(
            torch.stack([fy, fi, fq], dim=-2),
            torch.tensor(coefs, dtype=torch.int32, device=dev))
        fy, fi, fq = yiq.unbind(-2)
    fi = (fi * fastpath.tile_period(modI, destw, xo_mod)) >> 4
    fq = (fq * fastpath.tile_period(modQ, destw, xo_mod)) >> 4
    ire = base[:, None, None] + (((fy + fi + fq) * gain[:, None, None]) >> 10)
    return ire.clamp(0, 110).to(torch.int8)
