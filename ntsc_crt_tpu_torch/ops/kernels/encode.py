"""K1 ``encode_rows``: the active-video encode of every picture row.

Per output row (b, y) and sample t: the nearest-neighbour source pixel
img[b, sy[b, y], t*w // destw] goes RGB -> YIQ (crt_ntsc.c:307-310), through
the per-channel 1-pole IIR bandlimit (crt_ntsc.c:117-126), I/Q times the
carrier table at phase (t + xo) % cc then >> 4 (crt_ntsc.c:316-317), and
ire = base + ((y + i + q) * gain >> 10) clamped to 0..110 (crt_ntsc.c:318).

Replaces ``ntsc_crt_tpu/ops/pallas/encode_fused.py::encode_fused_rows``.  A
CPU tensor runs the plain torch version below (the portable encode of
``models/modulate.py:424-434``); a CUDA tensor launches csrc/encode.cu.

``encode_field`` is K1's field mode: the same rows, stored with the rest of
the RGB encoders' field (skeleton, burst by row class, VHS's sync kill, the
caller's kept samples) by one launch into a fresh field.  Its plain version
is the assembly the torch passes make around the block
(``assemble_field``).
"""

from __future__ import annotations

import torch

from ntsc_crt_tpu_torch.ops import fastpath
from ntsc_crt_tpu_torch.ops.kernels import rowfilters


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


def encode_field(img, sy, modI, modQ, gain, base, analog, skel, mask_end,
                 vrows, parity, burst, kill, *, coefs, xo: int, yo: int,
                 destw: int, cb_beg: int, bw_beg: int,
                 blank: int) -> torch.Tensor:
    """K1's field mode: a new int8 field (B, V, H) holding, byte by byte in
    this order of precedence, VHS's sync kill (`blank` on the first bw_beg
    samples of the killed rows), the picture (K1's rows of encode_rows's
    first six arguments, stored from (yo, xo) with the reference's flat
    spill and clip, fastpath.store_active), the burst (on `vrows`), the
    skeleton of the frame's parity (on the first mask_end[r] samples of row
    r), and the caller's field.  analog int8 (B, V, H), read only; skel int8
    (2, V, H), the even and odd parity's skeletons; mask_end int32 (V,), the
    skeleton's write mask as each row's prefix; vrows bool (V,), the rows that
    carry the burst (and can be killed); parity int32 (B,) 0 or 1; burst
    int8 (B, P, burst_len) from column cb_beg, row r taking burst[:, r % P]
    (P = 1 for the NTSC family, cc_vper for the encoders whose burst
    varies by row); kill int32 (B,), each frame's killed bottom rows (rows
    >= V - kill among vrows), or None.  The kernel takes 4- or 5-sample
    chroma, 0 <= xo < H, 0 <= yo and destw < H."""
    if img.device.type == "cpu":
        return encode_field_plain(
            img, sy, modI, modQ, gain, base, analog, skel, mask_end,
            vrows, parity, burst, kill, coefs=coefs, xo=xo, yo=yo, destw=destw,
            cb_beg=cb_beg, bw_beg=bw_beg, blank=blank)
    from ntsc_crt_tpu_torch.ops.kernels import build  # CUDA path only

    dev = img.device
    B, h, w = img.shape[0], img.shape[1], img.shape[2]
    desth, cc = sy.shape[1], modI.shape[-1]
    V, H = analog.shape[1], analog.shape[2]
    build.check("img", img, torch.uint8, (B, h, w, 3), dev)
    build.check("sy", sy, torch.int32, (B, desth), dev)
    build.check("modI", modI, torch.int32, (B, desth, cc), dev)
    build.check("modQ", modQ, torch.int32, (B, desth, cc), dev)
    build.check("gain", gain, torch.int32, (B,), dev)
    build.check("base", base, torch.int32, (B,), dev)
    build.check("analog", analog, torch.int8, (B, V, H), dev)
    build.check("skel", skel, torch.int8, (2, V, H), dev)
    build.check("mask_end", mask_end, torch.int32, (V,), dev)
    build.check("vrows", vrows, torch.bool, (V,), dev)
    build.check("parity", parity, torch.int32, (B,), dev)
    build.check("burst", burst, torch.int8, (B, *burst.shape[1:]), dev)
    if kill is not None:
        build.check("kill", kill, torch.int32, (B,), dev)
    if cc not in (4, 5) or burst.dim() != 3 or burst.shape[1] < 1:
        raise ValueError(f"encode_field: needs cc 4 or 5 and a (B, P, "
                         f"burst_len) burst, got cc {cc}, burst "
                         f"{tuple(burst.shape)}")
    if not (0 <= xo < H and yo >= 0 and destw < H):
        raise ValueError(f"encode_field: needs 0 <= xo < H, yo >= 0 and "
                         f"destw < H, got xo {xo}, yo {yo}, destw {destw}")
    if not (0 <= cb_beg and cb_beg + burst.shape[2] <= H and bw_beg <= H):
        raise ValueError("encode_field: the burst and the kill must lie "
                         "inside a row")
    out = torch.empty((B, V, H), dtype=torch.int8, device=dev)
    cY, cI, cQ = coefs if coefs is not None else (0, 0, 0)
    build.launch("ntsc_encode_rows_field", dev, img.data_ptr(),
                 sy.data_ptr(), modI.data_ptr(), modQ.data_ptr(),
                 gain.data_ptr(), base.data_ptr(), out.data_ptr(),
                 analog.data_ptr(), skel.data_ptr(), mask_end.data_ptr(),
                 vrows.data_ptr(), parity.data_ptr(), burst.data_ptr(),
                 None if kill is None else kill.data_ptr(), B, h, w, desth,
                 destw, cc, int(coefs is not None), cY, cI, cQ, V, H, xo, yo,
                 cb_beg, burst.shape[2], burst.shape[1], bw_beg, blank)
    return out


def encode_field_plain(img, sy, modI, modQ, gain, base, analog, skel,
                       mask_end, vrows, parity, burst, kill, *, coefs, xo: int,
                       yo: int, destw: int, cb_beg: int, bw_beg: int,
                       blank: int) -> torch.Tensor:
    """encode_field in plain torch: encode_rows_plain's block, then
    assemble_field."""
    ire = encode_rows_plain(img, sy, modI, modQ, gain, base, coefs=coefs,
                            xo_mod=xo % modI.shape[-1], destw=destw)
    return assemble_field(analog, ire, skel, mask_end, vrows, parity, burst,
                          kill, xo=xo, yo=yo, cb_beg=cb_beg, bw_beg=bw_beg,
                          blank=blank)


def assemble_field(analog, ire, skel, mask_end, vrows, parity, burst, kill,
                   *, xo: int, yo: int, cb_beg: int, bw_beg: int,
                   blank: int) -> torch.Tensor:
    """The RGB encoders' field around K1's block ire (B, desth, destw), pass
    by pass (crt_ntsc.c:205-252, 322; crt_ntscvhs.c:234-238; crt_snes.c
    and its kin alike): the skeleton of each frame's parity over the
    caller's field where it writes, the burst on `vrows` by row class, the
    block at (yo, xo) (fastpath.store_active), then VHS's kill.  Arguments
    as encode_field's; returns a new field, `analog` unchanged."""
    V, H = analog.shape[1], analog.shape[2]
    dev = analog.device
    mask = torch.arange(H, device=dev)[None, :] < mask_end[:, None]
    skel = torch.where((parity == 1)[:, None, None], skel[1], skel[0])
    out = torch.where(mask, skel, analog)
    seg = out[:, :, cb_beg:cb_beg + burst.shape[2]]
    by_row = burst[:, torch.arange(V, device=dev) % burst.shape[1]]
    seg.copy_(torch.where(vrows[None, :, None], by_row, seg))
    out = fastpath.store_active(out, ire, xo, yo)
    if kill is not None:
        rows = torch.arange(V, dtype=torch.int32, device=out.device)
        dead = vrows[None, :] & (rows[None, :] >= V - kill[:, None])
        out[:, :, :bw_beg].masked_fill_(dead[:, :, None], blank)
    return out
