"""Frozen: the encoder of SNES, TEMPLATE and PV1K (``modulate_vper`` of
``ntsc_crt_tpu_torch/models/modulate.py``, crt_snes.c:125-327,
crt_template.c:125-337, crt_pv1k.c:121-321) on the plain versions, as it
stood when the PV1K cell was defined.

Against the NTSC encoder: the carrier and burst tables are 2-D, one row a
vertical phase class y of VP (PV1K: 5 classes of 5 samples, a 144 degree
step a line, crt_pv1k.c:168); the burst's angle is n - 360 / CC +
hue_offset; picture row y takes the table of its field row's class
(y + yo) % VP in place of CC_PHASE's sign; xo is aligned down to CC
(PV1K's 5); the burst goes on every video row by that row's class; the
iccf export writes class (n + 3) % VP from class n (crt_snes.c:239).  The
skeleton is the frozen reference's ``build_skeletons`` at the preset's
equalising and sync rows (PV1K: equalising 7-9, vsync 258-260 near the
bottom of the field).

Where this departs from the C:

* a batch: every tensor has a leading frame dim, and field, hue and the
  dot-crawl offset may differ by slot;
* the resampler reads one image row past the bottom where the C does (UB
  there); it reads the last row instead;
* a picture row whose xo + destw passes HRES spills into the next row, as
  the C's flat index does; writes past the field's last row (UB in the C)
  are dropped;
* ``frame`` is taken and unread, as in the C.
"""

from __future__ import annotations

import torch

from crt_bench.reference import fastpath
from crt_bench.reference import modulate as _mod
from crt_bench.reference.fixedpoint import cdiv, sincos14
from crt_bench.reference.modulate import _b
from crt_bench.reference.systems import SystemConfig


def vper_tables(cfg: SystemConfig, dco: torch.Tensor):
    """(burst, I, Q), int32 (B, VP, CC) each: 14-bit sines >> 10 at angle
    n = (y + dco) * vert_step + x * (360 / CC) of vertical class y and
    sample class x (crt_snes.c:170-188, the hue 0), the burst's at
    n - 360 / CC + hue_offset, Q's at n + q_offset."""
    dev = dco.device
    VP, CC = cfg.cc_vper, cfg.cc_samples
    step = 360 // CC
    yv = torch.arange(VP, dtype=torch.int32, device=dev)[None, :, None]
    xv = torch.arange(CC, dtype=torch.int32, device=dev)[None, None, :]
    n_ang = (yv + dco[:, None, None]) * cfg.vert_step + xv * step
    out = []
    for off in (cfg.hue_offset - step, 0, cfg.q_offset):
        sn, _ = sincos14(cdiv((n_ang + off) * 8192, 180))
        out.append(sn >> 10)
    return tuple(out)


def burst_rows(ccburst: torch.Tensor, cfg: SystemConfig) -> torch.Tensor:
    """The burst window of every field row: row n takes
    ccburst[b, n % VP, t % CC] at sample t.  int8 (B, VRES, burst_len)."""
    dev = ccburst.device
    VP, CC = cfg.cc_vper, cfg.cc_samples
    cls = torch.arange(cfg.vres, device=dev) % VP
    t = (torch.arange(cfg.burst_len, device=dev) + cfg.cb_beg) % CC
    cb = ccburst[:, cls][:, :, t]
    return ((cfg.blank_level + cb * cfg.burst_level) >> 5).to(torch.int8)


def modulate_vper(cfg: SystemConfig, analog: torch.Tensor, img: torch.Tensor,
                  *, field, frame, dot_crawl_offset=0, black_point=0,
                  white_point=100) -> tuple[torch.Tensor, torch.Tensor]:
    """One field a slot, in colour at the encoder's hue 0, as the port's
    step drives it: analog int8 (B, VRES, HRES), the caller's field, whose
    samples the skeleton does not write it keeps; img uint8 (B, h, w, 3).
    field, dot_crawl_offset and the points are ints or int32 (B,) tensors.
    Returns (analog', ccf' int32 (B, VP, CC))."""
    del frame
    if cfg.kind != "rgb" or cfg.cc_vper < 2:
        raise ValueError(f"{cfg.name}: not an encoder with a carrier table "
                         "a vertical phase class")
    dev = analog.device
    B = analog.shape[0]
    CC, VP = cfg.cc_samples, cfg.cc_vper
    h = img.shape[1]
    field = _b(field, B, dev) & 1
    ccburst, ccmodI, ccmodQ = vper_tables(cfg, _b(dot_crawl_offset, B, dev))

    # iccf[(n + 3) % VP][k] is written from class n % VP (crt_snes.c:239)
    src = (torch.arange(VP, device=dev) - 3) % VP
    ccf = ((cfg.blank_level + ccburst[:, src] * cfg.burst_level) >> 5) << 7

    # the parity's skeleton over the caller's field, then the burst
    skel_even, skel_odd, mask, vrows = _mod._field_constants(cfg, dev)
    skel = torch.where((field == 1)[:, None, None], skel_odd, skel_even)
    analog = torch.where(mask, skel, analog)
    win = slice(cfg.cb_beg, cfg.cb_beg + cfg.burst_len)
    analog[:, :, win] = torch.where(vrows[None, :, None],
                                    burst_rows(ccburst, cfg),
                                    analog[:, :, win])

    # the picture (crt_pv1k.c:190-200, 270-315)
    destw, desth = cfg.av_len, (cfg.lines * 64500) >> 16
    xo = cfg.av_beg + (cfg.av_len - destw) // 2
    xo -= xo % CC
    yo = cfg.top + (cfg.lines - desth) // 2
    y_idx = torch.arange(desth, dtype=torch.int32, device=dev)[None, :]
    if cfg.interlace_offset:
        field_offset = cdiv(cdiv(field * h + desth, desth), 2)[:, None]
    else:
        field_offset = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    sy = ((y_idx * h) // desth + field_offset).clamp(max=h - 1)
    phr = (torch.arange(desth, device=dev) + yo) % VP
    ire = _mod._encode_lines(
        img, sy, ccmodI[:, phr].contiguous(), ccmodQ[:, phr].contiguous(),
        cdiv(cfg.white_level * _b(white_point, B, dev), 100),
        cfg.black_level + _b(black_point, B, dev),
        coefs=_mod._iir_coefs(cfg), xo_mod=xo % CC, destw=destw)
    return fastpath.store_active(analog, ire, xo, yo), ccf
