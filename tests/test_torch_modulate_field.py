"""K1's field mode (ops/kernels/encode.py ``encode_field``): the NTSC-family
field written whole, each byte once.

On the CPU its plain version (the path a CPU tensor takes) is held, byte for
byte, to the passes the RGB encoders made before the field mode, written out
here as they stood: the skeleton picked by parity laid over the caller's
field, the burst, K1's block stored at (yo, xo) with the flat spill, VHS's
sync kill.  The cases cover both parities, kills of 0, 6 and 17 rows, the
bloom sizing, a picture spilling past the row end (a spilled tail on a
killed row included), rows clipped at the field's end and a picture that
starts left of the kill's columns.  The tests marked `gpu` hold the kernel
to the plain version on the card at B 1, 64 and 2048, and count the
launches of a step.  Every value is an integer: every comparison is exact.

No JAX here, so the `gpu` tests also run on a machine without it:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \\
        tests/test_torch_modulate_field.py -m gpu
"""

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import modulate, pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.ops import fastpath, lcg
from ntsc_crt_tpu_torch.ops.fixedpoint import crem
from ntsc_crt_tpu_torch.ops.kernels import build, encode
from ntsc_crt_tpu_torch.parallel import spatial

torch.set_num_threads(1)  # the tier runs several workers on few cores

VHS = systems.NTSCVHS

# (label, do_bloom, xoffset, yoffset, kills): the kills are each slot's
# killed bottom rows, None for the NTSC encoder (no kill)
CASES = [
    ("centred", False, 0, 0, (0, 6, 17)),
    ("no kill", False, 0, 0, None),
    ("bloom", True, 0, 0, (17, 0, 6)),
    ("spill", False, 100, 0, (0, 6, 17)),
    ("spill, clipped", False, 100, 10, (17, 6, 0)),
    ("clipped", False, 0, 12, (6, 17, 0)),
    ("left of the kill", False, -100, 0, (17, 17, 6)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


def field_inputs(cfg, B, do_bloom, xoffset, yoffset, kills, device, seed=0):
    """encode_field's arguments for B slots of random pictures, carrier
    tables, burst samples and previous fields; the slots' parities
    alternate; kills cycle over the slots."""
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    destw, desth = modulate._dest_size(cfg, False, w, h, do_bloom)
    xo = (cfg.av_beg + xoffset + (cfg.av_len - destw) // 2) & ~3
    yo = cfg.top + yoffset + (cfg.lines - desth) // 2
    cc = cfg.cc_samples

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def i32(lo, hi, shape):
        return t(rng.integers(lo, hi, shape).astype(np.int32))

    rows = (t(rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)),
            i32(0, h, (B, desth)), i32(-32, 33, (B, desth, cc)),
            i32(-32, 33, (B, desth, cc)), i32(50, 150, B), i32(-20, 30, B))
    skel, mask_end, vrows = modulate._field_tables(cfg, torch.device(device))
    kill = None if kills is None else t(
        np.resize(np.array(kills, np.int32), B))
    frame = (t(rng.integers(-128, 128, (B, cfg.vres, cfg.hres),
                            dtype=np.int8)),
             skel, mask_end, vrows, t(np.arange(B, dtype=np.int32) % 2),
             t(rng.integers(-128, 128, (B, cfg.burst_len), dtype=np.int8)),
             kill)
    kw = dict(coefs=modulate._iir_coefs(cfg), xo=xo, yo=yo, destw=destw,
              cb_beg=cfg.cb_beg, bw_beg=cfg.bw_beg, blank=cfg.blank_level)
    return rows, frame, kw


def the_passes(cfg, analog, ire, parity, burst, kill, xo, yo):
    """The RGB encoders' field build before the field mode, pass by pass:
    the skeleton by parity over the caller's field where the mask writes,
    the burst on the non-vsync rows, K1's block at (yo, xo), VHS's kill."""
    skel_even, skel_odd, mask = (torch.as_tensor(a) for a in
                                 modulate.build_skeletons(cfg))
    vrows = torch.as_tensor(modulate.video_rows_mask(cfg))
    skel = torch.where((parity == 1)[:, None, None], skel_odd, skel_even)
    analog = torch.where(mask, skel, analog)
    seg = analog[:, :, cfg.cb_beg:cfg.cb_beg + cfg.burst_len]
    analog[:, :, cfg.cb_beg:cfg.cb_beg + cfg.burst_len] = torch.where(
        vrows[None, :, None], burst[:, None, :], seg)
    analog = fastpath.store_active(analog, ire, xo, yo)
    if kill is not None:
        V = cfg.vres
        rows = torch.arange(V, dtype=torch.int32)[None, :]
        dead = vrows[None, :] & (rows >= V - kill[:, None])
        analog[:, :, :cfg.bw_beg].masked_fill_(dead[:, :, None],
                                               cfg.blank_level)
    return analog


@pytest.mark.parametrize("label,do_bloom,xoffset,yoffset,kills", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_field_build_is_the_pass_sequence(label, do_bloom, xoffset,
                                                yoffset, kills):
    rows, frame, kw = field_inputs(VHS, 3, do_bloom, xoffset, yoffset, kills,
                                   "cpu")
    analog = frame[0]
    before = analog.clone()
    got = encode.encode_field(*rows, *frame, **kw)
    assert torch.equal(analog, before), "the caller's field was written"
    assert got.data_ptr() != analog.data_ptr()
    ire = encode.encode_rows_plain(*rows, coefs=kw["coefs"],
                                   xo_mod=kw["xo"] % VHS.cc_samples,
                                   destw=kw["destw"])
    want = the_passes(VHS, before.clone(), ire, frame[4], frame[5],
                      frame[6], kw["xo"], kw["yo"])
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} bytes differ"
    # the case reaches what its label says
    xo, yo, destw, desth = kw["xo"], kw["yo"], kw["destw"], ire.shape[1]
    V, H = VHS.vres, VHS.hres
    assert (xo + destw > H) == label.startswith("spill")
    assert (yo + desth > V) == ("clipped" in label)
    assert (xo < VHS.bw_beg) == (label == "left of the kill")
    if label == "spill":  # a tail spills onto the kill's columns of row V-17
        assert 0 <= V - 17 - 1 - yo < desth
        assert xo + destw - H > VHS.bw_beg
    if label == "left of the kill":  # a picture row starts in them
        assert 0 <= V - 17 - yo < desth


def test_modulate_vhs_moves_the_draw_before_the_field_and_keeps_randstate():
    """modulate_vhs draws its kill before the field build: the randstate
    advances once where do_aberration, the kill matches the draw, ccf is
    zero; the caller's field is left as it was."""
    rng = np.random.default_rng(7)
    B = 4
    analog = torch.as_tensor(rng.integers(-128, 128, (B, VHS.vres, VHS.hres),
                                          dtype=np.int8))
    img = torch.as_tensor(rng.integers(0, 256, (B, 48, 64, 3),
                                       dtype=np.uint8))
    rs = torch.tensor([1, -5, 2**31 - 1, -(2**31)], dtype=torch.int32)
    ab = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    before = analog.clone()
    got, ccf, rs2 = modulate.modulate_vhs(VHS, analog, img, rs, field=1,
                                          frame=0, hue=3, do_aberration=ab)
    assert torch.equal(analog, before)
    assert not ccf.any()
    nxt = lcg.crt_rand_step(rs)
    assert torch.equal(rs2, torch.where(ab != 0, nxt, rs))
    # the killed rows read blank over the kill's columns, the row above not
    kill = torch.where(ab != 0, crem(lcg.crt_rand_out(nxt), 12) - 8 + 14, 0)
    V = VHS.vres
    for b in range(B):
        k = int(kill[b])
        assert (got[b, V - k:, :VHS.bw_beg] == VHS.blank_level).all()
        assert not (got[b, V - k - 1, :VHS.bw_beg] == VHS.blank_level).all()


# --- on the card -------------------------------------------------------------

CARD_CASES = [("vhs", False, 0, 0, (0, 6, 17)), ("bloom", True, 0, 0, None)] \
    + [c for c in CASES if c[0] != "centred"]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64, 2048])
@pytest.mark.parametrize("label,do_bloom,xoffset,yoffset,kills", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_field_mode_kernel_matches_plain(cuda, B, label, do_bloom, xoffset,
                                         yoffset, kills):
    rows, frame, kw = field_inputs(VHS, B, do_bloom, xoffset, yoffset, kills,
                                   cuda, seed=B)
    before = frame[0].clone()
    n = dict(build.LAUNCHES)
    got = encode.encode_field(*rows, *frame, **kw)
    assert build.LAUNCHES["encode_rows_field"] == \
        n.get("encode_rows_field", 0) + 1
    want = encode.encode_field_plain(*rows, *frame, **kw)
    torch.cuda.synchronize()
    assert torch.equal(frame[0], before), "the caller's field was written"
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} bytes differ"


def cell_step(cfg, B, dev, **kw):
    """One step_batch of B slots at 640x480 of a cell's system, the
    launches counted."""
    st = pipeline.init_batch(cfg, B, 640, 480, device=dev)
    img = torch.randint(0, 256, (B, 480, 640, 3), dtype=torch.uint8,
                        device=dev)
    field = torch.arange(B, dtype=torch.int32, device=dev) % 2
    build.LAUNCHES.clear()
    st = pipeline.step_batch(cfg, st, img, field, field, field * 0,
                             noise=24, **kw)
    torch.cuda.synchronize()
    return st


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["vhs_batch2048", "bloom_batch2048"])
def test_a_cells_step_launches_the_field_mode_once(cuda, cell):
    kw = (dict(mon=MonitorParams(saturation=10), do_aberration=1)
          if cell == "vhs_batch2048" else
          dict(mon=MonitorParams(blend=1, scanlines=1, saturation=10),
               do_bloom=True))
    cfg = VHS if cell == "vhs_batch2048" else systems.NTSC
    cell_step(cfg, 64, cuda, **kw)
    assert build.LAUNCHES["encode_rows_field"] == 1, dict(build.LAUNCHES)
    assert build.LAUNCHES["encode_rows"] == 0, dict(build.LAUNCHES)


@pytest.mark.gpu
def test_the_line_split_still_launches_the_block(cuda):
    with spatial.line_sharding([cuda, cuda]):
        cell_step(VHS, 2, cuda, do_aberration=1)
    assert build.LAUNCHES["encode_rows"] == 2, dict(build.LAUNCHES)
    assert build.LAUNCHES["encode_rows_field"] == 0, dict(build.LAUNCHES)
