"""K6's general mode, ``place.place_rows_general``: the row placement off
K6's uniform gate (outh not a multiple of the line count, as the live
832x624 window's 624 rows of 240 lines; v_fac; a downscale; blend and
scanlines as (B,) tensors), each output row taking the last line that
covers it (``demodulate._place_rows_general``).

On the CPU the wrapper runs that plain path (bloom lines as
``bloom_drawn``'s `valid` plane) and checks its arguments, and
``_place_rows`` sends every call off the gate to it.  The tests marked
`gpu` hold the CUDA kernel (csrc/place.cu, ``ntsc_place_rows_general``)
to ``_place_rows_general`` run as plain torch on the same card, bit for
bit, and skip without one:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \\
        tests/test_torch_place_general.py -m gpu
"""

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.ops.kernels import build, place

torch.set_num_threads(1)  # the tier runs several workers on few cores

L240 = 240   # the NES and NTSC line count


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


def line_rows(field_px, L, outh, v_fac):
    """beg, end, active (B, L) as demodulate._line_scan forms them."""
    lrel = torch.arange(L, dtype=torch.int32, device=field_px.device)[None]
    beg = (lrel * (outh + v_fac)) // L + field_px[:, None]
    end = ((lrel + 1) * (outh + v_fac)) // L + field_px[:, None]
    return beg, end, beg < outh


def inputs(seed, B, L, w, outh, *, v_fac=0, fp=0, knobs="host", bloom=False,
           odd_lines=False, device="cpu"):
    """Seeded (args, kw) of place_rows_general: the lines and the previous
    frame random; field_px fp on the odd slots; knobs "host" (blend 1,
    scanlines 1) or "tensor" (blend and scanlines 0/1 mixed per slot);
    bloom: each line's (dx, scan) with pixels drawn wholly, not at all and
    to mid-row; odd_lines: a few lines inactive, and beg/end off the line
    scan's pattern (overlapping, empty, reversed, at the int32 edges)."""
    g = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    rgb = t(g.integers(0, 256, (B, L, w, 3), dtype=np.uint8))
    old = t(g.integers(0, 256, (B, outh, w, 3), dtype=np.uint8))
    field_px = t((np.arange(B) % 2 * fp).astype(np.int32))
    beg, end, active = line_rows(field_px, L, outh, v_fac)
    if odd_lines:
        beg[:, ::7] -= 3
        end[:, ::5] += 4
        end[:, 1::9] = beg[:, 1::9] - 1
        beg[:, 0], end[:, 0] = 2**31 - 1, -2**31
        beg[:, 2], end[:, 2] = -2**31, 2**31 - 1
        active = active & t(g.integers(0, 8, (B, L)) > 0)
    if knobs == "host":
        kw = dict(blend=1, scanlines=1)
    else:
        kw = dict(blend=t((np.arange(B) % 2).astype(np.int32)),
                  scanlines=t((np.arange(B) // 2 % 2).astype(np.int32)))
    if bloom:
        av = 40
        scan = g.integers(0, 8 << 12, (B, L), dtype=np.int32)
        dx = g.integers(1, 2 * (av << 12) // w, (B, L), dtype=np.int32)
        scan[:, ::4] = (av - 1) << 12          # drawn not at all
        dx[:, 1::4] = 1                        # drawn wholly
        kw.update(bloom_dx=t(dx), bloom_scan=t(scan), av_len=av)
    return (rgb, old, beg.contiguous(), end.contiguous(),
            active.contiguous()), kw


def plain(args, kw):
    """_place_rows_general itself, bloom lines as bloom_drawn's plane."""
    rgb, old = args[:2]
    valid = None
    if "bloom_dx" in kw:
        valid = dem.bloom_drawn(kw["bloom_dx"], kw["bloom_scan"],
                                kw["av_len"], rgb.shape[2])
    return dem._place_rows_general(*args, kw["blend"], kw["scanlines"],
                                   old.shape[1], valid=valid)


def same(got, want, tag=""):
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    n = int((got != want).sum())
    assert n == 0, f"{tag}: {n} elements differ"


# (B, L, w, outh, v_fac, fp): 624 of 240 lines (the live window, odd
# field_px 1), 312 of 240, a downscale 200 of 240, v_fac 1, a 16-byte row
# (w 16: 48 bytes) and the byte fallback (w 30: 90 bytes)
SHAPES = {"624of240": (3, L240, 16, 624, 0, 1),
          "312of240": (3, L240, 30, 312, 0, 0),
          "200of240": (2, L240, 16, 200, 0, 0),
          "vfac1": (3, L240, 30, 479, 1, 1),
          "624of240_bytes": (3, L240, 30, 624, 0, 1)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("knobs", ["host", "tensor"])
@pytest.mark.parametrize("bloom", [False, True])
def test_the_wrapper_runs_the_plain_path_on_the_cpu(monkeypatch, shape,
                                                    knobs, bloom):
    """A CPU tensor takes _place_rows_general, with bloom's plane, and no
    kernel library."""
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")
    monkeypatch.setattr(build, "library", refuse)
    B, L, w, outh, v_fac, fp = SHAPES[shape]
    args, kw = inputs(7, B, L, w, outh, v_fac=v_fac, fp=fp, knobs=knobs,
                      bloom=bloom)
    n = dict(build.LAUNCHES)
    same(place.place_rows_general(*args, **kw), plain(args, kw), shape)
    assert dict(build.LAUNCHES) == n


BAD = {"rgb_dtype": lambda a, k: ((a[0].to(torch.int16), *a[1:]), k),
       "old_width": lambda a, k: ((a[0], a[1][:, :, 1:], *a[2:]), k),
       "beg_int64": lambda a, k: ((*a[:2], a[2].long(), *a[3:]), k),
       "active_int": lambda a, k: ((*a[:4], a[4].int()), k),
       "blend_float": lambda a, k: (a, dict(k, blend=0.5)),
       "blend_shape": lambda a, k: (a, dict(k, blend=k["blend"][:1])),
       "scanlines_int64": lambda a, k: (a, dict(k, scanlines=k[
           "scanlines"].long())),
       "bloom_alone": lambda a, k: (a, dict(k, bloom_dx=a[2])),
       "av_len": lambda a, k: (a, dict(k, bloom_dx=a[2], bloom_scan=a[2],
                                       av_len=0))}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_the_wrapper_checks_its_arguments(bad):
    args, kw = inputs(1, 2, 12, 5, 31, knobs="tensor")
    with pytest.raises((ValueError, TypeError)):
        place.place_rows_general(*BAD[bad](args, kw)[0],
                                 **BAD[bad](args, kw)[1])


def test_place_rows_sends_the_calls_off_the_gate_to_the_general_mode(
        monkeypatch):
    """Off K6's gate (outh 31 of 12 lines; a tensor knob) _place_rows counts
    a `general` placement and calls place_rows_general once, bloom's lines
    as (dx, scan, av_len) and a tensor knob as int32 (B,); under the gate
    it never does."""
    calls = []
    real = place.place_rows_general
    monkeypatch.setattr(place, "place_rows_general",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    B, L, w = 2, 12, 5
    for outh, blend, n in ((31, 1, 1), (24, torch.tensor(1), 1), (24, 1, 0)):
        args, kw = inputs(outh, B, L, w, outh, fp=1, bloom=True)
        field_px = (torch.arange(B, dtype=torch.int32) % 2)
        bloom = {k: kw[k] for k in ("bloom_dx", "bloom_scan", "av_len")}
        calls.clear()
        dem.PLACEMENTS.clear()
        got = dem._place_rows(*args, blend, 0, outh, bloom=bloom,
                              field_px=field_px)
        assert len(calls) == n
        assert dict(dem.PLACEMENTS) == ({"general": 1} if n else
                                        {"uniform_bloom": 1})
        if n:
            k = calls[0]
            assert k["bloom_dx"] is bloom["bloom_dx"] and k["av_len"] == 40
            assert not torch.is_tensor(k["scanlines"])
            if torch.is_tensor(blend):
                assert k["blend"].dtype == torch.int32
                assert k["blend"].shape == (B,)
            same(got, plain(args, dict(bloom, blend=blend, scanlines=0)))


# --- on the card ------------------------------------------------------------

CASES = [(shape, knobs, bloom, odd)
         for shape in sorted(SHAPES) for knobs in ("host", "tensor")
         for bloom in (False, True) for odd in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,knobs,bloom,odd", CASES)
def test_the_kernel_matches_the_plain_path(cuda, shape, knobs, bloom, odd):
    """Bit for bit against _place_rows_general on the same card; launched
    once, in bloom mode for bloom lines."""
    B, L, w, outh, v_fac, fp = SHAPES[shape]
    seed = CASES.index((shape, knobs, bloom, odd))
    args, kw = inputs(seed, B, L, w, outh, v_fac=v_fac, fp=fp, knobs=knobs,
                      bloom=bloom, odd_lines=odd, device=cuda)
    key = "place_rows_general" + ("_bloom" if bloom else "")
    n = build.LAUNCHES[key]
    got = place.place_rows_general(*args, **kw)
    assert build.LAUNCHES[key] == n + 1
    same(got, plain(args, kw), f"{shape} {knobs} {bloom} {odd}")


@pytest.mark.gpu
def test_the_kernel_matches_the_plain_path_past_2_31_elements(cuda):
    """B 2048 at 832x624 (NES's live window, 240 lines, blend and
    scanlines 0, both parities): the output has 3.19e9 elements; every
    frame that lies past element 2^31 equals _place_rows_general run on
    those frames alone, and the frames before the first such one equal
    it too for a sample."""
    B, L, w, outh = 2048, L240, 832, 624
    g = torch.Generator(device=cuda).manual_seed(26)
    rgb = torch.randint(0, 256, (B, L, w, 3), generator=g, device=cuda,
                        dtype=torch.uint8)
    old = torch.randint(0, 256, (B, outh, w, 3), generator=g, device=cuda,
                        dtype=torch.uint8)
    field_px = torch.arange(B, dtype=torch.int32, device=cuda) % 2
    beg, end, active = line_rows(field_px, L, outh, 0)
    got = place.place_rows_general(rgb, old, beg, end, active, blend=0,
                                   scanlines=0)
    assert got.numel() > 2**31
    frame = outh * w * 3
    first = 2**31 // frame                 # the frame holding element 2^31
    for lo, hi in ((first, B), (0, 64)):
        want = dem._place_rows_general(rgb[lo:hi], old[lo:hi], beg[lo:hi],
                                       end[lo:hi], active[lo:hi], 0, 0, outh)
        same(got[lo:hi], want, f"frames {lo}..{hi}")
