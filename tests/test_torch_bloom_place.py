"""K6 place_rows_uniform's bloom mode, on the CPU: the row placement of the
beam-energy bloom build when every line covers `ratio` output rows.

The bloom decode draws pixel p of line k iff scan[k] + p * dx[k] <
(av_len - 1) << 12 (wrapping int32, crt_core.c:555); a pixel not drawn
keeps the previous contents of its line's beg row.  The JAX package (and
the port outside K6's gate) places such lines with the general per-row
gather and a `valid` plane; the port hands them to K6 in its bloom mode,
which forms the plane from each line's (dx, scan) itself.  Here K6's plain
bloom mode is held against the port's general path (itself pinned to JAX)
and against the JAX package's `_place_rows` with the `valid` plane, at 0
LSB: batch 1 and 3, blend 0/1, every scanline gap, both field parities
(the odd field's top and bottom clip rows included), lines drawn wholly,
not at all and ending mid-row, dx and scan near the int32 edge.  A bloom
step at a uniform output size runs K6 once and equals the JAX step.  The
tests marked `gpu` hold the CUDA kernel to the plain version on the card
and skip without one:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \\
        tests/test_torch_bloom_place.py -m gpu
"""

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import pipeline, systems
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.ops.kernels import place

torch.set_num_threads(1)  # the tier runs several workers on few cores

NTSC = systems.NTSC
AV = 40      # a short active line: lim = 39 << 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


def same(got, want, tag=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got, want), \
        f"{tag}: {int((got != want).sum())} elements differ"


# each line's kind: drawn wholly, not at all, ending mid-row, scan near the
# int32 top (scan + p*dx wraps to negative: drawn again), dx near either
# int32 edge, dx < 0 from past the end (drawn from mid-row on)
KINDS = ("whole", "none", "mid", "scan_edge", "dx_edge", "backward")


def lines_of(rng, B, L, w, av_len=AV):
    """(dx, scan) int32 (B, L): every kind of KINDS at least once a slot
    (L >= len(KINDS)), the rest dealt at random."""
    lim = (av_len - 1) << 12
    kind = np.resize(np.arange(len(KINDS)), (B, L))
    kind = np.where(np.arange(L) < len(KINDS), kind,
                    rng.integers(0, len(KINDS), (B, L)))
    step = lim // max(w, 1)
    dx = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4, kind == 5],
        [rng.integers(0, step, (B, L)), rng.integers(1, 3 * step, (B, L)),
         rng.integers(2 * step, 4 * step, (B, L)),
         rng.integers(1 << 20, 1 << 24, (B, L)),
         rng.choice([2**31 - 1, -2**31, 2**30 + 7, -2**30 - 3], (B, L)),
         -rng.integers(step // 2 + 1, 2 * step, (B, L))])
    scan = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4, kind == 5],
        [np.zeros((B, L), np.int64), rng.integers(lim, 2**31, (B, L)),
         rng.integers(-4096, 4096, (B, L)),
         rng.integers(2**31 - (1 << 22), 2**31, (B, L)),
         rng.integers(-2**31, 2**31, (B, L)),
         rng.integers(lim, lim + 8 * step, (B, L))])
    return dx.astype(np.int32), scan.astype(np.int32)


def inputs(seed, B, L, w, ratio, parity):
    """rgb, old, field_px (slot b's field parity (b + parity) % 2), dx and
    scan of the bloom lines, and the uniform layout's beg, end and active
    lines, as numpy."""
    rng = np.random.default_rng(seed)
    fp = ratio // 2
    field_px = ((np.arange(B) + parity) % 2 * fp).astype(np.int32)
    dx, scan = lines_of(rng, B, L, w)
    lrel = np.arange(L, dtype=np.int32)[None]
    beg = lrel * ratio + field_px[:, None]
    end = (lrel + 1) * ratio + field_px[:, None]
    return dict(rgb=rng.integers(0, 256, (B, L, w, 3)).astype(np.uint8),
                old=rng.integers(0, 256, (B, ratio * L, w, 3)
                                 ).astype(np.uint8),
                field_px=field_px, dx=dx, scan=scan, beg=beg, end=end,
                active=beg < ratio * L)


def k6(x, device="cpu", **kw):
    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    return place.place_rows_uniform(
        t(x["rgb"]), t(x["old"]), t(x["field_px"]), bloom_dx=t(x["dx"]),
        bloom_scan=t(x["scan"]), av_len=AV, **kw)


def test_the_lines_cover_every_kind():
    """The dealt lines draw every pixel, none, a prefix, and (past the int32
    edge) pixels after undrawn ones, in the plain mask K6 applies."""
    x = inputs(0, 3, 8, 23, 2, 0)
    drawn = dem.bloom_drawn(torch.as_tensor(x["dx"]),
                            torch.as_tensor(x["scan"]), AV, 23).numpy()
    n = drawn.sum(-1)
    assert (n == 23).any() and (n == 0).any() and ((n > 0) & (n < 23)).any()
    # a pixel drawn after one that is not (the sum wrapped, or dx < 0)
    assert (drawn[..., 1:] & ~drawn[..., :-1]).any()


@pytest.mark.parametrize("B,L,w,ratio", [(1, 6, 11, 2), (3, 7, 16, 3),
                                         (3, 6, 9, 1), (1, 8, 5, 3)])
@pytest.mark.parametrize("blend", [0, 1])
def test_bloom_mode_matches_general_and_jax(B, L, w, ratio, blend):
    """Every scanline gap and both field parities: K6's plain bloom mode
    equals the port's general placement with the `valid` plane and the JAX
    package's _place_rows (its general path) with the same plane."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.models import demodulate as jdem
    from ntsc_crt_tpu.models.systems import NTSC as JNTSC
    outh = ratio * L
    for parity in (0, 1):
        for scanlines in range(ratio):
            x = inputs(B * 100 + L * 10 + ratio + parity, B, L, w, ratio,
                       parity)
            tag = f"parity {parity} scanlines {scanlines}"
            got = k6(x, blend=bool(blend), scanlines=scanlines, ratio=ratio,
                     fp=ratio // 2)
            valid = dem.bloom_drawn(torch.as_tensor(x["dx"]),
                                    torch.as_tensor(x["scan"]), AV, w)
            t = torch.as_tensor
            general = dem._place_rows_general(
                t(x["rgb"]), t(x["old"]), t(x["beg"]), t(x["end"]),
                t(x["active"]), t(np.full(B, blend, np.int32)),
                t(np.full(B, scanlines, np.int32)), outh, valid=valid)
            same(got, general, tag)
            j = jnp.asarray
            want = jdem._place_rows(
                JNTSC, j(x["rgb"]), j(x["old"]), j(x["beg"]), j(x["end"]),
                j(x["active"]), blend, scanlines, outh,
                valid=j(valid.numpy()), field_px=j(x["field_px"]))
            same(got, want, f"{tag} (JAX)")


def test_undrawn_pixels_keep_the_beg_row():
    """The row a pixel not drawn keeps, worked out: on an even field line k's
    rows read old row ratio*k (their group's first); on an odd field the
    shifted slots j < fp read line k - 1, whose beg row is ratio*(k-1) +
    fp; the odd field's top rows keep their own contents."""
    B, L, w, ratio = 2, 6, 7, 3
    x = inputs(4, B, L, w, ratio, 0)
    x["scan"][:], x["dx"][:] = (AV - 1) << 12, 1    # no pixel drawn
    got = k6(x, blend=False, scanlines=0, ratio=ratio, fp=1).numpy()
    old = x["old"]
    for r in range(ratio * L):
        k, j = divmod(r, ratio)
        same(got[0, r], old[0, ratio * k], f"even row {r}")
        want = (old[1, r] if k == 0 and j < 1
                else old[1, ratio * (k - (j < 1)) + 1])
        same(got[1, r], want, f"odd row {r}")


def test_place_rows_sends_bloom_to_k6(monkeypatch):
    """_place_rows with bloom lines under the uniform gate runs K6 once, in
    bloom mode, and never the general gather; outside the gate (a tensor
    knob, outh != ratio * L) it forms the `valid` plane and gathers."""
    calls, general = [], []
    real, real_general = place.place_rows_uniform, dem._place_rows_general
    monkeypatch.setattr(place, "place_rows_uniform",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    monkeypatch.setattr(dem, "_place_rows_general",
                        lambda *a, **k: general.append(k)
                        or real_general(*a, **k))
    L, w = NTSC.lines, 6
    x = inputs(9, 2, L, w, 2, 0)
    t = torch.as_tensor
    args = (t(x["rgb"]), t(x["old"]), t(x["beg"]), t(x["end"]),
            t(x["active"]))
    bloom = dict(bloom_dx=t(x["dx"]), bloom_scan=t(x["scan"]), av_len=AV)
    got = dem._place_rows(*args, 1, 1, 2 * L, bloom=bloom,
                          field_px=t(x["field_px"]))
    assert len(calls) == 1 and calls[0]["bloom_dx"] is bloom["bloom_dx"]
    assert general == []
    want = dem._place_rows(*args, t(1), 1, 2 * L, bloom=bloom,
                           field_px=t(x["field_px"]))
    assert len(calls) == 1 and len(general) == 1
    assert general[0]["valid"].shape == (2, L, w)
    same(got, want)


@pytest.mark.parametrize("B,knobs", [(2, dict(blend=1, scanlines=1)),
                                     (1, dict(blend=0, scanlines=0))])
def test_bloom_step_takes_k6_and_matches_jax(monkeypatch, B, knobs):
    """NTSC with do_bloom at 64x480 (2 rows a line: K6's gate): two steps,
    field/frame (0, 0) then (1, 1) (slots mixed at batch 2), noise 12; each
    step runs K6 once in bloom mode, and every state leaf equals the JAX
    step's."""
    import jax.numpy as jnp
    from helpers import run_step
    from ntsc_crt_tpu.models import pipeline as jpipe
    from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
    from ntsc_crt_tpu.models.systems import NTSC as JNTSC
    from ntsc_crt_tpu_torch.utils import convert

    modes = []
    real = place.place_rows_uniform
    monkeypatch.setattr(place, "place_rows_uniform", lambda *a, **k: (
        modes.append(k.get("bloom_dx") is not None) or real(*a, **k)))
    rng = np.random.default_rng(B)
    img = rng.integers(0, 256, (B, 48, 64, 3)).astype(np.uint8)
    jst = jpipe.crt_init(JNTSC, 64, 480, batch=B)
    jst = jst._replace(rn=jnp.arange(194, 194 + B, dtype=jnp.int32))
    st = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, device="cpu")
    jmon = JMon(**{k: np.int32(v) for k, v in knobs.items()})
    slot = np.arange(B, dtype=np.int32)
    for f in (0, 1):
        ff = (slot + f) % 2 if B > 1 else np.int32(f)
        step_kw = dict(field=ff, frame=ff, hue=7, noise=12, do_bloom=True)
        jst = run_step(JNTSC, jst, img, mon=jmon, **step_kw)
        st = pipeline.step(NTSC, st, torch.as_tensor(img),
                           mon=MonitorParams(**knobs),
                           **{k: torch.as_tensor(v)
                              if isinstance(v, np.ndarray) else v
                              for k, v in step_kw.items()})
        got = convert.state_to_numpy(st)
        for k, v in jst._asdict().items():
            same(got[k], np.asarray(v), f"step {f} {k}")
    assert modes == [True, True]


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,w", [(1, 640), (2, 640), (3, 37), (2, 21)])
@pytest.mark.parametrize("blend", [0, 1])
def test_k6_bloom_kernel_matches_plain(cuda, ratio, w, blend):
    """w = 640 moves 16-byte chunks, w = 37 and 21 single bytes; both
    parities, every scanline gap, every kind of line."""
    for parity in (0, 1):
        x = inputs(ratio * w + parity, 3, NTSC.lines, w, ratio, parity)
        for scanlines in range(ratio):
            kw = dict(blend=bool(blend), scanlines=scanlines, ratio=ratio,
                      fp=ratio // 2)
            want = k6(x, **kw)
            n = place.BLOOM_LAUNCHES
            same(k6(x, cuda, **kw), want, f"parity {parity} {scanlines}")
            assert place.BLOOM_LAUNCHES == n + 1


@pytest.mark.gpu
def test_bloom_step_on_the_card_matches_the_cpu(cuda):
    """A 640x480 NTSC bloom step at batch 3 on the card (K6 once, in bloom
    mode, no general gather) equals the CPU's plain path."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 240, 320, 3)).astype(np.uint8)
    f = np.array([0, 1, 1], np.int32)
    outs = []
    for dev in ("cpu", cuda):
        st = pipeline.init_batch(NTSC, 3, 640, 480, device=dev)
        args = [torch.as_tensor(v, device=dev) for v in (imgs, f, f, f)]
        st = pipeline.step_batch(NTSC, st, *args, noise=12, do_bloom=True)
        n = place.BLOOM_LAUNCHES
        outs.append(pipeline.step_batch(NTSC, st, *args, noise=12,
                                        do_bloom=True))
        assert place.BLOOM_LAUNCHES == n + (dev != "cpu")
    for k, v in outs[0]._asdict().items():
        same(getattr(outs[1], k), v, k)
