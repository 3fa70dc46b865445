"""K1-K5 of the port: plain versions against the JAX kernels, and CUDA
kernels against the plain versions (K2's conv and bloom modes,
bloom_line_width and K6: tests/test_torch_variants.py); K7-K10 and the
unfused decode chain on the card (their plain versions against JAX:
tests/test_torch_rowops.py).

On the CPU each plain version (the path a CPU tensor takes) is held against
the Pallas kernel it replaces, run in interpret mode as the JAX package's own
kernel tests run it.  The tests marked `gpu` hold each CUDA kernel against
its plain version on the card and skip without one.  Every value is an
integer: every comparison is exact (0 LSB).

JAX is imported inside the tests that use it, so the `gpu` tests also run
on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \
        tests/test_torch_kernels.py -m gpu
"""

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import systems
from ntsc_crt_tpu_torch.ops import filters
from ntsc_crt_tpu_torch.ops.kernels import (ccf, decode, encode, hsync,
                                            probe, rowfilters, scanconv, vhs)

torch.set_num_threads(1)  # the tier runs several workers on few cores

NTSC = systems.NTSC

IIR = tuple(filters.init_iir(NTSC.l_freq, f)
            for f in (NTSC.y_freq, NTSC.i_freq, NTSC.q_freq))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


def to_torch(d, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def same(got, want):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), f"{int((got != want).sum())} differ"


# --- K1 encode_rows ---------------------------------------------------------


def k1_inputs(seed, B, h, w, desth, cc, per_row=False):
    """Random K1 arguments: carrier tables (B, desth, cc), one a picture
    row, or with per_row=False one a frame repeated over its rows."""
    rng = np.random.default_rng(seed)
    sy = np.sort(rng.integers(0, h, (B, desth)), axis=1)
    tab = lambda: np.broadcast_to(  # noqa: E731
        rng.integers(-32, 33, (B, desth if per_row else 1, cc)),
        (B, desth, cc)).astype(np.int32, order="C")
    return dict(
        img=rng.integers(0, 256, (B, h, w, 3)).astype(np.uint8),
        sy=sy.astype(np.int32), modI=tab(), modQ=tab(),
        gain=rng.integers(50, 150, B).astype(np.int32),
        base=rng.integers(-20, 30, B).astype(np.int32))


def k1_jax(x, destw, xo_mod, col_map):
    """encode_fused_rows (interpret) on the same rows: narrow rows with the
    static column map, or host-resampled wide planes without one."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import encode_fused as ef
    B, h, w, _ = x["img"].shape
    desth = x["sy"].shape[1]
    rows = x["img"][np.arange(B)[:, None], x["sy"]]       # (B, desth, w, 3)
    cmap = (np.arange(destw) * w) // destw
    if not col_map:
        rows = rows[:, :, cmap]
    planes = [jnp.asarray(rows[..., c].reshape(B * desth, -1))
              for c in range(3)]
    per_row = lambda v: jnp.asarray(np.repeat(v, desth, axis=0))
    tables = [jnp.asarray(x[k].reshape(B * desth, -1))
              for k in ("modI", "modQ")]
    out = ef.encode_fused_rows(
        *planes, *tables, per_row(x["gain"]),
        per_row(x["base"]), coefs=IIR, xo_mod=xo_mod, rgb=True,
        interpret=True,
        col_map=tuple(int(v) for v in cmap) if col_map else None)
    return np.asarray(out).reshape(B, desth, destw)


@pytest.mark.parametrize("cc,w,destw,col_map", [
    (4, 20, 32, True),                         # in-kernel map, upsampling
    (4, 100, 256, False), (5, 300, 256, False)])
def test_k1_plain_matches_jax_kernel(cc, w, destw, col_map):
    x = k1_inputs(cc + w, B=2, h=9, w=w, desth=8, cc=cc)
    xo_mod = 3 % cc
    got = encode.encode_rows(**to_torch(x), coefs=IIR, xo_mod=xo_mod,
                             destw=destw)
    same(got, k1_jax(x, destw, xo_mod, col_map))


# (B, h, w, desth, destw, coefs) of K1's GPU cases; "ragged": 111 rows (the
# last warp's lanes partly idle) and lines that are not a whole number of
# 64-sample tiles (60 for cc 5), from a narrower image (cc 4) and a wider
# one (cc 5); "aligned": destw % 4 == 0 (word stores), no bandlimiting
K1_SHAPES = {
    ("full", 4): (3, 240, 320, 236, NTSC.av_len, IIR),
    ("full", 5): (3, 240, 320, 236, systems.PV1K.av_len, IIR),
    ("ragged", 4): (3, 29, 20, 37, 37, IIR),
    ("ragged", 5): (3, 29, 1000, 37, 753, IIR),
    ("aligned", 4): (2, 60, 640, 40, 640, None),
    ("aligned", 5): (2, 60, 100, 40, 640, None)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["full", "ragged", "aligned"])
@pytest.mark.parametrize("cc", [4, 5])
@pytest.mark.parametrize("per_row", [False, True])
def test_k1_kernel_matches_plain(cuda, cc, per_row, shape):
    """One carrier table a frame (NTSC) or one a row (the 2D-table
    encoders, PV1K's 5-sample lines at their full 1487-sample width), at
    the shapes of K1_SHAPES."""
    B, h, w, desth, destw, coefs = K1_SHAPES[shape, cc]
    x = k1_inputs(cc + w, B=B, h=h, w=w, desth=desth, cc=cc,
                  per_row=per_row)
    kw = dict(coefs=coefs, xo_mod=2, destw=destw)
    want = encode.encode_rows(**to_torch(x), **kw)
    n = encode.LAUNCHES
    same(encode.encode_rows(**to_torch(x, cuda), **kw), want)
    assert encode.LAUNCHES == n + 1


# --- K2 decode_rows (three-band) ---------------------------------------------


def k2_inputs(seed, B, L, H, cc, locked=False, row0=1):
    rng = np.random.default_rng(seed)
    shifts = rng.integers(0, H, (B, L))
    if locked:
        shifts = np.full((B, L), H - 7)
    waveI = rng.integers(-60000, 60000, (B, L, cc)).astype(np.int32)
    waveQ = (np.roll(waveI, -3, axis=-1) if cc == 4 else
             rng.integers(-60000, 60000, (B, L, cc)).astype(np.int32))
    return dict(
        rows=rng.integers(-127, 128, (B, row0 + L + 2, H)).astype(np.int8),
        shifts=shifts.astype(np.int32), waveI=waveI, waveQ=waveQ,
        bright=rng.integers(-20, 20, (B, L)).astype(np.int32),
        contrast=rng.integers(150, 200, (B, L)).astype(np.int32))


def k2_jax(x, row0, av_len, outw):
    """decode_fused_rows (interpret) fed the line rows as the two planes
    ext / ext_hi, shifts up to H - 1."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import decode_fused as df
    B, L = x["shifts"].shape
    H = x["rows"].shape[2]
    flat = lambda v: jnp.asarray(v.reshape((B * L,) + v.shape[2:]))
    ext = x["rows"][:, row0:row0 + L]
    ext_hi = x["rows"][:, row0 + 1:row0 + L + 1]
    r8, g8, b8 = df.decode_fused_rows(
        flat(ext), flat(x["shifts"]), flat(x["waveI"]), flat(x["waveQ"]),
        flat(x["bright"]), flat(x["contrast"]), ext_hi=flat(ext_hi),
        outw=outw, av_len=av_len, max_shift=H - 1,
        coefs=tuple(tuple(c) for c in dem._eq_coefs(NTSC)), interpret=True)
    rgb = np.stack([np.asarray(v) for v in (r8, g8, b8)], axis=-1)
    return rgb.reshape(B, L, outw, 3)


@pytest.mark.parametrize("locked", [False, True])
def test_k2_plain_matches_jax_kernel(locked):
    """cc = 4 only: each JAX interpret compile of this kernel costs about a
    minute; 5-sample waves differ only in the Q table the caller passes."""
    row0, av_len, outw = 1, 128, 48
    x = k2_inputs(7, B=2, L=24, H=160, cc=4, locked=locked, row0=row0)
    got = decode.decode_rows(**to_torch(x), row0=row0,
                             coefs=dem._eq_coefs(NTSC), av_len=av_len,
                             outw=outw)
    same(got, k2_jax(x, row0, av_len, outw))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["full", "ragged"])
@pytest.mark.parametrize("cc,mode", [
    (4, "threeband"), (5, "threeband"), (4, "conv4"), (4, "conv5"),
    (4, "conv6"), (4, "conv7"), (4, "bloom"), (5, "bloom")])
def test_k2_kernel_matches_plain(cuda, cc, mode, shape):
    """Every mode at NTSC's shape and at a ragged one: 111 rows (the last
    warp's lanes partly idle), outw 641 or 37 (not a whole number of
    32-pixel tiles, nor of 4-byte words), shifts from before 0 to past 2H
    (held to decode_rows_plain_any_shift, as the plain version takes
    shifts >= 0), bloom steps of decode.bloom_steps."""
    if shape == "full":
        B, L, H, av_len, outw = 2, NTSC.lines, NTSC.hres, NTSC.av_len, 640
    else:
        B, L, H, av_len, outw = 3, 37, 200, 150, 641 if cc == 4 else 37
    x = k2_inputs(cc + len(mode), B=B, L=L, H=H, cc=cc, row0=3)
    rng = np.random.default_rng(len(mode))
    if shape == "ragged":
        x["shifts"] = rng.integers(-40, 2 * H - 20, (B, L)).astype(np.int32)
    if mode == "bloom":
        x.update(decode.bloom_steps(rng, B, L, av_len, outw, cc))
    coefs = (("conv", int(mode[-1])) if mode.startswith("conv") else
             dem._eq_coefs(NTSC))
    kw = dict(row0=3, coefs=coefs, av_len=av_len, outw=outw)
    want = decode.decode_rows_plain_any_shift(**to_torch(x), **kw)
    counter = {"bloom": "BLOOM_LAUNCHES"}.get(
        mode, "CONV_LAUNCHES" if mode.startswith("conv") else "LAUNCHES")
    n = getattr(decode, counter)
    same(decode.decode_rows(**to_torch(x, cuda), **kw), want)
    assert getattr(decode, counter) == n + 1


@pytest.mark.parametrize("mode", ["threeband", "conv7", "bloom"])
def test_k2_plain_any_shift_is_the_plain_version_from_shift_0(mode):
    """decode_rows_plain_any_shift, which the GPU tests and the chip run
    hold K2 to where shifts go below 0, equals the plain version wherever
    the plain version is defined (shifts >= 0, up to past 2H)."""
    B, L, H, av_len, outw = 2, 7, 60, 50, 37
    x = k2_inputs(len(mode), B=B, L=L, H=H, cc=4, row0=2)
    rng = np.random.default_rng(len(mode))
    x["shifts"] = rng.integers(0, 2 * H + 5, (B, L)).astype(np.int32)
    if mode == "bloom":
        x.update(decode.bloom_steps(rng, B, L, av_len, outw, 4))
    kw = dict(row0=2, av_len=av_len, outw=outw,
              coefs=("conv", 7) if mode == "conv7" else dem._eq_coefs(NTSC))
    same(decode.decode_rows_plain_any_shift(**to_torch(x), **kw),
         decode.decode_rows_plain(**to_torch(x), **kw))


# --- K3 hsync_chase ----------------------------------------------------------

K3 = dict(W=8, c0=20, thresh=4 * -40, H=300)


def k3_inputs(seed, B, L=21, HP=512, locked=True):
    """Line rows with a -40 sync pulse near a jittering edge, plus noise;
    `locked` starts the estimate at the edge, else anywhere."""
    rng = np.random.default_rng(seed)
    rows2 = rng.integers(-30, 60, (B, L, HP))
    edge = 100 + rng.integers(-5, 6, (B, L))
    cols = np.arange(HP)
    pulse = (cols >= edge[..., None] + K3["c0"]) \
        & (cols < edge[..., None] + K3["c0"] + 40)
    rows2 = np.where(pulse, -40 + rng.integers(-3, 4, (B, L, HP)), rows2)
    h0 = (np.full(B, 100 - K3["W"]) if locked else
          rng.integers(0, K3["H"], B))
    return dict(rows2=rows2.astype(np.int8),
                active_l=rng.random((B, L)) > 0.2,
                hsync0=h0.astype(np.int32))


# (L, HP, H, W, c0) of rows whose estimate walks across H both ways: lines
# all at -100 cross at t = 0 (a step of -W), lines at +100 never cross
# (t = 2W, a step of +W), the rest noise with a pulse anywhere; a run of
# inactive lines.  Inside the JAX kernel's contract (c0 >= 0, windows inside
# [0, HP), HP a multiple of 128) unless noted.
K3_EDGES = {
    "wrap-W8": (60, 128, 40, 8, 0),
    "wrap-W6": (60, 128, 40, 6, 0),
    "ends-at-HP": (40, 128, 104, 8, 9),      # H - 1 + c0 + 2W == HP
    # outside it: windows from below 0, and past HP
    "below-0": (50, 48, 40, 8, -16),
    "past-HP": (70, 30, 60, 6, -3),
    "W16": (33, 200, 150, 16, 5),
    # the kernel's one-lane path: estimates from outside [0, H), W >= H
    "start-outside-H": (50, 64, 40, 8, 0),
    "W-past-H": (40, 64, 10, 12, 0),
}
K3_OUTSIDE_JAX = ("below-0", "past-HP", "W16", "start-outside-H", "W-past-H")


def k3_edge_inputs(seed, B, case):
    L, HP, H, W, c0 = K3_EDGES[case]
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, (B, L))[..., None]
    cols = np.arange(HP)
    edge = rng.integers(0, HP, (B, L))[..., None]
    rows2 = rng.integers(-30, 60, (B, L, HP))
    rows2 = np.where((kind == 3) & (cols >= edge) & (cols < edge + 40), -40,
                     rows2)
    rows2 = np.where(kind == 1, -100, np.where(kind == 2, 100, rows2))
    act = rng.random((B, L)) > 0.2
    act[:, 5:15] = False
    far = 3 * H if case == "start-outside-H" else 0
    return (dict(rows2=rows2.astype(np.int8), active_l=act,
                 hsync0=rng.integers(-far, H + far, B).astype(np.int32)),
            dict(W=W, c0=c0, thresh=4 * -40, H=H))


def k3_scalar(rows2, active_l, hsync0, *, W, c0, thresh, H):
    """crt_core.c:434-450 as a loop over Python ints, samples outside
    [0, HP) read as 0."""
    B, L, HP = rows2.shape
    out = np.empty((B, L), np.int32)
    for b in range(B):
        hs = int(hsync0[b])
        for ln in range(L):
            run, j = 0, 2 * W
            for t in range(2 * W):
                x = hs + c0 + t
                run += int(rows2[b, ln, x]) if 0 <= x < HP else 0
                if run <= thresh:
                    j = t
                    break
            if active_l[b, ln]:
                hs = (j - W + hs) % H
            out[b, ln] = hs
    return out


@pytest.mark.parametrize("case", [
    pytest.param(c, id=f"{c[0]}-{c[1]}")
    for c in ((1, True), (1, False), (16, True), (16, False))] + [
    c for c in K3_EDGES if c not in K3_OUTSIDE_JAX])
def test_k3_plain_matches_jax_kernel(case):
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import hsync_scan as hsk
    if isinstance(case, tuple):
        B, locked = case
        x, k = k3_inputs(B + locked, B, locked=locked), K3
    else:
        x, k = k3_edge_inputs(len(case), 3, case)
    got = hsync.hsync_chase(**to_torch(x), **k)
    want = hsk.hsync_chase(*(jnp.asarray(x[n]) for n in
                             ("rows2", "active_l", "hsync0")),
                           interpret=True, **k)
    same(got, want)


@pytest.mark.parametrize("case", K3_OUTSIDE_JAX)
def test_k3_plain_matches_scalar_loop_outside_the_jax_contract(case):
    """Windows from below 0 or past HP (the JAX kernel's caller asserts them
    away, ntsc_crt_tpu/models/demodulate.py:393-395), W = 16, estimates that
    start outside [0, H) and W >= H: the plain version against the
    reference loop, missing samples read as 0."""
    x, k = k3_edge_inputs(len(case), 3, case)
    same(hsync.hsync_chase(**to_torch(x), **k), k3_scalar(**x, **k))


@pytest.mark.parametrize("W", [0, hsync.MAX_W + 1])
def test_k3_kernel_path_refuses_w_past_its_limit(W):
    """Lane t of the kernel's warp holds window sample t < 2W <= 32."""
    x = {n: torch.as_tensor(v).to("meta") for n, v in
         k3_inputs(0, B=1).items()}
    n = hsync.LAUNCHES
    with pytest.raises(ValueError, match="needs 1 <= W"):
        hsync.hsync_chase(**x, **dict(K3, W=W))
    assert hsync.LAUNCHES == n


@pytest.mark.gpu
def test_k3_kernel_path_refuses_unaligned_rows(cuda):
    """The kernel copies aligned words of the rows: rows2 must start on a
    4-byte boundary."""
    x = to_torch(k3_inputs(0, B=1), cuda)
    flat = torch.empty(x["rows2"].numel() + 1, dtype=torch.int8, device=cuda)
    rows2 = flat[1:].view(x["rows2"].shape)
    with pytest.raises(ValueError, match="4-byte"):
        hsync.hsync_chase(rows2, x["active_l"], x["hsync0"], **K3)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 5, 64, 512])   # 5: a part-full block
@pytest.mark.parametrize("case", ["ntsc"] + list(K3_EDGES))
def test_k3_kernel_matches_plain(cuda, case, B):
    if case == "ntsc":
        x, k = k3_inputs(B, B, L=NTSC.lines, locked=False), K3
    else:
        x, k = k3_edge_inputs(B, B, case)
    want = hsync.hsync_chase(**to_torch(x), **k)
    n = hsync.LAUNCHES
    same(hsync.hsync_chase(**to_torch(x, cuda), **k), want)
    assert hsync.LAUNCHES == n + 1


# --- K4 ccf_ema --------------------------------------------------------------


def k4_inputs(seed, B, L, m, CC, VP, lim=1 << 20):
    rng = np.random.default_rng(seed)
    return dict(
        per_cls=rng.integers(-lim, lim, (B, L, m, CC)).astype(np.int32),
        vper_l=rng.integers(0, VP, (B, L)).astype(np.int32),
        active_l=rng.random((B, L)) > 0.3,
        ccf0=rng.integers(-lim, lim, (B, VP, CC)).astype(np.int32))


@pytest.mark.parametrize("VP,CC,m,B,L,lim", [
    (3, 4, 5, 7, 33, 1 << 20),      # the shapes of test_pallas_kernels.py
    (1, 4, 5, 9, 26, 1 << 20),
    (5, 8, 4, 17, 30, 1 << 20),
    (3, 4, 5, 1, 40, 1 << 20),
    (1, 4, 10, 3, 24, 1 << 30),     # full range: ccr * 127 wraps
    (5, 5, 16, 2, 33, 1 << 30)])    # the kernel's limits; L past a chunk
def test_k4_plain_matches_jax_kernel(VP, CC, m, B, L, lim):
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import ccf_scan
    x = k4_inputs(VP + CC + B + L, B, L, m, CC, VP, lim)
    got_f, got_r = ccf.ccf_ema(**to_torch(x))
    want_f, want_r = ccf_scan.ccf_ema(
        *(jnp.asarray(x[k]) for k in ("per_cls", "vper_l", "active_l",
                                      "ccf0")), interpret=True)
    same(got_f, want_f)
    same(got_r, want_r)


# (L, m, CC, VP): NTSC, SNES, PV1K, the kernel's limits over ragged chunks,
# one line
K4_CASES = {"ntsc": (NTSC.lines, 10, 4, 1), "snes": (240, 10, 4, 3),
            "pv1k": (240, 10, 5, 5), "limits": (37, 16, 5, 5),
            "one-line": (1, 3, 2, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 5, 512])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_kernel_matches_plain(cuda, case, B):
    L, m, CC, VP = K4_CASES[case]
    x = k4_inputs(B, B, L, m, CC, VP, 1 << 30)
    want = ccf.ccf_ema(**to_torch(x))
    n = ccf.LAUNCHES
    got = ccf.ccf_ema(**to_torch(x, cuda))
    assert ccf.LAUNCHES == n + 1
    same(got[0], want[0])
    same(got[1], want[1])


# --- K5 vhs_region_b_entries ---------------------------------------------------

VHS_H = 910


def k5_seeds(seed, B):
    """int32 bit patterns of uint32 seeds over the whole range, its ends
    included."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 2**32, B, dtype=np.uint64)
    st[:2] = [0, 2**32 - 1][:B]
    return st.astype(np.uint32)


# (H, n_steps): one band a step, bands cut short by 5 steps and run 9 steps
# past the last (where every step takes three calls)
K5_EDGES = ((1, 19), (7, 19 * 7), (7, 19 * 7 - 5), (7, 19 * 7 + 9),
            (40, 19 * 40), (40, 19 * 40 - 5), (40, 19 * 40 + 9))


@pytest.mark.parametrize("B", [1, 5])
def test_k5_plain_matches_jax_kernel(B):
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import vhs_scan
    st0 = k5_seeds(B, B)
    got = vhs.vhs_region_b_entries(torch.as_tensor(st0.view(np.int32)),
                                   n_steps=19 * VHS_H, H=VHS_H)
    want = vhs_scan.vhs_region_b_entries(jnp.asarray(st0), n_steps=19 * VHS_H,
                                         H=VHS_H, interpret=True)
    same(got, np.asarray(want).view(np.int32).T)


@pytest.mark.parametrize("H,n_steps", K5_EDGES)
def test_k5_plain_matches_jax_kernel_at_edges(H, n_steps):
    """Small H, the last band cut short and steps past 19H, from the seeds
    0 and 2**32 - 1 among others."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.ops.pallas import vhs_scan
    st0 = k5_seeds(H, 4)
    got = vhs.vhs_region_b_entries(torch.as_tensor(st0.view(np.int32)),
                                   n_steps=n_steps, H=H)
    want = vhs_scan.vhs_region_b_entries(jnp.asarray(st0), n_steps=n_steps,
                                         H=H, interpret=True)
    same(got, np.asarray(want).view(np.int32).T)


@pytest.mark.parametrize("H,n_steps", [(40, 19 * 40 + 9), (7, 19 * 7 - 5),
                                       (1, 25)])
def test_k5_entries_lie_on_the_lcg_orbit(H, n_steps):
    """The identity the kernel's walk rests on: step t enters at x_{p_t} =
    LCG^{p_t}(st0), with p_0 = 0 and p_{t+1} = p_t + 2 + [(x_{p_t + 2} >> 1)
    % 20 >= 19 - t // H] (always 3 from t = 19H on)."""
    st0 = k5_seeds(n_steps, 4).astype(np.uint64)
    x = [st0]                                   # x_p for every position p
    for _ in range(3 * n_steps + 3):
        x.append((x[-1] * 1103515245 + 12345) & 0xFFFFFFFF)
    x = np.stack(x)                             # (positions, B)
    cols = np.arange(st0.size)
    p = np.zeros(st0.size, np.int64)
    want = np.empty((st0.size, n_steps), np.uint64)
    for t in range(n_steps):
        want[:, t] = x[p, cols]
        m1 = (x[p + 2, cols] >> 1) % 20
        p = p + 2 + (m1 >= max(19 - t // H, 0))
    got = vhs.vhs_region_b_entries(
        torch.as_tensor(st0.astype(np.uint32).view(np.int32)),
        n_steps=n_steps, H=H)
    same(got, want.astype(np.uint32).view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 5, 64])
@pytest.mark.parametrize("case", [(VHS_H, 19 * VHS_H)] + list(K5_EDGES))
def test_k5_kernel_matches_plain(cuda, case, B):
    H, n_steps = case
    st0 = torch.as_tensor(k5_seeds(B + 1, B).view(np.int32))
    kw = dict(n_steps=n_steps, H=H)
    want = vhs.vhs_region_b_entries(st0, **kw)
    n = vhs.LAUNCHES
    same(vhs.vhs_region_b_entries(st0.to(cuda), **kw), want)
    assert vhs.LAUNCHES == n + 1


# --- K7 / K8 row filters, K9 scan conversion, the unfused chain, K10 ----------


def row_inputs(seed, R, T, lim):
    rng = np.random.default_rng(seed)
    sets = np.array([tuple(c) for c in dem._eq_coefs(NTSC)], np.int32)
    return (rng.integers(-lim, lim, (R, T)).astype(np.int32),
            rng.integers(0, 2048, R).astype(np.int32),
            sets[rng.integers(0, 3, R)].T)


# (R, T) at the edges of csrc/rowfilters.cu's ring (32 rows a warp, a
# 128-byte line of each a tile, 4 tiles a ring): a single row and a single
# sample, a warp short, full and one past, two warps and one past, a line
# short, full and one past, a partial ring, one line past a ring, every T
# mod 4 (chip_smoke.py ROW_EDGES holds the full grid)
ROW_EDGES = [(1, 1), (33, 1), (1, 2), (32, 31), (31, 32), (33, 33), (1, 34),
             (32, 63), (33, 64), (31, 65), (33, 66), (1, 129), (32, 131),
             (33, 257), (1, 1487), (65, 35), (65, 753)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,T,lim", [(3 * 236, 753, 300), (1000, 37, 1 << 30),
                                     (31, 5, 1 << 20), (129, 1487, 300)]
                         + [(R, T, 1 << 31) for R, T in ROW_EDGES])
def test_k7_k8_kernels_match_plain(cuda, R, T, lim):
    """Ragged row and sample counts (a partial warp, a partial tile), the
    encode rows of NTSC and PV1K, full-range inputs that wrap, and the ring's
    edges (ROW_EDGES)."""
    x, c, cs = row_inputs(R + T, R, T, lim)
    t = lambda v, d="cpu": torch.as_tensor(v, device=d)  # noqa: E731
    n7, n8 = rowfilters.IIR_LAUNCHES, rowfilters.EQ_LAUNCHES
    same(rowfilters.iir_lowpass_rows(t(x, cuda), t(c, cuda)),
         rowfilters.iir_lowpass_rows(t(x), t(c)))
    same(rowfilters.eq_threeband_rows(t(x, cuda), *(t(v, cuda) for v in cs)),
         rowfilters.eq_threeband_rows(t(x), *map(t, cs)))
    assert (rowfilters.IIR_LAUNCHES, rowfilters.EQ_LAUNCHES) == (n7 + 1,
                                                                 n8 + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("ox,oy", [(1, 0), (0, 1), (5, 5), (0, 0)])
@pytest.mark.parametrize("R,T", [(33, 34), (65, 753)])
def test_k7_k8_kernels_off_the_line_grid(cuda, R, T, ox, oy):
    """x and y at word offsets ox and oy from a 128-byte line: each row's
    tiles follow y's lines, and x off y's line grid takes the 4-byte copies
    (the wrappers allocate y themselves, so the entry points are called
    directly)."""
    from ntsc_crt_tpu_torch.ops.kernels import build
    x, c, cs = row_inputs(R * T + ox + oy, R, T, 1 << 31)

    def at(off):
        return torch.zeros(R * T + 32, dtype=torch.int32,
                           device=cuda)[off:off + R * T].view(R, T)

    xd = at(ox)
    xd.copy_(torch.as_tensor(x))
    for entry, coefs, plain in (
            ("ntsc_iir_lowpass_rows", [c], rowfilters.iir_lowpass_rows_plain),
            ("ntsc_eq_threeband_rows", list(cs),
             rowfilters.eq_threeband_rows_plain)):
        yd = at(oy)
        cd = [torch.as_tensor(np.ascontiguousarray(v), device=cuda)
              for v in coefs]
        build.launch(entry, cuda, xd.data_ptr(),
                     *(v.data_ptr() for v in cd), yd.data_ptr(), R, T)
        torch.cuda.synchronize()
        same(yd, plain(torch.as_tensor(x), *map(torch.as_tensor, coefs)))


@pytest.mark.gpu
@pytest.mark.parametrize("R,T,outw,lim", [(720, 753, 640, 1 << 20),
                                          (5, 1487, 640, 1 << 27),
                                          (3, 1, 7, 1 << 20)])
def test_k9_kernel_matches_plain(cuda, R, T, outw, lim):
    rng = np.random.default_rng(T)
    x = [rng.integers(-lim, lim, (R, T)).astype(np.int32) for _ in range(3)]
    x.append(rng.integers(0, 400, R).astype(np.int32))
    want = scanconv.scanconv_rows(*map(torch.as_tensor, x), outw=outw)
    n = scanconv.LAUNCHES
    same(scanconv.scanconv_rows(*(torch.as_tensor(v, device=cuda) for v in x),
                                outw=outw), want)
    assert scanconv.LAUNCHES == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("cc", [4, 5])
def test_unfused_chain_kernels_equal_k2_kernel(cuda, cc):
    """K8 then K9 against K2, kernel against kernel, at NTSC's width."""
    x = to_torch(k2_inputs(cc + 10, B=2, L=NTSC.lines, H=NTSC.hres, cc=cc,
                           row0=3), cuda)
    kw = dict(row0=3, coefs=dem._eq_coefs(NTSC), av_len=NTSC.av_len,
              outw=640)
    n = (rowfilters.EQ_LAUNCHES, scanconv.LAUNCHES)
    same(scanconv.decode_rows_unfused(**x, **kw), decode.decode_rows(**x, **kw))
    assert (rowfilters.EQ_LAUNCHES, scanconv.LAUNCHES) == (n[0] + 1, n[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", probe.PATTERNS)
@pytest.mark.parametrize("iters", [0, 100])
def test_k10_kernel_matches_plain(cuda, pattern, iters):
    x = probe.probe_input(3, "cpu")
    want = probe.probe(x, pattern, iters=iters)
    n = probe.LAUNCHES
    same(probe.probe(x.to(cuda), pattern, iters=iters), want)
    assert probe.LAUNCHES == n + 1


# --- dispatch -----------------------------------------------------------------


def k2_bloom_inputs():
    x = k2_inputs(0, B=1, L=4, H=160, cc=4)
    return dict(x, bloom_dx=np.full((1, 4), 4000, np.int32),
                bloom_lidx=np.full((1, 4), 9, np.int32))


@pytest.mark.parametrize("name", ["encode_rows", "decode_rows", "hsync_chase",
                                  "ccf_ema", "vhs_region_b_entries",
                                  "decode_rows_conv", "decode_rows_bloom",
                                  "bloom_line_width", "place_rows_uniform",
                                  "iir_lowpass_rows", "eq_threeband_rows",
                                  "scanconv_rows", "probe"])
def test_non_cpu_tensors_never_take_the_plain_version(name):
    """Only a CPU tensor takes the plain version.  Any other tensor goes to
    the kernel path, which refuses a tensor that is not on a CUDA device
    before it builds or launches anything."""
    from ntsc_crt_tpu_torch.ops.kernels import place
    k2 = dict(row0=1, av_len=64, outw=48)
    call = {
        "encode_rows": lambda x: encode.encode_rows(
            **x, coefs=IIR, xo_mod=0, destw=32),
        "decode_rows": lambda x: decode.decode_rows(
            **x, coefs=dem._eq_coefs(NTSC), **k2),
        "hsync_chase": lambda x: hsync.hsync_chase(**x, **K3),
        "ccf_ema": lambda x: ccf.ccf_ema(**x),
        "vhs_region_b_entries": lambda x: vhs.vhs_region_b_entries(
            **x, n_steps=19 * VHS_H, H=VHS_H),
        "decode_rows_conv": lambda x: decode.decode_rows(
            **x, coefs=("conv", 7), **k2),
        "decode_rows_bloom": lambda x: decode.decode_rows(
            **x, coefs=dem._eq_coefs(NTSC), **k2),
        "bloom_line_width": lambda x: decode.bloom_line_width(
            **x, row0=0, av_len=5),
        "place_rows_uniform": lambda x: place.place_rows_uniform(
            **x, blend=True, scanlines=1, ratio=2, fp=1),
        "iir_lowpass_rows": lambda x: rowfilters.iir_lowpass_rows(
            x["x"], x["c"]),
        "eq_threeband_rows": lambda x: rowfilters.eq_threeband_rows(
            x["x"], *x["cs"]),
        "scanconv_rows": lambda x: scanconv.scanconv_rows(
            x["x"], x["x"], x["x"], x["c"], outw=8),
        "probe": lambda x: probe.probe(x["x"], "eq1", iters=2),
    }[name]
    x = {"encode_rows": lambda: k1_inputs(0, B=1, h=9, w=20, desth=8, cc=4),
         "decode_rows": lambda: k2_inputs(0, B=1, L=4, H=160, cc=4),
         "hsync_chase": lambda: k3_inputs(0, B=1),
         "ccf_ema": lambda: k4_inputs(0, 1, 4, 10, 4, 1),
         "vhs_region_b_entries": lambda: dict(
             st0=k5_seeds(0, 2).view(np.int32)),
         "decode_rows_conv": lambda: k2_inputs(0, B=1, L=4, H=160, cc=4),
         "decode_rows_bloom": k2_bloom_inputs,
         "bloom_line_width": lambda: dict(
             rows=np.zeros((2, 9, 16), np.int8),
             xpos_l=np.zeros((2, 8), np.int32), max_e=np.ones(2, np.int32)),
         "place_rows_uniform": lambda: dict(
             rgb=np.zeros((2, 4, 8, 3), np.uint8),
             old=np.zeros((2, 8, 8, 3), np.uint8),
             field_px=np.ones(2, np.int32)),
         "iir_lowpass_rows": lambda: dict(zip("xc", row_inputs(0, 4, 8, 9))),
         "eq_threeband_rows": lambda: dict(zip(("x", "c", "cs"),
                                               row_inputs(0, 4, 8, 9))),
         "scanconv_rows": lambda: dict(zip("xc", row_inputs(0, 4, 8, 9))),
         "probe": lambda: dict(x=probe.probe_input(1, "cpu"))}[name]()
    counter = {"encode_rows": (encode, "LAUNCHES"),
               "decode_rows": (decode, "LAUNCHES"),
               "hsync_chase": (hsync, "LAUNCHES"),
               "ccf_ema": (ccf, "LAUNCHES"),
               "vhs_region_b_entries": (vhs, "LAUNCHES"),
               "decode_rows_conv": (decode, "CONV_LAUNCHES"),
               "decode_rows_bloom": (decode, "BLOOM_LAUNCHES"),
               "bloom_line_width": (decode, "LINE_WIDTH_LAUNCHES"),
               "place_rows_uniform": (place, "LAUNCHES"),
               "iir_lowpass_rows": (rowfilters, "IIR_LAUNCHES"),
               "eq_threeband_rows": (rowfilters, "EQ_LAUNCHES"),
               "scanconv_rows": (scanconv, "LAUNCHES"),
               "probe": (probe, "LAUNCHES")}[name]
    n = getattr(*counter)
    meta = lambda v: torch.as_tensor(v).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="expected a tensor on"):
        call({k: [meta(c) for c in v] if k == "cs" else meta(v)
              for k, v in x.items()})
    assert getattr(*counter) == n
