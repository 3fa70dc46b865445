"""Each frame's lines split over a group of devices (parallel/spatial.py,
mesh.make_mesh's `spatial` axis).  On the CPU, "cpu" devices stand in for
cards: a step over an (n_data, n_spatial) mesh must equal step_batch on the
whole batch, leaf by leaf (0 LSB), and the JAX package's batched step; K1
and K2 must split their lines so that every line is decoded once, and K3,
K4 and the row placement must run whole.  The line and row helpers are held
at ragged counts (an uneven split, fewer lines than cards), and the demo's
files to the JAX demo's.  The tests marked `gpu` need two cards or more and
skip with fewer: the split over every card must equal one card, and each
shard must launch on its own card.  Run them on a box with the cards:

    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \\
        tests/test_torch_spatial.py -m gpu
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import demodulate as dem
from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import NTSC, NTSCVHS, PV1K
from ntsc_crt_tpu_torch.ops import filters
from ntsc_crt_tpu_torch.ops.kernels import (build, ccf, decode, encode,
                                            hsync, scanconv)
from ntsc_crt_tpu_torch.parallel import mesh, spatial

torch.set_num_threads(1)  # the tier runs several workers on few cores

REPO = Path(__file__).resolve().parent.parent


def cpus(n):
    return ["cpu"] * n


def same_state(a, b, tag=""):
    for k in pipeline.CRTState._fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and torch.equal(x, y), f"{tag} {k}"


def frames(B, seed):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randint(0, 256, (B, 48, 64, 3), np.uint8))


@pytest.fixture
def records(monkeypatch):
    """Every sharded call as (tag, [(device, lo, hi), ...])."""
    seen = []
    monkeypatch.setattr(spatial, "_INSPECT",
                        lambda tag, shards: seen.append((tag, shards)))
    return seen


def covers_once(shards, n, group):
    """The shards tile [0, n) in order, one on each of the group's first
    min(len(group), n) cards."""
    assert [d for d, _, _ in shards] == \
        [torch.device(g) for g in group[:min(len(group), n)]]
    assert shards[0][1] == 0 and shards[-1][2] == n
    assert all(a[2] == b[1] for a, b in zip(shards, shards[1:]))
    assert all(hi > lo for _, lo, hi in shards)


@pytest.mark.parametrize("cfg,B,shape,kw", [
    (NTSC, 4, (2, 2), {}),
    (NTSCVHS, 2, (1, 3), {"do_aberration": 1}),   # 236 picture rows: 79/79/78
    (NTSC, 2, (2, 2), {"do_bloom": True}),
    (PV1K, 2, (1, 2), {}),
], ids=["NTSC", "NTSCVHS", "bloom", "PV1K"])
def test_sharded_step_equals_step_batch(cfg, B, shape, kw, records):
    """Two steps over the mesh, a (B,) contrast knob among the monitor's,
    then the merge: equal to make_batched_step's on the whole batch; K1
    and K2 split every frame's lines over each row of the mesh."""
    imgs = frames(B, B)
    fields = torch.arange(B, dtype=torch.int32) % 2
    dcos = torch.arange(B, dtype=torch.int32) % 3
    mon = MonitorParams(contrast=torch.arange(170, 170 + B,
                                              dtype=torch.int32), blend=1)
    m = mesh.make_mesh(*shape, cpus(shape[0] * shape[1]))
    chunks = mesh.init_batch(cfg, B, 96, 72, devices=m)
    whole = pipeline.init_batch(cfg, B, 96, 72, device="cpu")
    step = mesh.make_sharded_step(cfg, m, noise=6, mon=mon, **kw)
    batched = mesh.make_batched_step(cfg, noise=6, mon=mon, **kw)
    for i in range(2):
        chunks = step(chunks, imgs, fields ^ i, fields, dcos)
        whole = batched(whole, imgs, fields ^ i, fields, dcos)
        same_state(mesh.gather(chunks), whole, f"step {i}")
    tags = [t for t, _ in records]
    assert tags == ["encode_rows", "decode_rows"] * shape[0] * 2
    for tag, shards in records:
        n = cfg.lines if tag == "decode_rows" else shards[-1][2]
        covers_once(shards, n, m[0])


def test_sharded_step_equals_jax():
    """One NTSC batch-4 step over the 2x2 mesh equals the JAX package's
    unsharded batched step (make_batched_step, donate=False), which its
    own tests hold its sharded step to."""
    import jax.numpy as jnp
    from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
    from ntsc_crt_tpu.models.systems import NTSC as JNTSC
    from ntsc_crt_tpu.parallel import mesh as jmesh
    from ntsc_crt_tpu_torch.utils import convert
    B = 4
    imgs = frames(B, 7)
    fields = torch.arange(B, dtype=torch.int32) % 2
    contrast = np.arange(170, 170 + B, dtype=np.int32)
    m = mesh.make_mesh(2, 2, cpus(4))
    step = mesh.make_sharded_step(
        NTSC, m, noise=6, mon=MonitorParams(contrast=torch.as_tensor(
            contrast)))
    got = mesh.gather(step(mesh.init_batch(NTSC, B, 96, 72, devices=m),
                           imgs, fields, fields ^ 1, fields * 0))
    jstep = jmesh.make_batched_step(
        JNTSC, noise=6, mon=JMon(contrast=jnp.asarray(contrast)),
        donate=False)
    f = jnp.asarray(fields.numpy())
    want = jstep(jmesh.init_batch(JNTSC, B, 96, 72), jnp.asarray(imgs.numpy()),
                 f, f ^ 1, f * 0)
    got = convert.state_to_numpy(got)
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_inspect_splits_k1_k2_only(records, monkeypatch):
    """One NTSC batch-1 step over a 1x3 mesh: K1's 236 picture rows and
    K2's 240 lines split 79/79/78 and 80/80/80, every line once, on the
    row's cards in order; K3, K4 and the row placement see every line."""
    whole_lines = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def run(*a, **k):
            whole_lines.append((name, a[0].shape[1]))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, run)
    spy(hsync, "hsync_chase")
    spy(ccf, "ccf_ema")
    spy(dem, "_place_rows")
    m = mesh.make_mesh(1, 3, cpus(3))
    step = mesh.make_sharded_step(NTSC, m, noise=6)
    z = torch.zeros(1, dtype=torch.int32)
    step(mesh.init_batch(NTSC, 1, 96, 72, devices=m), frames(1, 3), z, z, z)
    assert [(t, [(lo, hi) for _, lo, hi in s]) for t, s in records] == [
        ("encode_rows", [(0, 79), (79, 158), (158, 236)]),
        ("decode_rows", [(0, 80), (80, 160), (160, 240)])]
    for _, shards in records:
        covers_once(shards, shards[-1][2], m[0])
    assert sorted(whole_lines) == [("_place_rows", 240), ("ccf_ema", 240),
                                   ("hsync_chase", 240)]


def k2_args(rng, B, L, H, av, cc=4):
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    return dict(
        rows=torch.as_tensor(rng.randint(-128, 128, (B, L + 4, H), np.int8)),
        shifts=i32(rng.randint(0, H - av, (B, L))),
        waveI=i32(rng.randint(-400, 400, (B, L, cc))),
        waveQ=i32(rng.randint(-400, 400, (B, L, cc))),
        bright=i32(rng.randint(-40, 40, (B, L))),
        contrast=i32(rng.randint(150, 200, (B, L))))


@pytest.mark.parametrize("L,n", [(10, 3), (2, 3), (7, 2)])
def test_line_and_row_helpers_at_ragged_counts(L, n, records):
    """K2 (3-band and bloom), K1, and K7, K8 and K9 through their op
    entries, split over n devices at L lines (or rows): an uneven split
    and fewer lines than devices, every border inside the picture; each
    equals the unsplit call and covers every line once."""
    rng = np.random.RandomState(L * 10 + n)
    B, H, av, outw = 2, 40, 24, 30
    a = k2_args(rng, B, L, H, av)
    coefs = dem._eq_coefs(NTSC)
    bloom = {k: torch.as_tensor(v) for k, v in decode.bloom_steps(
        np.random.default_rng(L), B, L, av, outw, 4).items()}

    def k2(bl):
        return spatial.shard_lines_call(
            decode.decode_rows, *a.values(), halo={0: 4}, row0=3,
            coefs=coefs, av_len=av, outw=outw, **bl)

    img = torch.as_tensor(rng.randint(0, 256, (B, 9, 16, 3), np.uint8))
    sy = torch.as_tensor(rng.randint(0, 9, (B, L)).astype(np.int32))

    def k1():
        return spatial.shard_lines_call(
            encode.encode_rows, img, sy, a["waveI"], a["waveQ"],
            a["contrast"][:, 0].contiguous(), a["bright"][:, 0].contiguous(),
            whole=(0, 4, 5), coefs=(600, 300, 200), xo_mod=1, destw=21)

    x = torch.as_tensor(rng.randint(-5000, 5000, (L, 3, 33), np.int32))

    def ops():
        return (filters.iir_lowpass(x, 700),
                filters.eq_threeband(x, *[c[0] for c in zip(*coefs)]),
                scanconv.decode_rows_unfused(
                    a["rows"], a["shifts"], a["waveI"], a["waveQ"],
                    a["bright"], a["contrast"], row0=3, coefs=coefs,
                    av_len=av, outw=outw))

    want = [k2({}), k2(bloom), k1(), *ops()]
    assert not records
    with spatial.line_sharding(cpus(n)):
        got = [k2({}), k2(bloom), k1(), *ops()]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    assert [t for t, _ in records] == [
        "decode_rows", "decode_rows", "encode_rows", "iir_lowpass_rows",
        "eq_threeband_rows", "eq_threeband_rows", "scanconv_rows"]
    sizes = [L, L, L, 3 * L, 3 * L, 3 * B * L, B * L]
    for (_, shards), size in zip(records, sizes):
        covers_once(shards, size, cpus(n))


def test_make_mesh_shapes():
    m = mesh.make_mesh(2, 2, cpus(4))
    assert m.shape == {"data": 2, "spatial": 2} and len(m) == 2
    assert m[1] == [torch.device("cpu")] * 2
    assert mesh.make_mesh(None, 2, cpus(6)).shape == {"data": 3,
                                                      "spatial": 2}
    assert mesh.make_mesh(devices=cpus(3)).shape == {"data": 3, "spatial": 1}
    assert mesh.as_mesh(cpus(2)).shape == {"data": 2, "spatial": 1}
    for args in ((3, 2, cpus(4)), (1, 3, cpus(2)), (None, 3, cpus(2)),
                 (2, 0, cpus(2)), (None, 0, cpus(2))):
        with pytest.raises(ValueError, match="devices"):
            mesh.make_mesh(*args)
    with spatial.line_sharding(cpus(1)):
        assert not spatial.active()
    with spatial.line_sharding(cpus(2)):
        assert spatial.active()
        with spatial.line_sharding(None):
            assert not spatial.active()
    assert not spatial.active()
    chunks = mesh.init_batch(NTSC, 3, 32, 24, devices=mesh.make_mesh(
        2, 2, cpus(4)))
    assert [c.analog.shape[0] for c in chunks] == [2, 1]


def test_demo_matches_jax_demo(tmp_path, monkeypatch):
    """The demo's NTSC files (input, decoded frame, analog dump) equal the
    JAX demo's byte for byte, SYSTEMS narrowed to NTSC in both.  The JAX
    demo runs with pipeline.step under jax.jit (the same function,
    compiled once rather than op by op)."""
    import jax
    from ntsc_crt_tpu.models import pipeline as jpipe
    from ntsc_crt_tpu.models import systems as jsystems
    from ntsc_crt_tpu_torch import demo
    from ntsc_crt_tpu_torch.models import systems
    monkeypatch.setattr(jsystems, "SYSTEMS", {"NTSC": jsystems.NTSC})
    monkeypatch.setattr(systems, "SYSTEMS", {"NTSC": systems.NTSC})
    monkeypatch.setattr(jpipe, "step", jax.jit(jpipe.step,
                                               static_argnums=(0,)))
    spec = importlib.util.spec_from_file_location(
        "jax_demo", REPO / "examples" / "demo.py")
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    monkeypatch.setattr(sys, "argv", ["demo.py", str(tmp_path / "jax")])
    jdemo.main()
    assert demo.main([str(tmp_path / "port")], device="cpu") == 0
    names = ["input.ppm", "ntsc.ppm", "ntsc_analog.ppm"]
    for d in ("jax", "port"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == \
            sorted(names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def gpu_frames(B, dev):
    rng = np.random.RandomState(21)
    return torch.as_tensor(rng.randint(0, 256, (B, 240, 320, 3), np.uint8),
                           device=dev)


@pytest.mark.gpu
def test_split_over_every_card_equals_one_card(cards):
    """Two NTSC steps, 640x480, with every card on `spatial` (batch 1 and
    2) and, with four cards or more, two on `data`: equal to step_batch on
    cuda:0, every leaf."""
    n = len(cards)
    shapes = [(1, n)] + ([(2, n // 2)] if n >= 4 and n % 2 == 0 else [])
    for B in (1, 2):
        imgs = gpu_frames(B, cards[0])
        z = torch.zeros(B, dtype=torch.int32, device=cards[0])
        whole = pipeline.init_batch(NTSC, B, 640, 480, device=cards[0])
        for i in range(2):
            whole = pipeline.step_batch(NTSC, whole, imgs, z + i, z, z,
                                        noise=12)
        for shape in shapes:
            if B < shape[0]:
                continue
            m = mesh.make_mesh(*shape, cards)
            chunks = mesh.init_batch(NTSC, B, 640, 480, devices=m)
            step = mesh.make_sharded_step(NTSC, m, noise=12)
            for i in range(2):
                chunks = step(chunks, imgs, z + i, z, z)
            same_state(mesh.gather(chunks), whole, f"B {B} mesh {shape}")


@pytest.mark.gpu
def test_each_shard_launches_on_its_card(cards, records, monkeypatch):
    """With cuda:0 current, one NTSC batch-1 step over a 1 x n mesh
    launches K1 and K2 once on each card, in the group's order, each into
    the current stream of the card current at its launch; K3, K4 and K6
    launch on cuda:0 alone.  K7, K8 and K9 through their op entries do
    the same and equal their calls on one card."""
    lib, launches = build.library(), []

    class Recording:
        def __getattr__(self, name):
            fn = getattr(lib, name)

            def call(*args):
                dev = torch.cuda.current_device()
                assert args[-1] == torch.cuda.current_stream(dev).cuda_stream
                launches.append((name, dev))
                return fn(*args)
            return call

    torch.cuda.set_device(cards[0])
    n = len(cards)
    m = mesh.make_mesh(1, n, cards)
    imgs = gpu_frames(1, cards[0])
    z = torch.zeros(1, dtype=torch.int32, device=cards[0])
    chunks = mesh.init_batch(NTSC, 1, 640, 480, devices=m)
    step = mesh.make_sharded_step(NTSC, m, noise=12)
    monkeypatch.setattr(build, "library", Recording)
    step(chunks, imgs, z, z, z)
    torch.cuda.synchronize()
    order = list(range(n))
    by = lambda k: [d for name, d in launches if name == k]  # noqa: E731
    assert by("ntsc_encode_rows") == order and by("ntsc_decode_rows") == order
    for k in ("ntsc_hsync_chase", "ntsc_ccf_ema", "ntsc_place_rows_uniform"):
        assert by(k) == [0], (k, launches)
    for _, shards in records:
        covers_once(shards, shards[-1][2], cards)

    x = torch.as_tensor(np.random.RandomState(5).randint(
        -5000, 5000, (240, 3, 753), np.int32), device=cards[0])
    coefs = [c[0] for c in zip(*dem._eq_coefs(NTSC))]
    want = (filters.iir_lowpass(x, 700), filters.eq_threeband(x, *coefs))
    launches.clear()
    with spatial.line_sharding(cards):
        got = (filters.iir_lowpass(x, 700), filters.eq_threeband(x, *coefs))
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert by("ntsc_iir_lowpass_rows") == order
    assert by("ntsc_eq_threeband_rows") == order
    a = k2_args(np.random.RandomState(6), 1, 240, 910, 753)
    a = {k: v.to(cards[0]) for k, v in a.items()}
    kw = dict(row0=3, coefs=dem._eq_coefs(NTSC), av_len=753, outw=640)
    want = scanconv.decode_rows_unfused(*a.values(), **kw)
    launches.clear()
    with spatial.line_sharding(cards):
        got = scanconv.decode_rows_unfused(*a.values(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert by("ntsc_scanconv_rows") == order
