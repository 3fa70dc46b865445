"""Frame slots split over devices (parallel/mesh.py).  On the CPU two CPU
"devices" stand in for two cards: splitting, stepping each chunk on its
device and merging must equal step_batch on the whole batch, leaf by leaf
(0 LSB).  The tests marked `gpu` need two cards or more and skip with
fewer: there each kernel must launch with its tensors' card current, the
split over every card must equal step_batch on one, and a live frame on a
second card must reach the host.  This file imports no JAX, so a box
without it runs them:

    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \
        tests/test_torch_mesh.py -m gpu
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.apps.live import LiveSession
from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import NTSC, NTSCVHS
from ntsc_crt_tpu_torch.ops.kernels import build
from ntsc_crt_tpu_torch.parallel import mesh

torch.set_num_threads(1)  # the tier runs several workers on few cores

CPUS = ["cpu", "cpu"]


def same_state(a, b, tag=""):
    for k in pipeline.CRTState._fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and torch.equal(x, y), f"{tag} {k}"


@pytest.mark.parametrize("cfg,B,kw", [(NTSC, 4, {}),
                                      (NTSCVHS, 3, {"do_aberration": 1})])
def test_sharded_step_equals_step_batch(cfg, B, kw):
    """Two steps over two devices (B = 4: 2 + 2; B = 3: 2 + 1), a (B,)
    tensor knob among the monitor's, then the merge: the sharded step
    (pipeline.step_batch on each chunk) equals make_batched_step's."""
    rng = np.random.RandomState(B)
    imgs = torch.as_tensor(rng.randint(0, 256, (B, 48, 64, 3), np.uint8))
    fields = torch.arange(B, dtype=torch.int32) % 2
    dcos = torch.zeros(B, dtype=torch.int32)
    mon = MonitorParams(contrast=torch.arange(170, 170 + B,
                                              dtype=torch.int32), blend=1)
    chunks = mesh.init_batch(cfg, B, 96, 72, devices=CPUS)
    assert [c.analog.shape[0] for c in chunks] == [(B + 1) // 2, B // 2]
    whole = pipeline.init_batch(cfg, B, 96, 72, device="cpu")
    same_state(mesh.gather(chunks), whole, "init")
    step = mesh.make_sharded_step(cfg, CPUS, noise=6, mon=mon, **kw)
    batched = mesh.make_batched_step(cfg, noise=6, mon=mon, **kw)
    for i in range(2):
        chunks = step(chunks, imgs, fields ^ i, fields, dcos)
        whole = batched(whole, imgs, fields ^ i, fields, dcos)
        same_state(mesh.gather(chunks), whole, f"step {i}")


def test_split_bounds_and_misuse():
    assert mesh.split_bounds(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert mesh.split_bounds(4, 1) == [(0, 4)]
    with pytest.raises(ValueError, match="cannot fill"):
        mesh.split_bounds(1, 2)
    with pytest.raises(ValueError, match="no devices"):
        mesh.resolve_devices([])
    chunks = mesh.init_batch(NTSC, 4, 32, 24, devices=CPUS)
    step = mesh.make_sharded_step(NTSC, ["cpu"])
    z = torch.zeros(4, dtype=torch.int32)
    imgs = torch.zeros((4, 24, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="2 chunks for 1 devices"):
        step(chunks, imgs, z, z, z)
    with pytest.raises(ValueError, match="the batch 5"):
        mesh.make_sharded_step(NTSC, CPUS)(
            chunks, torch.zeros((5, 24, 32, 3), dtype=torch.uint8),
            *[torch.zeros(5, dtype=torch.int32)] * 3)


def test_launch_makes_the_tensor_card_current(monkeypatch):
    """build.launch calls the entry point with the given card current and
    that card's stream last, and restores the current card after; a CUDA
    error it reports raises.  (The CUDA calls are stand-ins here: a kernel
    may launch only into a stream of the current device.)"""
    current, seen = [0], []

    @contextlib.contextmanager
    def device(dev):
        old, current[0] = current[0], torch.device(dev).index
        try:
            yield
        finally:
            current[0] = old

    def entry(*args):
        seen.append((current[0], args))
        return 0 if args[0] else 700

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        types.SimpleNamespace(cuda_stream=1000 + torch.device(dev).index)))
    monkeypatch.setattr(build, "library", lambda: types.SimpleNamespace(
        ntsc_probe=entry))
    build.launch("ntsc_probe", torch.device("cuda", 2), 5, 6)
    assert seen == [(2, (5, 6, 1002))] and current == [0]
    with pytest.raises(RuntimeError, match="ntsc_probe: CUDA error 700"):
        build.launch("ntsc_probe", torch.device("cuda", 3), 0)
    assert seen[-1] == (3, (0, 1003)) and current == [0]


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.gpu
def test_sharded_step_over_every_card(cards, monkeypatch):
    """Two steps of 2 slots a card, with cuda:0 current throughout, equal
    step_batch on cuda:0; every kernel launched into the current stream of
    the card that was current at its launch, and every card launched."""
    lib, launches = build.library(), []

    class Recording:
        def __getattr__(self, name):
            fn = getattr(lib, name)

            def call(*args):
                dev = torch.cuda.current_device()
                launches.append(
                    (dev, args[-1] == torch.cuda.current_stream(dev)
                     .cuda_stream))
                return fn(*args)
            return call

    B = 2 * len(cards)
    rng = np.random.RandomState(11)
    imgs = torch.as_tensor(rng.randint(0, 256, (B, 240, 320, 3), np.uint8),
                           device=cards[0])
    z = torch.zeros(B, dtype=torch.int32, device=cards[0])
    whole = pipeline.init_batch(NTSC, B, 640, 480, device=cards[0])
    batched = mesh.make_batched_step(NTSC, noise=12)
    for i in range(2):
        whole = batched(whole, imgs, z + i, z, z)
    monkeypatch.setattr(build, "library", Recording)
    torch.cuda.set_device(cards[0])
    chunks = mesh.init_batch(NTSC, B, 640, 480, devices=cards)
    step = mesh.make_sharded_step(NTSC, cards, noise=12)
    for i in range(2):
        chunks = step(chunks, imgs, z + i, z, z)
    assert [c.analog.device for c in chunks] == cards
    same_state(mesh.gather(chunks), whole, "every card")
    assert all(ok for _, ok in launches), launches
    assert {d for d, _ in launches} == {c.index for c in cards}, launches


@pytest.mark.gpu
def test_live_frame_from_a_second_card(cards):
    """A LiveSession on cuda:1, with cuda:0 current: its pending frames
    (a copy and an event on cuda:1's stream) equal the session's on
    cuda:0, full and previewed."""
    img = np.random.RandomState(12).randint(0, 256, (240, 320, 3), np.uint8)
    torch.cuda.set_device(cards[0])
    a = LiveSession(NTSC, 320, 240, noise=4, device=cards[0])
    b = LiveSession(NTSC, 320, 240, noise=4, device=cards[1])
    for hw in (None, (30, 80), None):
        want = a.tick_fast(img, preview_hw=hw)
        got = np.asarray(b.tick_fast(img, preview_hw=hw, fetch=False))
        assert torch.cuda.current_device() == 0
        np.testing.assert_array_equal(got, want)
