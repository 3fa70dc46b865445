"""The port's video pipeline, checkpoints and profiling against the JAX
package, on the CPU.

`video_exact` and `video_strided` run the same numpy-seeded frames through
both packages and every output frame and final state leaf must agree (0
LSB: every value is an integer).  The JAX runs are made once per module and
reused by every assertion on them, including the check of the committed
video goldens (`tests/fixtures/video_goldens.npz`, made by
`make_video_goldens` below), which hold the card's video to JAX where JAX
is not installed (`chip_smoke.py`).

Regenerate the goldens (JAX package, CPU):

    python -c "import sys; sys.path[:0] = ['tests', '.']; \\
        import test_torch_video as t; t.make_video_goldens()"
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ntsc_crt_tpu.models import pipeline as jpipe
from ntsc_crt_tpu.models import video as jvideo
from ntsc_crt_tpu.models.demodulate import MonitorParams as JMon
from ntsc_crt_tpu.models.systems import NTSC as JNTSC
from ntsc_crt_tpu_torch.models import pipeline, video
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import NTSC
from ntsc_crt_tpu_torch.utils import checkpoint, convert, profiling

torch.set_num_threads(1)  # the tier runs several workers on few cores

REPO = Path(__file__).resolve().parent.parent
VIDEO_GOLDENS = REPO / "tests" / "fixtures" / "video_goldens.npz"

# Each golden case's recipe, written into the goldens file (`<case>/recipe`,
# fields named by `recipe_fields`) so that chip_smoke.py replays the file's
# own recipe: `frames` numpy-seeded (`seed`) in_w x in_h images through
# video_exact from a fresh state (batch 0) or video_strided over `batch`
# slots, at outw x outh, with `noise`, blend and scanlines set to `blend`,
# and `v_fac`.
RECIPE_FIELDS = ("frames", "seed", "noise", "blend", "v_fac", "batch",
                 "in_w", "in_h", "outw", "outh")
SIZES = dict(in_w=96, in_h=72, outw=160, outh=120)
CASES = {
    "ntsc": dict(frames=6, seed=0, noise=10, blend=0, v_fac=0, batch=0,
                 **SIZES),
    "vfac4": dict(frames=4, seed=3, noise=10, blend=1, v_fac=4, batch=0,
                  **SIZES),
    "strided": dict(frames=8, seed=1, noise=7, blend=0, v_fac=0, batch=4,
                    **SIZES),
}
OUTW, OUTH = SIZES["outw"], SIZES["outh"]
STRIDED_B = CASES["strided"]["batch"]
STRIDED_K = CASES["strided"]["frames"] // STRIDED_B


def frames_np(n, seed, w=96, h=72):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


def case_frames(case):
    r = CASES[case]
    return frames_np(r["frames"], r["seed"], r["in_w"], r["in_h"])


def frame_sum(out):
    return out.to(torch.int32).sum(dtype=torch.int32)


def jax_run(case):
    """JAX's (leaves, outs) of a golden case."""
    r = CASES[case]
    mon = JMon(blend=np.int32(r["blend"]), scanlines=np.int32(r["blend"]))
    if r["batch"]:
        fn = jax.jit(lambda s, f: jvideo.video_strided(
            JNTSC, s, f, noise=r["noise"], mon=mon, v_fac=r["v_fac"]))
        st0 = jpipe.crt_init(JNTSC, r["outw"], r["outh"], batch=r["batch"])
    else:
        fn = jax.jit(lambda s, f: jvideo.video_exact(
            JNTSC, s, f, noise=r["noise"], mon=mon, v_fac=r["v_fac"]))
        st0 = jpipe.crt_init(JNTSC, r["outw"], r["outh"])
    st, outs = fn(st0, jnp.asarray(case_frames(case)))
    return ({k: np.asarray(v) for k, v in st._asdict().items()},
            np.asarray(outs))


def port_run(case, out_transform=None):
    """The port's (leaves, outs) of a golden case on the CPU."""
    r = CASES[case]
    fn = video.video_strided if r["batch"] else video.video_exact
    st0 = pipeline.crt_init(NTSC, r["outw"], r["outh"],
                            batch=r["batch"] or None, device="cpu")
    st, outs = fn(NTSC, st0, torch.as_tensor(case_frames(case)),
                  noise=r["noise"],
                  mon=MonitorParams(blend=r["blend"], scanlines=r["blend"]),
                  out_transform=out_transform, v_fac=r["v_fac"])
    return convert.state_to_numpy(st), outs.numpy()


def sha256(a: np.ndarray) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(a.tobytes()).digest(), np.uint8)


def golden_arrays(runs) -> dict:
    """The goldens file's arrays: `recipe_fields`, and per case its recipe,
    its outs, its analog field's SHA-256 and its other leaves but `out`
    (the last frame, or chunk, of outs): the file stays under 1 MB."""
    arrays = {"recipe_fields": np.array(RECIPE_FIELDS)}
    for case, r in CASES.items():
        leaves, outs = runs[case]
        last = outs[-r["batch"]:] if r["batch"] else outs[-1]
        assert np.array_equal(leaves["out"], last), case
        arrays[f"{case}/recipe"] = np.array([r[f] for f in RECIPE_FIELDS],
                                            np.int64)
        arrays[f"{case}/outs"] = outs
        arrays[f"{case}/analog_sha256"] = sha256(leaves["analog"])
        arrays.update({f"{case}/{k}": v for k, v in leaves.items()
                       if k not in ("analog", "out")})
    return arrays


def make_video_goldens(path=VIDEO_GOLDENS):
    """Write the JAX package's video outputs for the golden cases."""
    np.savez_compressed(path, **golden_arrays(
        {case: jax_run(case) for case in CASES}))


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX run once for the module: (leaves, outs) per case."""
    return {case: jax_run(case) for case in CASES}


def same(got, want, tag):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got, want), \
        f"{tag}: {int((got != want).sum())} elements differ"


def same_run(got, want, tag):
    (gl, go), (wl, wo) = got, want
    same(go, wo, f"{tag} outs")
    for k in pipeline.CRTState._fields:
        same(gl[k], wl[k], f"{tag} {k}")


@pytest.mark.parametrize("name", ["ntsc", "vfac4"])
def test_video_exact_matches_jax(jax_runs, name):
    """Every frame and final leaf; vfac4: v_fac 4 with blend and scanlines
    on, the first v_fac > 0 step held to JAX."""
    same_run(port_run(name), jax_runs[name], name)


def test_video_exact_out_transform_matches_jax(jax_runs):
    """A per-frame sum as out_transform: the sums of JAX's frames, and the
    final leaves of JAX's run."""
    leaves, outs = jax_runs["ntsc"]
    got_leaves, sums = port_run("ntsc", frame_sum)
    assert sums.shape == (6,) and sums.dtype == np.int32
    same_run((got_leaves, sums),
             (leaves, outs.astype(np.int32).sum(axis=(1, 2, 3))), "ntsc sum")


def test_video_strided_matches_jax(jax_runs):
    """Every frame and leaf; with a per-chunk out_transform, (k, B) sums of
    JAX's frames."""
    got = port_run("strided")
    assert got[1].shape == (STRIDED_B * STRIDED_K, OUTH, OUTW, 3)
    same_run(got, jax_runs["strided"], "strided")
    leaves, outs = jax_runs["strided"]
    per_chunk = port_run("strided", lambda o: o.to(torch.int32).sum(
        dim=(1, 2, 3), dtype=torch.int32))
    want = outs.astype(np.int32).reshape(
        STRIDED_K, STRIDED_B, -1).sum(axis=2)
    assert per_chunk[1].shape == (STRIDED_K, STRIDED_B)
    same_run(per_chunk, (leaves, want), "strided sum")


def test_video_strided_slot_is_exact_sub_video():
    """Slot 0 decodes frames 0, B, 2B, ... exactly as video_exact does."""
    _, outs = port_run("strided")
    sub = torch.as_tensor(case_frames("strided")[0::STRIDED_B])
    _, ref = video.video_exact(
        NTSC, pipeline.crt_init(NTSC, OUTW, OUTH, device="cpu"), sub,
        noise=CASES["strided"]["noise"])
    for j in range(STRIDED_K):
        same(outs[j * STRIDED_B], ref[j], f"chunk {j}")
    with pytest.raises(ValueError, match="multiple"):
        video.video_strided(
            NTSC, pipeline.crt_init(NTSC, OUTW, OUTH, batch=3, device="cpu"),
            torch.as_tensor(case_frames("strided")))


def test_video_goldens_equal_both_packages(jax_runs):
    """The committed goldens, recipes included, equal JAX's runs and the
    port's."""
    ref = np.load(VIDEO_GOLDENS)
    want = golden_arrays(jax_runs)
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        same(ref[k], v, f"JAX {k}")
    port = golden_arrays({case: port_run(case) for case in CASES})
    for k, v in port.items():
        same(v, ref[k], f"port {k}")


def test_fade_and_analog_dump_match_jax():
    rng = np.random.RandomState(4)
    out = rng.randint(0, 256, (2, 30, 40, 3), np.uint8)
    same(video.fade_phosphors(torch.as_tensor(out)),
         jvideo.fade_phosphors(jnp.asarray(out)), "fade")
    analog = rng.randint(-128, 128, (3, 262, 910)).astype(np.int8)
    same(video.analog_dump(NTSC, torch.as_tensor(analog)),
         jvideo.analog_dump(JNTSC, jnp.asarray(analog)), "analog dump")


# --- checkpoints --------------------------------------------------------------


def run_rest(state, frames, start, stop, field, frame, noise=9):
    """Frames [start, stop) with the video converter's parities from the
    cursor (field, frame)."""
    outs = []
    for i in range(start, stop):
        state = pipeline.step(NTSC, state, torch.as_tensor(frames[i]),
                              field=field, frame=frame, noise=noise)
        outs.append(state.out.numpy())
        field ^= 1
        if (i & 1) == 0:
            frame ^= 1
    return state, outs


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Save after 2 of 4 frames, load, resume: every leaf, the meta and
    the resumed frames equal the uninterrupted run."""
    frames = frames_np(4, seed=5)
    st0 = pipeline.crt_init(NTSC, OUTW, OUTH, device="cpu")
    st_mid, _ = video.video_exact(NTSC, st0, torch.as_tensor(frames[:2]),
                                  noise=9)
    path = tmp_path / "ck.npz"
    checkpoint.save_checkpoint(str(path), st_mid, frame_index=2, field=0,
                               frame=1)
    saved = np.load(path)
    for k, v in convert.state_to_numpy(st_mid).items():
        same(saved[f"state/{k}"], v, f"saved {k}")
        assert saved[f"state/{k}"].dtype == v.dtype, k
    restored, meta = checkpoint.load_checkpoint(str(path), device="cpu")
    assert meta == {"frame_index": 2, "field": 0, "frame": 1}
    for k in pipeline.CRTState._fields:
        a, b = getattr(st_mid, k), getattr(restored, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    end_a, outs_a = run_rest(st_mid, frames, 2, 4, 0, 1)
    end_b, outs_b = run_rest(restored, frames, meta["frame_index"], 4,
                             meta["field"], meta["frame"])
    _, full = video.video_exact(NTSC, st0, torch.as_tensor(frames), noise=9)
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        same(b, a, f"resumed frame {i}")
        same(b, full[2 + i], f"uninterrupted frame {2 + i}")
    for k in pipeline.CRTState._fields:
        assert torch.equal(getattr(end_a, k), getattr(end_b, k)), k


def test_checkpoint_overwrite_and_atomic_write(tmp_path):
    st = pipeline.crt_init(NTSC, 32, 24, device="cpu")
    path = tmp_path / "ck.npz"
    checkpoint.save_checkpoint(str(path), st, frame_index=1)
    with pytest.raises(FileExistsError):
        checkpoint.save_checkpoint(str(path), st, overwrite=False)
    checkpoint.save_checkpoint(str(path), st, frame_index=7)
    assert checkpoint.load_checkpoint(str(path), device="cpu")[1][
        "frame_index"] == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]


# --- profiling ----------------------------------------------------------------


def test_time_fn_and_profile_stages():
    calls = []
    s = profiling.time_fn(lambda x: calls.append(x) or torch.ones(3), 1,
                          iters=3, warmup=1)
    assert s > 0 and calls == [1] * 4
    ms = profiling.profile_stages("NTSC", batch=2, outw=160, outh=120,
                                  iters=1, warmup=1, device="cpu")
    assert set(ms) == {"modulate", "demodulate", "step"}
    assert all(v > 0 for v in ms.values()), ms


def test_trace_and_kernel_breakdown(tmp_path):
    """trace() writes a Chrome trace of one CPU step (the step's torch ops
    in it); kernel_breakdown reads the newest back and finds no device
    events in it."""
    st = pipeline.crt_init(NTSC, OUTW, OUTH, device="cpu")
    img = torch.as_tensor(frames_np(1, 6)[0])
    with profiling.trace(str(tmp_path)):
        pipeline.step(NTSC, st, img, noise=3)
    (path,) = tmp_path.glob("trace.*.json")
    ops = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert any(e["name"].startswith("aten::") and e["dur"] >= 0
               for e in ops), ops[:5]
    assert profiling.kernel_breakdown(str(tmp_path)) == (0.0, [])
    with pytest.raises(FileNotFoundError):
        profiling.kernel_breakdown(str(tmp_path / "none"))
