"""K13 nes_square, NES's square-wave encoder pass.

On the CPU the port's 512 x 12 four-phase table is held against the JAX
package's square_sample table and its closed form on every entry, and
`modulate_nes` (which reaches `nes_square_plain`, the path a CPU tensor
takes) against the JAX package's `modulate_nes` on every leaf: PPU sizes
256x240, 1x1 and 255x239, every 9-bit pixel, negative dot-crawl offsets,
black and white points where the int32 arithmetic and the int8 store wrap,
a picture that spills past HRES or is clipped at the field's end, the
border, the unoptimized build, batch 1 and 3.  The tests marked `gpu` hold
the kernel against its plain version on the card at B 1, 3, 17 and 33 (at
B 17 the slots' fields, 238,158 bytes apart, start at every even residue
of the 16-byte grid the kernel stores on) and on a field off that grid,
and skip without one.  Every value is an integer: every comparison is exact (0 LSB).

JAX is imported inside the tests that use it, so the `gpu` tests also run
on a machine without JAX:
    python -m pytest -p no:cacheprovider -o addopts="" --noconftest \\
        tests/test_torch_nes.py -m gpu
"""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ntsc_crt_tpu_torch.models import modulate, systems
from ntsc_crt_tpu_torch.ops.kernels import build, nes

torch.set_num_threads(1)  # the tier runs several workers on few cores

REPO = Path(__file__).resolve().parent.parent
I32_MIN, I32_MAX = -2**31, 2**31 - 1

# name -> (PPU (h, w), pixels, per-slot knobs, modulate_nes keywords)
CASES = {
    "ppu256x240": ((240, 256), "random", {}, {}),
    "ppu1x1": ((1, 1), "random", {}, {}),
    "ppu255x239": ((239, 255), "random", {}, {}),
    # all 512 values: every emphasis bit with hues 0x00, 0x0D, 0x0E, 0x0F
    "every_pixel": ((240, 256), "every", {}, {}),
    "dco_negative": ((240, 256), "random",
                     dict(dot_crawl_offset=(-1, -5, I32_MIN)), {}),
    "int8_wrap": ((240, 256), "random",
                  dict(black_point=(-40000, I32_MAX, I32_MIN),
                       white_point=(I32_MAX, -9000, 12345)), {}),
    "spill_past_hres": ((240, 256), "random", {}, dict(xoffset=100)),
    # the unoptimized build bursts rows 0..258, so the picture may run past
    # the field's last row and be clipped there
    "clip_rows": ((239, 255), "random", {},
                  dict(yoffset=20, optimized=False)),
    "border_1ff_unoptimized": ((240, 256), "every",
                               dict(border_color=(0x1FF, 0x21, -1)),
                               dict(draw_border=True, optimized=False)),
    "border_spill_clip": ((1, 1), "random", dict(border_color=(0x1FF,)),
                          dict(draw_border=True, xoffset=33, yoffset=7)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only "
                    "there")
    return torch.device("cuda")


def same(got, want, tag=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert np.array_equal(got, want), \
        f"{tag}: {int((got != want).sum())} differ"


def case_inputs(name: str, B: int, seed: int):
    """(analog int8 (B, V, H), ppu uint16 (B, h, w), keywords with the
    per-slot knobs as int32 (B,) arrays) of case `name`."""
    cfg = systems.NES
    (h, w), pixels, knobs, kw = CASES[name]
    rng = np.random.default_rng(seed)
    analog = rng.integers(-128, 128, (B, cfg.vres, cfg.hres)).astype(np.int8)
    if pixels == "every":
        ppu = np.resize(np.arange(512, dtype=np.uint16), (B, h, w))
    else:   # 16-bit words, of which the encoder reads bits 0-8
        ppu = rng.integers(0, 1 << 16, (B, h, w)).astype(np.uint16)
    kw = dict(kw, hue=np.resize(np.array([0, 45, 300], np.int32), B))
    for k, v in knobs.items():
        kw[k] = np.resize(np.array(v, np.int64), B).astype(np.int32)
    return analog, ppu, kw


def port_modulate(analog, ppu, kw, device):
    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    return modulate.modulate_nes(
        systems.NES, t(analog.copy()), t(ppu),
        **{k: t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})


# --- on the CPU: the table and the plain version against JAX ----------------


def test_square_table_matches_jax():
    """S[p, u] = sum_j square_sample(p, u + j): the JAX package's tabulated
    square_sample summed over four phases, and its closed form, on all
    512 x 12 entries."""
    import jax.numpy as jnp

    from ntsc_crt_tpu.models import modulate as jmod
    one = jmod._nes_square_table()
    u = np.arange(12)
    want = sum(one[:, (u + j) % 12] for j in range(4))
    got = nes.square_sum_table()
    same(got, want, "sum of square_sample")
    closed = jmod._nes_square_sum4(jnp.arange(512, dtype=jnp.int32)[:, None],
                                   jnp.arange(12, dtype=jnp.int32)[None, :])
    same(got, closed, "JAX _nes_square_sum4")
    same(nes.square_table(torch.device("cpu")), want, "square_table")


@functools.lru_cache(maxsize=None)
def jax_modulate_nes(static):
    """The JAX package's modulate_nes jitted with the keywords `static`
    (sorted (name, value) pairs) fixed; the per-slot knobs are traced."""
    import jax

    from ntsc_crt_tpu.models import modulate as jmod
    from ntsc_crt_tpu.models import systems as jsystems
    return jax.jit(functools.partial(jmod.modulate_nes, jsystems.NES,
                                     **dict(static)))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_modulate_nes_matches_jax(name, B):
    analog, ppu, kw = case_inputs(name, B, seed=B)
    got = port_modulate(analog, ppu, kw, "cpu")
    knobs = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    static = tuple(sorted((k, v) for k, v in kw.items() if k not in knobs))
    want = jax_modulate_nes(static)(analog, ppu, **knobs)
    for tag, g, w in zip(("analog", "ccf"), got, want):
        same(g, w, f"{name} {tag}")


def test_wrapper_on_cpu_tensors_never_imports_build():
    """A CPU tensor takes the plain version without loading the kernel
    library's build module (no nvcc, no card)."""
    code = (
        "import sys, torch; "
        "from ntsc_crt_tpu_torch.models import modulate, systems; "
        "modulate.modulate_nes(systems.NES, torch.zeros((2, 262, 909), "
        "dtype=torch.int8), torch.ones((2, 24, 32), dtype=torch.uint16), "
        "hue=0, draw_border=True); "
        "assert 'ntsc_crt_tpu_torch.ops.kernels.build' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# the NES geometry modulate_nes hands K13 (no offsets)
NES_GEOMETRY = dict(xo=196, yo=15, destw=682, desth=240, draw_border=False,
                    box=(15, 258, 154), vp=3, black_level=0,
                    skeleton=(23, 90, 259, 871, -37, 0),
                    burst_box=(15, 240, 101, 40), cc=4, vert_step=120,
                    burst_level=30)


def test_wrapper_refuses_geometry_it_cannot_store():
    """The picture's corner must lie inside the field, the burst and the
    sync inside it too, and the PPU frame must match the batch: both paths
    raise the same error."""
    analog = torch.zeros((1, 262, 909), dtype=torch.int8)
    ppu = torch.zeros((1, 240, 256), dtype=torch.uint16)
    knob = torch.zeros(1, dtype=torch.int32)
    args = (analog, ppu, nes.square_table(torch.device("cpu")), knob, knob,
            knob, knob, knob, nes.burst_sines(torch.device("cpu")))
    nes.nes_square(*args, **NES_GEOMETRY)
    for bad in (dict(yo=-1), dict(xo=909), dict(destw=910)):
        with pytest.raises(ValueError, match="geometry"):
            nes.nes_square(*args, **dict(NES_GEOMETRY, **bad))
    for bad in (dict(burst_box=(35, 240, 101, 40)),
                dict(skeleton=(23, 910, 259, 871, -37, 0))):
        with pytest.raises(ValueError, match="burst_box"):
            nes.nes_square(*args, **dict(NES_GEOMETRY, **bad))
    with pytest.raises(ValueError, match="ppu"):
        nes.nes_square(analog, ppu[:0], *args[2:], **NES_GEOMETRY)


# --- on the card: the kernel against its plain version ----------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 17, 33])
@pytest.mark.parametrize("name", list(CASES))
def test_nes_square_kernel_matches_plain(cuda, name, B):
    """modulate_nes on the card (K13) against the same call on the CPU
    (nes_square_plain), one launch a call.  At B 17 slot b's field starts
    14 * b mod 16 bytes past the 16-byte grid: every even residue, so a
    chunk the kernel stores whole straddles rows and slots at every
    offset."""
    analog, ppu, kw = case_inputs(name, B, seed=B + 100)
    want = port_modulate(analog, ppu, kw, "cpu")
    launches = build.LAUNCHES["nes_square"]
    got = port_modulate(analog, ppu, kw, cuda)
    assert build.LAUNCHES["nes_square"] == launches + 1
    for tag, g, w in zip(("analog", "ccf"), got, want):
        same(g, w.numpy(), f"{name} {tag}")


@pytest.mark.gpu
def test_nes_square_kernel_on_an_unaligned_field(cuda):
    """A field that starts off the 4- and 16-byte grids: the kernel's
    16-byte chunks straddle every row and the slots at odd offsets."""
    analog, ppu, kw = case_inputs("border_1ff_unoptimized", 3, seed=7)
    buf = torch.zeros(analog.size + 1, dtype=torch.int8, device=cuda)
    field = buf[1:].view(analog.shape)
    field.copy_(torch.as_tensor(analog))
    args = (torch.as_tensor(ppu, device=cuda),
            nes.square_table(cuda), *(torch.as_tensor(
                np.resize(np.array(v, np.int32), 3), device=cuda)
                for v in ((-1, 4, 2), (0, 5, -3), (100, 90, 250),
                          (0x1FF, 1, 0xF0), (0, -45, 2**31 - 1))),
            nes.burst_sines(cuda))
    geo = dict(NES_GEOMETRY, xo=228, yo=22, draw_border=True,
               burst_box=(0, 259, 101, 40))
    want = nes.nes_square_plain(field.cpu(), *(a.cpu() for a in args),
                                **geo)
    got = nes.nes_square(field, *args, **geo)
    for tag, g, w in zip(("analog", "ccf"), got, want):
        same(g, w.numpy(), f"unaligned field {tag}")
