"""The port's CLIs and apps against the JAX package, on the CPU: the image and
video CLIs (output bytes), the live session across key presses, the
terminal and X11 front ends (the latter on a fake Xlib), and the port's
copies of the numpy-only I/O modules.  Every comparison is exact."""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from ntsc_crt_tpu import cli as jcli
from ntsc_crt_tpu.apps import term_live as jterm
from ntsc_crt_tpu.apps import x11_live as jx11
from ntsc_crt_tpu.apps.live import LiveSession as JLive
from ntsc_crt_tpu.models.systems import NTSC as JNTSC
from ntsc_crt_tpu.utils import formats as jformats
from ntsc_crt_tpu.utils import imageio as jimageio
from ntsc_crt_tpu.utils import native_io as jnative
from ntsc_crt_tpu.utils import testcard as jtestcard
from ntsc_crt_tpu_torch import cli
from ntsc_crt_tpu_torch.apps import term_live, x11_live
from ntsc_crt_tpu_torch.apps.live import LiveSession, PendingFrame
from ntsc_crt_tpu_torch.models import pipeline, video
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import NTSC
from ntsc_crt_tpu_torch.utils import formats, imageio, native_io, testcard

torch.set_num_threads(1)  # the tier runs several workers on few cores


def img_np(seed, w=64, h=48):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


# --- the copies of the numpy-only modules -------------------------------------


def test_imageio_copy_equals_jax_package(tmp_path):
    img = img_np(0, w=33, h=21)              # odd width: BMP row padding
    for ext in ("ppm", "bmp"):
        a, b = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        imageio.write_image(a, img)
        jimageio.write_image(b, img)
        assert a.read_bytes() == b.read_bytes(), ext
        np.testing.assert_array_equal(imageio.read_image(a),
                                      jimageio.read_image(a))
        np.testing.assert_array_equal(imageio.read_image(a), img)
    lo = tmp_path / "lo.ppm"                 # sub-8-bit maxval rescale
    lo.write_bytes(b"P6\n# c\n33 21\n63\n" + (img // 4).tobytes())
    np.testing.assert_array_equal(imageio.ppm_read(lo), jimageio.ppm_read(lo))
    with pytest.raises(ValueError):
        imageio.read_image(tmp_path / "x.png")


def test_formats_and_testcard_copies_equal_jax_package():
    img = img_np(1)
    for name in ("rgb", "bgr", "argb", "rgba", "abgr", "bgra"):
        fmt = formats.by_name(name)
        assert fmt == jformats.by_name(name)
        assert formats.bpp(fmt) == jformats.bpp(fmt)
        packed = formats.from_rgb(img, fmt)
        np.testing.assert_array_equal(packed, jformats.from_rgb(img, fmt))
        np.testing.assert_array_equal(formats.to_rgb(packed, fmt),
                                      jformats.to_rgb(packed, fmt))
    assert formats.bpp(99) == jformats.bpp(99) == 0
    for wh in ((320, 240), (97, 61)):
        np.testing.assert_array_equal(testcard.test_card(*wh),
                                      jtestcard.test_card(*wh))


def test_native_io_copy_equals_jax_package(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: native_io reads and writes through "
                    "imageio")
    assert native_io.available() and jnative.available()
    rng = np.random.RandomState(2)
    paths = []
    for i in range(4):
        p = tmp_path / (f"{i}.ppm" if i % 2 else f"{i}.bmp")
        imageio.write_image(p, rng.randint(0, 256, (24, 40, 3), np.uint8))
        paths.append(str(p))
    np.testing.assert_array_equal(native_io.read_batch(paths, 24, 40),
                                  jnative.read_batch(paths, 24, 40))
    rgb = rng.randint(0, 256, (3, 21, 33, 3), np.uint8)
    ours = [str(tmp_path / f"o{i}.bmp") for i in range(3)]
    theirs = [str(tmp_path / f"j{i}.bmp") for i in range(3)]
    native_io.write_batch(ours, rgb)
    jnative.write_batch(theirs, rgb)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


# --- the CLIs -----------------------------------------------------------------


def test_cli_main_writes_the_jax_packages_bytes(tmp_path):
    inp = tmp_path / "in.ppm"
    imageio.ppm_write(inp, img_np(4, w=96, h=72))
    args = ["-op", "160", "120", "24", "0", str(inp)]
    assert cli.main(args + [str(tmp_path / "t.ppm")], device="cpu") == 0
    assert jcli.main(args + [str(tmp_path / "j.ppm")]) == 0
    assert (tmp_path / "t.ppm").read_bytes() == \
        (tmp_path / "j.ppm").read_bytes()


def port_cli_loop(img, outw, outh, noise, hue):
    """The image CLI's accumulation (crt_main.c:241-255) written out;
    returns the final state."""
    st = pipeline.crt_init(NTSC, outw, outh, device="cpu")
    mon = MonitorParams(blend=1, scanlines=1)
    x = torch.as_tensor(img)
    field = frame = 0
    for it in range(4):
        st = pipeline.step(NTSC, st, x, field=field, frame=frame, hue=hue,
                           noise=noise, mon=mon)
        field ^= 1
        st = pipeline.step(NTSC, st, x, field=field, frame=frame, hue=hue,
                           noise=noise, mon=mon)
        if (it & 1) == 0:
            frame ^= 1
    return st


def test_cli_raw_format_and_analog_dump(tmp_path):
    img = img_np(5, w=96, h=72)
    inp = tmp_path / "in.ppm"
    imageio.ppm_write(inp, img)
    raw = tmp_path / "o.raw"
    assert cli.main(["--fmt", "bgra", "-o", "160", "120", "3", "17",
                     str(inp), str(raw)], device="cpu") == 0
    st = port_cli_loop(img, 160, 120, 3, 17)
    want = formats.from_rgb(st.out.numpy(), formats.BGRA)
    assert raw.read_bytes() == want.tobytes()
    ana = tmp_path / "a.ppm"
    assert cli.main(["-oa", "160", "120", "3", "17", str(inp), str(ana)],
                    device="cpu") == 0
    np.testing.assert_array_equal(
        imageio.ppm_read(ana), video.analog_dump(NTSC, st.analog).numpy())
    assert cli.main(["-s", "nes", "-o", "1", "1", "0", "0", "a", "b"],
                    device="cpu") == 1


def test_video_main_writes_the_jax_packages_files(tmp_path):
    src = tmp_path / "frames"
    src.mkdir()
    for i in range(4):
        imageio.bmp_write(src / f"{i:06d}.bmp", img_np(10 + i, w=80, h=60))
    args = ["-W", "160", "-H", "120", "-a", "4", str(src)]
    assert cli.video_main(args + [str(tmp_path / "t")], device="cpu") == 0
    assert jcli.video_main(args + [str(tmp_path / "j")]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == [f"{i:06d}.bmp" for i in range(4)]
    assert sorted(os.listdir(tmp_path / "t")) == names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


# --- the live session ---------------------------------------------------------


def live_img(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (60, 80, 3), np.uint8)


KEYS = ("f", "e", "m", "g", "b", "2", "4", "6")


def test_tick_matches_jax_across_keys():
    """Six ticks, each after its key presses (f; e; m; g b; 2 4; e 6),
    hold every frame and the loop state to JAX."""
    img = live_img()
    ours = LiveSession(NTSC, outw=160, outh=120, noise=9, device="cpu")
    theirs = JLive(JNTSC, outw=160, outh=120, noise=9)
    presses = [["f"], ["e"], ["m"], ["g", "b"], ["2", "4"], ["e", "6"]]
    assert sorted({k for p in presses for k in p}) == sorted(KEYS)
    for n, keys in enumerate(presses):
        for k in keys:
            ours.handle_key(k)
            theirs.handle_key(k)
        np.testing.assert_array_equal(ours.tick(img), theirs.tick(img),
                                      err_msg=f"tick {n} after {keys}")
        assert (ours.field, ours.frame, ours.dot_crawl_offset) == \
            (theirs.field, theirs.frame, theirs.dot_crawl_offset)
    ours.handle_key("r")
    assert (ours.contrast, ours.saturation) == (180, 10)


@pytest.mark.parametrize("preview_hw", [None, (10, 40)])
def test_tick_fast_equals_tick(preview_hw):
    img = live_img(1)
    a = LiveSession(NTSC, outw=160, outh=120, noise=5, device="cpu")
    b = LiveSession(NTSC, outw=160, outh=120, noise=5, device="cpu")
    for n in range(3):
        if n == 1:
            a.handle_key("4")
            b.handle_key("4")
        ref = a.tick(img)
        if preview_hw is not None:
            rows, cols = preview_hw
            ref = ref[::120 // (2 * rows)][:2 * rows, ::160 // cols][:, :cols]
        got = b.tick_fast(img, preview_hw=preview_hw)
        np.testing.assert_array_equal(got, ref, err_msg=f"tick {n}")
        pending = PendingFrame(b.state.out)
        np.testing.assert_array_equal(np.asarray(pending),
                                      b.state.out.numpy())
    later = b.tick_fast(img, preview_hw=preview_hw, fetch=False)
    np.testing.assert_array_equal(
        np.asarray(later), a.tick_fast(img, preview_hw=preview_hw))


def test_render_halfblocks_equals_jax():
    rgb = np.random.RandomState(3).randint(0, 4, (40, 60, 3), np.uint8) * 80
    for cols, rows in ((30, 10), (60, 20), (7, 3)):
        assert term_live.render_halfblocks(rgb, cols, rows) == \
            jterm.render_halfblocks(rgb, cols, rows)


def test_term_live_main_headless():
    assert term_live.main(["--frames", "2", "--no-display", "-W", "160",
                           "-H", "120", "--fps", "0"], device="cpu") == 0


# --- the X11 window on a fake Xlib --------------------------------------------


class _Fn:
    """An Xlib function: records its calls, returns a fixed value and
    carries the argtypes/restype the window declares."""

    def __init__(self, log, name, ret):
        self.log, self.name, self.ret = log, name, ret
        self.restype = self.argtypes = None

    def __call__(self, *a):
        self.log.append((self.name, a))
        return self.ret() if callable(self.ret) else self.ret


class FakeXlib:
    """Just enough Xlib for XWindow; the default visual is a real Visual
    struct with the given depth and masks; XNextEvent/XLookupKeysym replay
    a queued keysym list."""

    RETURNS = {"XOpenDisplay": 7, "XDefaultScreen": 0,
               "XDefaultRootWindow": 11, "XCreateSimpleWindow": 21,
               "XSelectInput": 0, "XStoreName": 0, "XMapWindow": 0,
               "XDefaultGC": 31, "XCreateImage": 51, "XFlush": 0,
               "XPutImage": 0, "XDestroyWindow": 0, "XCloseDisplay": 0}

    def __init__(self, depth=24, masks=x11_live.MASKS):
        self.calls, self.keysyms = [], []
        self.visual = x11_live.Visual(None, 33, 4, *masks, 8, 256)
        rets = dict(self.RETURNS, XDefaultDepth=depth,
                    XDefaultVisual=ctypes.addressof(self.visual),
                    XPending=lambda: len(self.keysyms),
                    XNextEvent=self._next,
                    XLookupKeysym=lambda: self._current)
        for name, ret in rets.items():
            setattr(self, name, _Fn(self.calls, name, ret))

    def _next(self):
        self._current = self.keysyms.pop(0)
        ev = self.calls[-1][1][1]                 # byref(_XEvent)
        ev._obj.type = x11_live.KeyPress
        return 0

    def names(self):
        return [c[0] for c in self.calls]


def test_pack_zpixmap_equals_jax():
    rgb = np.random.RandomState(6).randint(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(x11_live.pack_zpixmap(rgb),
                                  jx11.pack_zpixmap(rgb))


def test_xwindow_declares_every_xlib_call():
    """Every Xlib function the window calls has its argtypes and restype:
    pointers (Display*, GC, Visual*, XImage*) as c_void_p, XIDs as
    c_ulong, so nothing is cut to a 32-bit int."""
    fake = FakeXlib()
    win = x11_live.XWindow(8, 4, xlib=fake)
    win.blit(np.zeros((4, 8, 3), np.uint8))
    fake.keysyms = [0xFF52, ord("q"), 0x0020, 0xFF1B, 0xFFFF]
    assert win.poll_keys() == ["up", "q", " ", "esc"]
    win.close()
    used = set(fake.names())
    assert used <= set(x11_live.XLIB), used - set(x11_live.XLIB)
    for name in x11_live.XLIB:
        fn = getattr(fake, name)
        assert fn.restype is not None and fn.argtypes is not None, name
    for name in ("XOpenDisplay", "XDefaultGC", "XDefaultVisual",
                 "XCreateImage"):
        assert getattr(fake, name).restype is ctypes.c_void_p, name
    for name in ("XDefaultRootWindow", "XCreateSimpleWindow"):
        assert getattr(fake, name).restype is ctypes.c_ulong, name
    assert fake.XPutImage.argtypes[1] is ctypes.c_ulong
    assert fake.XPutImage.argtypes[3] is ctypes.c_void_p
    np.testing.assert_array_equal(win._buf, np.zeros((4, 8), np.uint32))
    assert fake.names()[-2:] == ["XDestroyWindow", "XCloseDisplay"]


@pytest.mark.parametrize("depth,masks", [
    (16, (0xF800, 0x07E0, 0x001F)), (24, (0x0000FF, 0x00FF00, 0xFF0000))])
def test_xwindow_rejects_other_visuals(depth, masks):
    fake = FakeXlib(depth, masks)
    with pytest.raises(RuntimeError, match="0x00RRGGBB"):
        x11_live.XWindow(8, 4, xlib=fake)
    assert "XCreateImage" not in fake.names()
    assert fake.names()[-1] == "XCloseDisplay"


def test_run_loop_blits_session_frames():
    """The display loop on a CPU session: frame N-1 is drawn while N is
    stepped, and a key reaches the session."""
    fake = FakeXlib()
    win = x11_live.XWindow(160, 120, xlib=fake)
    sess = LiveSession(NTSC, outw=160, outh=120, device="cpu")
    ref = LiveSession(NTSC, outw=160, outh=120, device="cpu")
    img = live_img(2)
    fake.keysyms = [ord("g")]
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    ema = x11_live.run_loop(sess, img, win, fps=0, frames=3, clock=clock,
                            sleep=lambda s: None)
    assert ema > 0 and sess.scanlines == 1
    assert fake.names().count("XPutImage") == 2
    ref.tick(img)
    np.testing.assert_array_equal(win._buf, x11_live.pack_zpixmap(
        ref.tick(img)))
