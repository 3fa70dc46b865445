"""ctypes bridge to the native threaded frame codec (native/frameio.cpp).

The port's own copy of ``ntsc_crt_tpu/utils/native_io.py``.  The codec
builds with g++ at first use into its own library under ``.native_build/``,
written under a temporary name and renamed into place, so processes that
build at once never load a half-written file.  Where g++ is missing or the
build fails, reads and writes go through the pure-Python ``imageio``
(host file I/O either way); ``available()`` says which.  The video CLI uses
it to decode and encode frames on the host while the card steps others.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ntsc_crt_tpu_torch.utils import imageio

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "frameio.cpp"
_SO = _REPO / ".native_build" / "libframeio_torch.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    _SO.parent.mkdir(exist_ok=True)
    tmp = _SO.with_name(f".{_SO.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-pthread",
                        str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.CalledProcessError):
        return None                 # no g++, or no build: imageio instead
    ptrs = ctypes.POINTER(ctypes.c_char_p)
    u8 = ctypes.POINTER(ctypes.c_ubyte)
    for fn in (lib.frameio_read_batch, lib.frameio_write_batch):
        fn.argtypes = [ptrs, ctypes.c_int, u8, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native codec is in use, False for the imageio path."""
    return _load() is not None


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    keep = [str(p).encode() for p in paths]
    arr[:] = keep
    return arr, keep


def read_batch(paths: Sequence[str], h: int, w: int) -> np.ndarray:
    """Decode a batch of same-sized PPM/BMP frames -> (n, h, w, 3) uint8,
    threaded across frames in native code."""
    lib = _load()
    n = len(paths)
    if lib is None:
        return np.stack([imageio.read_image(p) for p in paths])
    out = np.zeros((n, h, w, 3), np.uint8)
    arr, keep = _paths_array(paths)
    ok = lib.frameio_read_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w)
    if ok != n:
        raise IOError(f"frameio: decoded {ok}/{n} frames")
    del keep
    return out


def write_batch(paths: Sequence[str], rgb: np.ndarray) -> None:
    """Encode (n, h, w, 3) uint8 frames as 32-bit BMPs in parallel."""
    lib = _load()
    n, h, w = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    if lib is None:
        for p, frame in zip(paths, rgb):
            imageio.bmp_write(p, frame)
        return
    rgbc = np.ascontiguousarray(rgb, np.uint8)
    arr, keep = _paths_array(paths)
    ok = lib.frameio_write_batch(
        arr, n, rgbc.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w)
    if ok != n:
        raise IOError(f"frameio: wrote {ok}/{n} frames")
    del keep
