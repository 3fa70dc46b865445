"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with nvcc for Hopper (``sm_90a``), one nvcc process
per source, all started together, and link into one shared library with a
plain C interface, ``.cuda_build/<hash>/libntsc_kernels.so`` beside the
package, at first use.  The hash covers the sources and the flags, so an
edited kernel rebuilds and an unchanged one loads from the cache.  The
library is bound with ctypes: every pointer and the stream are
``c_void_p`` (a plain int argument would cut a 64-bit pointer), every entry
point takes the stream last and returns ``cudaGetLastError()``, and
``launch`` raises if that is not 0.  ``LAUNCHES`` counts every launch.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / ".cuda_build"
LIB_NAME = "libntsc_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# entry point -> argument kinds: "p" pointer or stream, "i" C int
_SIGNATURES = {
    "ntsc_encode_rows": "ppppppp" + "i" * 11 + "p",
    "ntsc_encode_rows_field": "p" * 14 + "i" * 19 + "p",
    "ntsc_hsync_chase": "ppppp" + "i" * 8 + "p",
    "ntsc_decode_rows": "p" * 11 + "i" * 9 + "p",
    "ntsc_bloom_line_width": "ppppp" + "i" * 5 + "p",
    "ntsc_place_rows_uniform": "p" * 6 + "i" * 8 + "p",
    "ntsc_place_rows_general": "p" * 10 + "i" * 7 + "p",
    "ntsc_ccf_ema": "pppppp" + "i" * 5 + "p",
    "ntsc_vhs_region_b_entries": "pp" + "i" * 3 + "p",
    "ntsc_inject_noise": "p" * 7 + "i" * 6 + "p",
    "ntsc_vhs_noise_bc": "p" * 9 + "i" * 5 + "p",
    "ntsc_nes_square": "p" * 10 + "i" * 28 + "p",
    "ntsc_iir_lowpass_rows": "ppp" + "ii" + "p",
    "ntsc_eq_threeband_rows": "p" * 7 + "ii" + "p",
    "ntsc_scanconv_rows": "p" * 5 + "iii" + "p",
    "ntsc_probe": "pp" + "i" * 4 + "p",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}

_lib = None
# launches since the process started or a reader reset them, by entry point
# without its "ntsc_" and, where the entry point has modes, by mode
# ("decode_rows_conv", "decode_rows_bloom", "place_rows_uniform_bloom",
# "place_rows_general_bloom";
# K1's field mode is its own entry point, "encode_rows_field"):
# the kernels' names in chip_smoke.py and profiling.kernel_of
LAUNCHES: collections.Counter = collections.Counter()
# while models/graphs.py captures a step: called with each launch's name and
# pointer arguments, raises where a graph would hold a pointer that changes
# from call to call
capture_check = None
# filled by build(): seconds nvcc took (0.0 on a cache hit) and its output
last_build = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda)")


def build() -> Path:
    """Compile csrc/*.cu unless a library built from the same sources and
    flags exists; returns its path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SRC_DIR.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        last_build.update(seconds=0.0, log="cached", path=lib)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    # nvcc tells an object by its suffix, so the process id goes before it
    objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]   # waits for every process
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{' '.join(link)}\n{res.stdout}{res.stderr}")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)  # atomic: another process never loads half a file
    last_build.update(seconds=seconds, log="".join(logs), path=lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, kinds in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[k] for k in kinds]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args, mode: str = None) -> None:
    """Call entry point `name` with `args` and `device`'s current stream,
    with `device` made the current card for the call: CUDA launches a
    kernel only into a stream of the current device, and torch's own ops
    leave the current device as they found it.  Raise if the launch
    reported a CUDA error; else count it in LAUNCHES, under `mode` where
    the entry point's arguments choose one."""
    fn = getattr(library(), name)
    if capture_check is not None:
        capture_check(name, [a for a, kind in zip(args, _SIGNATURES[name])
                             if kind == "p"])
    with torch.cuda.device(device):
        rc = fn(*args, stream(device))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    LAUNCHES[name.removeprefix("ntsc_") + (f"_{mode}" if mode else "")] += 1


def stream(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    on `device`."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
