"""Checkpoint and resume of a CRT pipeline as one ``.npz`` file.

Counterpart of ``ntsc_crt_tpu/utils/checkpoint.py`` without Orbax.  The
reference's whole runtime state is two plain structs; here it is the
``CRTState`` leaves (``utils/convert.state_to_numpy``), saved with the video
cursor (the next frame index and the field/frame parity values) so a
resumed job continues the reference's interlace sequence
(extra/video_convert.c:261-267).  The file holds plain arrays and is read
without pickle.  A write goes to a temporary file in the same directory and
is renamed over the path, so a reader sees the old checkpoint or the new
one, never a part of either.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.utils import convert

_META = ("frame_index", "field", "frame")


def save_checkpoint(path: str, state: pipeline.CRTState, *,
                    frame_index: int = 0, field: int = 0,
                    frame: int = 0, overwrite: bool = True) -> None:
    """Write `state` and the video cursor to `path` (one .npz file).
    overwrite=False raises FileExistsError where `path` exists."""
    path = os.path.abspath(path)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(f"checkpoint exists: {path}")
    arrays = {f"state/{k}": v
              for k, v in convert.state_to_numpy(state).items()}
    for k, v in zip(_META, (frame_index, field, frame)):
        arrays[f"meta/{k}"] = np.int64(v)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=".ckpt-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, device=None):
    """Returns (CRTState on `device`, meta) where meta has the
    frame_index/field/frame ints; device=None means the CUDA card.  The
    round trip is bit-exact."""
    device = pipeline.resolve_device(device)
    with np.load(os.path.abspath(path), allow_pickle=False) as z:
        leaves = {k: z[f"state/{k}"] for k in pipeline.CRTState._fields}
        meta = {k: int(z[f"meta/{k}"]) for k in _META}
    return convert.state_from_numpy(leaves, device=device), meta
