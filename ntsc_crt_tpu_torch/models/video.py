"""Video sequences: frames stepped in order with explicit CRT state.

Counterpart of ``ntsc_crt_tpu/models/video.py``, the reference's video batch
converter (extra/video_convert.c:246-277), which converts frames strictly in
order with cross-frame state (field/frame parity, sync estimates, ccf EMA,
PRNG streams, blend buffer).  Two modes:

* ``video_exact`` — one ``pipeline.step`` a frame, the reference's
  frame-to-frame semantics bit for bit; every frame pays the batch-1 cost.
* ``video_strided`` — the sequence split into B interleaved strides, one CRT
  state a stride, the strides stepped together as a batch.  Each stride is
  an exact emulation of its sub-video; state does not flow between strides.

Also the live loop's phosphor fade (crt_main.c:437-452) and the analog
signal dump (crt_main.c:257-268).  The loops hold no host read of a frame:
on the card they queue every step without a synchronize.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ntsc_crt_tpu_torch.models import pipeline
from ntsc_crt_tpu_torch.models.demodulate import MonitorParams
from ntsc_crt_tpu_torch.models.systems import SystemConfig


def _parities(n_frames: int, progressive: bool):
    """field/frame parity sequences of the video converter
    (extra/video_convert.c:261-267): field ^= 1 each frame; frame ^= 1
    after every even-indexed frame."""
    field = np.zeros(n_frames, np.int32)
    frame = np.zeros(n_frames, np.int32)
    f = fr = 0
    for i in range(n_frames):
        field[i], frame[i] = f, fr
        if not progressive:
            f ^= 1
            if (i & 1) == 0:
                fr ^= 1
    return field, frame


def _stack(outs, i: int, n: int, frame: torch.Tensor) -> torch.Tensor:
    """Copy `frame` into slot i of the (n, ...) result, allocated on the
    first frame: the step's own output tensor is never kept."""
    if outs is None:
        outs = torch.empty((n,) + tuple(frame.shape), dtype=frame.dtype,
                           device=frame.device)
    outs[i].copy_(frame)
    return outs


def video_exact(cfg: SystemConfig, state: pipeline.CRTState,
                frames: torch.Tensor, *, noise=0,
                mon: Optional[MonitorParams] = None,
                progressive: bool = False, hue=0, out_transform=None,
                **step_kw):
    """Step T frames in order; state flows exactly as in the C converter.
    frames: uint8 (T, h, w, 3) (or uint16 (T, h, w) for NES) on the state's
    device; state: a single-frame state.  Extra keyword args (do_bloom,
    eq_mode, do_vsync/do_hsync, draw_border/border_color, do_aberration,
    v_fac, ...) forward to pipeline.step.  Returns (state', outs uint8
    (T, outh, outw, 3)).

    ``out_transform`` (optional) maps each frame's output before it is
    stored, so a streaming consumer (a checksum, a downsample) never holds
    all T full frames; outs then stacks the transformed frames."""
    mon = mon or MonitorParams()
    T = frames.shape[0]
    fseq, frseq = _parities(T, progressive or cfg.progressive)
    vper = max(cfg.cc_vper, 1)
    transform = out_transform or (lambda out: out)
    outs = None
    for i in range(T):
        state = pipeline.step(cfg, state, frames[i], field=int(fseq[i]),
                              frame=int(frseq[i]), hue=hue, noise=noise,
                              mon=mon, dot_crawl_offset=i % vper, **step_kw)
        outs = _stack(outs, i, T, transform(state.out))
    if outs is None:
        outs = transform(state.out)[:0]
    return state, outs


def video_strided(cfg: SystemConfig, states: pipeline.CRTState,
                  frames: torch.Tensor, *, noise=0,
                  mon: Optional[MonitorParams] = None,
                  progressive: bool = False, hue=0, out_transform=None,
                  **step_kw):
    """Throughput mode: frames (T, ...) with T = B * k are B interleaved
    strides (slot b takes frames b, b+B, b+2B, ...), each carrying its own
    state.  states: a batched CRTState of B slots on the frames' device.
    Extra keyword args forward to pipeline.step (see video_exact).  Returns
    (states', outs (T, outh, outw, 3)) in the original frame order; with
    ``out_transform`` (applied to each (B, ...) chunk), outs is (k, ...)."""
    mon = mon or MonitorParams()
    B = states.analog.shape[0]
    T = frames.shape[0]
    if T % B:
        raise ValueError(f"frame count {T} is not a multiple of the slot "
                         f"count {B}")
    k = T // B
    fseq, frseq = _parities(k, progressive or cfg.progressive)
    dcos = np.arange(k, dtype=np.int32) % max(cfg.cc_vper, 1)
    # (3, k, B) field / frame / dot crawl, uploaded once
    seq = torch.as_tensor(np.repeat(np.stack([fseq, frseq, dcos])[..., None],
                                    B, axis=2), device=states.out.device)
    # (T, ...) -> (k, B, ...): stride b sees frames [b, b+B, ...]
    chunked = frames.reshape(k, B, *frames.shape[1:])
    transform = out_transform or (lambda out: out)
    outs = None
    for i in range(k):
        states = pipeline.step(cfg, states, chunked[i], field=seq[0, i],
                               frame=seq[1, i], hue=hue, noise=noise,
                               mon=mon, dot_crawl_offset=seq[2, i], **step_kw)
        outs = _stack(outs, i, k, transform(states.out))
    if outs is None:
        outs = transform(states.out)[:0]
    if out_transform is not None:
        return states, outs
    return states, outs.reshape(T, *outs.shape[2:])


def fade_phosphors(out: torch.Tensor) -> torch.Tensor:
    """Persistence emulation over the output buffer (crt_main.c:437-452):
    per channel c -> (c>>1)+(c>>2)+(c>>3)+(c>>4)."""
    c = out.to(torch.int32)
    return ((c >> 1) + (c >> 2) + (c >> 3) + (c >> 4)).to(torch.uint8)


def analog_dump(cfg: SystemConfig, analog: torch.Tensor) -> torch.Tensor:
    """The modulated composite signal as a grayscale image (the CLI's -a
    flag, crt_main.c:257-268)."""
    norm = (analog.to(torch.int32) + 128).to(torch.uint8)
    return torch.stack([norm] * 3, dim=-1)
