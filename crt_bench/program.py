"""The system under test: the entry points of ``ntsc_crt_tpu_torch`` that
the drivers call, and the module attributes the traced run wraps in its
spans.  The control (``crt_bench/control.py``) and the tests put other
objects with the same methods in its place."""

from __future__ import annotations


class Port:
    """ntsc_crt_tpu_torch, imported when the harness makes one."""

    def __init__(self):
        from ntsc_crt_tpu_torch.apps import live
        from ntsc_crt_tpu_torch.models import demodulate, pipeline, systems
        from ntsc_crt_tpu_torch.models import video
        self.pipeline, self.video, self.live = pipeline, video, live
        self._systems = systems.SYSTEMS
        self._monitor = demodulate.MonitorParams

    def system(self, name: str):
        return self._systems[name]

    def monitor(self, **knobs):
        return self._monitor(**knobs)

    def init_batch(self, cfg, batch: int, outw: int, outh: int, device):
        return self.pipeline.init_batch(cfg, batch, outw, outh, device=device)

    def crt_init(self, cfg, outw: int, outh: int, device):
        return self.pipeline.crt_init(cfg, outw, outh, device=device)

    def step_batch(self, cfg, states, imgs, fields, frames, dcos, **kw):
        return self.pipeline.step_batch(cfg, states, imgs, fields, frames,
                                        dcos, **kw)

    def video_exact(self, cfg, state, frames, **kw):
        return self.video.video_exact(cfg, state, frames, **kw)

    def live_session(self, cfg, outw: int, outh: int, device, **knobs):
        return self.live.LiveSession(cfg, outw=outw, outh=outh,
                                     device=device, **knobs)

    def span_targets(self) -> dict:
        """Span name -> (module, attribute): the step every entry point
        goes through, and its two halves."""
        p = self.pipeline
        return {"step": (p, "step"), "modulate": (p, "modulate"),
                "demodulate": (p, "demodulate")}
