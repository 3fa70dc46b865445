"""Visual demo: run every system over a synthetic SMPTE-style test card and
write decoded frames + the analog-signal dump (the reference's -a fixture).

Counterpart of ``examples/demo.py``, with the same files and bytes, on the
CUDA card:

    python -m ntsc_crt_tpu_torch.demo [outdir]

From Python, ``main([outdir], device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ntsc_crt_tpu_torch.models import pipeline, systems, video
from ntsc_crt_tpu_torch.utils import imageio
from ntsc_crt_tpu_torch.utils.testcard import test_card


def main(argv=None, device=None) -> int:
    """Four frames of every preset of systems.SYSTEMS at 640x480 (NES from
    seeded PPU pixels), each decoded frame and its analog dump written as
    PPMs into argv[0] (default demo_out).  device=None means the card."""
    argv = sys.argv[1:] if argv is None else argv
    device = pipeline.resolve_device(device)
    outdir = Path(argv[0] if argv else "demo_out")
    outdir.mkdir(exist_ok=True)
    img = test_card()
    imageio.ppm_write(outdir / "input.ppm", img)

    for name, cfg in systems.SYSTEMS.items():
        st = pipeline.crt_init(cfg, 640, 480, device=device)
        if cfg.kind == "nes":
            rng = np.random.RandomState(3)
            src = rng.randint(0, 64, (240, 256), np.uint16)
        else:
            src = img
        src = torch.as_tensor(src, device=device)
        field = frame = 0
        for i in range(4):
            st = pipeline.step(cfg, st, src, field=field, frame=frame,
                               noise=8,
                               dot_crawl_offset=i % max(cfg.cc_vper, 1))
            if not cfg.progressive:
                field ^= 1
                if (i & 1) == 0:
                    frame ^= 1
        imageio.ppm_write(outdir / f"{name.lower()}.ppm",
                          st.out.cpu().numpy())
        imageio.ppm_write(outdir / f"{name.lower()}_analog.ppm",
                          video.analog_dump(cfg, st.analog).cpu().numpy())
        print(f"{name}: wrote {name.lower()}.ppm + analog dump")
    return 0


if __name__ == "__main__":
    sys.exit(main())
