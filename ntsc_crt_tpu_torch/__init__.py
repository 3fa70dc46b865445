"""ntsc_crt_tpu_torch — the NTSC composite video modem on PyTorch and CUDA.

The port of ``ntsc_crt_tpu`` (JAX on a TPU) to PyTorch, with hand-written
CUDA C++ kernels for NVIDIA Hopper (``sm_90a``).  It reproduces the JAX
package's integer results bit for bit; the JAX package stays the reference.

  ops/          int32 fixed point, closed-form LCG noise and crt_rand,
                filters (iir_lowpass, eq_threeband, the convolution EQ),
                gathers
  ops/kernels/  K1 encode_rows, K2 decode_rows (3-band, convolution-EQ and
                bloom modes) with bloom_line_width, K3 hsync_chase, K4
                ccf_ema, K5 vhs_region_b_entries, K6 place_rows_uniform
                (with a bloom mode), K11 inject_noise, K12 vhs_noise_bc,
                K13 nes_square, K7
                iir_lowpass_rows and K8 eq_threeband_rows (rowfilters), K9
                scanconv_rows with the unfused decode chain, K10 the int32
                issue-rate probe (``python -m
                ntsc_crt_tpu_torch.ops.kernels.probe``): each a CUDA kernel
                for CUDA tensors and a plain torch version for CPU tensors;
                build.py compiles csrc/*.cu with nvcc at first use
  models/       the system presets (its own copy), every encoder family
                (NTSC, VHS, SNES/TEMPLATE/PV1K, NESRGB, NES), the
                demodulator, the frame pipeline and the video pipelines
                (video.py: exact and strided, the phosphor fade, the
                analog dump)
  utils/        state conversion to and from the JAX package, checkpoints
                (one .npz), profiling (stage timers, CUDA events,
                torch.profiler traces), and its own copies of the image
                I/O, pixel formats, test card and native frame codec
  cli.py        the image and video converters (ntsc-torch,
                ntsc-video-torch)
  apps/         the live session (live.py) and its terminal and X11
                front ends (ntsc-live-torch, ntsc-x11-torch)
  parallel/     frame slots split over CUDA cards (mesh.py)

The pipeline runs every preset (``SYSTEMS``) with the decode build variants
(``eq_mode``, ``do_bloom``, ``do_vsync``, ``do_hsync``) and the NES builds
(``draw_border``, ``border_color``, ``optimized``).  Its entry points put
state on the CUDA card unless given ``device="cpu"`` (the CLIs and apps take
``device=`` as a Python keyword).  This package imports neither JAX nor
the JAX package.
"""

from ntsc_crt_tpu_torch.models.systems import (  # noqa: F401
    NES,
    NESRGB,
    NTSC,
    NTSC_RAINBOW,
    NTSCVHS,
    NTSCVHS_EP,
    NTSCVHS_LP,
    PV1K,
    SNES,
    SYSTEMS,
    TEMPLATE,
    SystemConfig,
)
from ntsc_crt_tpu_torch.models import pipeline  # noqa: F401
