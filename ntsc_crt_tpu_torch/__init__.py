"""ntsc_crt_tpu_torch — the NTSC composite video modem on PyTorch and CUDA.

The port of ``ntsc_crt_tpu`` (JAX on a TPU) to PyTorch, with hand-written
CUDA C++ kernels for NVIDIA Hopper (``sm_90a``).  It reproduces the JAX
package's integer results bit for bit; the JAX package stays the reference.

  ops/          int32 fixed point, closed-form LCG noise and crt_rand,
                filters, gathers
  ops/kernels/  K1 encode_rows, K2 decode_rows (3-band, convolution-EQ and
                bloom modes) with bloom_line_width, K3 hsync_chase, K4
                ccf_ema, K5 vhs_region_b_entries, K6 place_rows_uniform:
                each a CUDA kernel for CUDA tensors and a plain torch
                version for CPU tensors; build.py compiles csrc/*.cu with
                nvcc at first use
  models/       the system presets (its own copy), the NTSC and VHS
                modulators, the demodulator and the frame pipeline
  utils/        state conversion to and from the JAX package

The pipeline runs ``NTSC``, ``NTSC_RAINBOW``, ``NTSCVHS``, ``NTSCVHS_LP``
and ``NTSCVHS_EP`` with the decode build variants (``eq_mode``,
``do_bloom``, ``do_vsync``, ``do_hsync``), and raises NotImplementedError
for the other presets.  Its entry points put state on the CUDA card unless
given ``device="cpu"``.  This package imports neither JAX nor the JAX
package.
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
