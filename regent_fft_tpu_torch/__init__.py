"""regent_fft_tpu_torch — the PyTorch/CUDA port of ``regent_fft_tpu``.

Complex64 C2C plans and float32 R2C/C2R plans at any rank, forward and
inverse, with all four norms, run on an NVIDIA H100 through ten
hand-written CUDA kernels (``csrc/stockham.cu``, ``csrc/real.cu``,
``csrc/fourstep.cu`` and ``csrc/ring.cu``, built with ``nvcc`` at first
use): the butterfly passes, the four-step last axis (n = 4096..2M), and
the leading-axis four-step and slab-ring routes.  Plans default
to ``device="cuda"``; ``device="cpu"`` runs the kernels' plain versions.
The JAX package ``regent_fft_tpu`` is the reference; this package imports
nothing of it or of JAX.
"""

from .dtypes import Direction, Kind, Norm, SplitComplex, as_split, from_split
from .plan import (Plan, PlanSpec, make_plan, execute_plan, destroy_plan,
                   clear_plan_cache, cached_plans, spec_from_jax)
from .api import (fft, ifft, fft2, ifft2, fftn, ifftn,
                  rfft, irfft, rfft2, irfft2, rfftn, irfftn, hfft, ihfft,
                  hfftn, hfft2, ihfftn, ihfft2)
from .ops.factor import next_fast_len

__version__ = "0.1.0"

FORWARD = Direction.FORWARD
BACKWARD = Direction.BACKWARD
