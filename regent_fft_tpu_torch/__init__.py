"""regent_fft_tpu_torch — the PyTorch/CUDA port of ``regent_fft_tpu``.

C2C, R2C and C2R plans at any rank and every length (Rader and Bluestein
where no kernel, direct DFT or two-factor split takes one), forward and
inverse, with all four norms and the three precision tiers, in complex64
(f32 planes), complex32 (bf16 planes, f32 compute) and complex128 (f64
contraction steps), run on an NVIDIA H100 through twenty-two hand-written
CUDA entry points (``csrc/stockham.cu``, ``csrc/real.cu``,
``csrc/fourstep.cu``, ``csrc/ring.cu`` and ``csrc/matmul.cu``, built with
``nvcc`` at first use).  The routes: the butterfly passes (last axis,
middle axes, the fused trailing pair, the axis-0 pass, the gap-fused pass
behind ``REGENT_FFT_GAP_FUSED``), the real row-pair kernels, the four-step
last axis (n = 4096..2M), the leading-axis four-step and slab-ring routes
(``axis0_impl``/``f2_impl``), and under ``backend="pallas"`` the
matmul-form kernels.  Around the plans: the reference's typed interface
(``generate_fft_interface``), guru and ``plan_many`` plans over flat
buffers, the shift and frequency helpers.  On the plans and kernels: the
eleven FFTW real-to-real kinds (DCT/DST types 1-4, DHT, halfcomplex;
``plan_r2r``, scipy's ``dct``/``dst`` families, guru r2r plans), the
chirp-z transform and zoom FFT, the fast Hankel transform (FFTLog) and
the non-uniform FFT, types 1-3 in one to three dimensions; ``scipy.signal``'s
FFT convolution, correlation, overlap-add, Hilbert, resampling, STFT and
the Welch family (``signal.py``, ``spectral.py``); the ``torch.fft``
namespace (``torch_fft``) and a ``scipy.fft`` backend (``scipy_backend``),
both loaded on first use.  Plans default to
``device="cuda"``; ``device="cpu"`` runs the kernels' plain versions.  The
planner tiers ``"estimate"``, ``"model"`` (the native cost model),
``"measure"``, ``"patient"`` and ``"exhaustive"`` (candidates raced on the
plan's device with CUDA events), their wisdom (``export_wisdom_*``,
``import_wisdom_*``, autoloaded from ``REGENT_FFT_WISDOM`` or
``~/.regent_fft_tpu_torch.wisdom.json`` unless ``REGENT_FFT_NO_WISDOM`` is
set), ``calibrate``, ``Plan.cost``/``Plan.benchmark``, ``cleanup`` and the
FFTW-grammar CLI ``python -m regent_fft_tpu_torch.bench_cli``.  The JAX
package ``regent_fft_tpu`` is the reference; this package imports nothing
of it or of JAX.
"""
from .dtypes import Direction, Kind, Norm, SplitComplex, as_split, from_split
from .plan import (Plan, PlanSpec, make_plan, execute_plan, destroy_plan,
                   clear_plan_cache, cached_plans, cleanup, spec_from_jax)
from .api import (fft, ifft, fft2, ifft2, fftn, ifftn,
                  rfft, irfft, rfft2, irfft2, rfftn, irfftn, hfft, ihfft,
                  hfftn, hfft2, ihfftn, ihfft2, fftshift, ifftshift, fftfreq,
                  rfftfreq, FFTInterface, generate_fft_interface,
                  set_workers, get_workers)
from .guru import (IODim, GuruPlan, GuruR2RPlan, plan_guru, plan_guru_r2r,
                   plan_many)
from .ops.factor import next_fast_len, prev_fast_len
from .utils.measure import set_timelimit, get_timelimit, NO_TIMELIMIT
from .utils import wisdom
from .utils.wisdom import (export_wisdom_to_string, export_wisdom_to_filename,
                           import_wisdom_from_string,
                           import_wisdom_from_filename, forget_wisdom)
from .utils.calibrate import (calibrate, Calibration, install_calibration,
                              reset_calibration)
from .ops.r2r import (R2RKind, R2RPlan, plan_r2r, r2r, dct, dst, dht,
                      idct, idst, idht, dctn, idctn, dstn, idstn)
from ._czt import CZT, ZoomFFT, czt, zoom_fft
from .ops.fftlog import fht, ifht, fhtoffset
from .ops.nufft import (nufft1d1, nufft1d2, nufft2d1, nufft2d2,
                        nufft3d1, nufft3d2, nufft1d3, nufft2d3, nufft3d3)
from .signal import (fftconvolve, oaconvolve, correlate, stft, istft,
                     hilbert, hilbert2, resample)
from .spectral import periodogram, welch, csd, coherence, spectrogram

__version__ = "0.1.0"

# System wisdom (FFTW's import-system-wisdom): winners and calibration of
# earlier processes, from $REGENT_FFT_WISDOM or the default file.
wisdom.autoload_system_wisdom()

FORWARD = Direction.FORWARD
BACKWARD = Direction.BACKWARD


def __getattr__(name):
    # The ecosystem adapters load on first use (PEP 562), so importing the
    # package does not touch scipy's uarray machinery.
    if name in ("torch_fft", "scipy_backend"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
