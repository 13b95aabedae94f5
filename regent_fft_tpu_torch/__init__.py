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
matmul-form kernels.  A plan reads the JAX plan's environment switches
once as it is made (``plan.Switches``: ``REGENT_FFT_GAP_FUSED``,
``REGENT_FFT_AXIS0_IMPL``, ``REGENT_FFT_F2_IMPL``,
``REGENT_FFT_DMA_MIN_POST``, ``REGENT_FFT_R2C_1D``,
``REGENT_FFT_MXU_IMPL``); ``REGENT_FFT_LOG`` sets the plan log's level and
``REGENT_FFT_NATIVE=0`` turns the native planner off.  Around the plans: the reference's typed interface
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
FFTW-grammar CLI ``python -m regent_fft_tpu_torch.bench_cli``.  Over
``torch.distributed`` (``parallel``, loaded on first use; NCCL on the card,
gloo on the host): device meshes, the per-shard plans, the slab, pencil and
rank-1 global C2C plans on each rank's local block, the distributed
transpose and the strategy race with its wisdom.  The JAX
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
                           import_wisdom_from_filename, forget_wisdom,
                           gather_wisdom, broadcast_wisdom)
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


# The distributed names, loaded on first use from parallel/ (the JAX
# package's top-level exports of parallel.mesh, .distributed, .transpose).
_PARALLEL = {
    "mesh": ("make_fft_mesh", "make_pencil_mesh", "make_multislice_mesh",
             "init_distributed"),
    "distributed": ("DistributedFFTPlan", "make_plan_shards", "make_plan_slab",
                    "make_plan_pencil", "make_plan_slab_r2c",
                    "make_plan_slab_c2r", "make_plan_pencil_r2c",
                    "make_plan_pencil_c2r", "make_plan_slab_1d",
                    "unpack_halfcomplex_rank1", "pack_halfcomplex_rank1",
                    "make_plan_distributed", "destroy_plan_distrib"),
    "distributed_r2r": ("DistributedR2RPlan", "make_plan_slab_r2r"),
    "transpose": ("TransposePlan", "make_plan_transpose",
                  "make_plan_many_transpose"),
}


def __getattr__(name):
    # The ecosystem adapters and the distributed plans load on first use
    # (PEP 562): importing the package touches neither scipy's uarray
    # machinery nor torch.distributed, and needs no process group.
    import importlib
    if name in ("torch_fft", "scipy_backend", "parallel"):
        return importlib.import_module(f".{name}", __name__)
    for mod, names in _PARALLEL.items():
        if name in names:
            return getattr(importlib.import_module(f".parallel.{mod}",
                                                   __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
