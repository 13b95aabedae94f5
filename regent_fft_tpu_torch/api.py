"""numpy.fft-style one-shot functions over the plan cache: C2C, real
(``rfft*``/``irfft*``) and Hermitian (``hfft*``/``ihfft*``); the shift and
frequency helpers; the reference's typed interface (:class:`FFTInterface`,
``generate_fft_interface``); the advisory worker count.

Counterpart: ``regent_fft_tpu/api.py``.  Each call plans through the
cache, so repeated calls for one problem reuse the plan.  Extra keyword
options (``device``, ``backend``, ...) go to :class:`PlanSpec`.

The plan dtype follows the input (:func:`_dtype_of`, api.py:32-45): a
:class:`SplitComplex` is complex32 (bf16 planes out), float64 or
complex128 data is complex128, anything else complex64.  The JAX package
takes complex128 only under ``JAX_ENABLE_X64=1``; the port has no such
switch and keeps float64 data in float64, as ``torch.fft`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import Direction, Kind, Norm, SplitComplex, canonical_dtype
from .plan import (Plan, PlanSpec, destroy_plan, execute_plan,
                   make_plan)

_NORMS = {None: Norm.BACKWARD, "backward": Norm.BACKWARD, "ortho": Norm.ORTHO,
          "forward": Norm.FORWARD, "none": Norm.NONE}


def _dtype_of(x) -> str:
    """The plan dtype of an input.  Counterpart: ``regent_fft_tpu/api.py:32``
    (with x64 on)."""
    if isinstance(x, SplitComplex):
        return "complex32"
    d = x.dtype if isinstance(x, (np.ndarray, torch.Tensor)) else \
        torch.as_tensor(x).dtype
    if d in (np.complex128, np.float64, torch.complex128, torch.float64):
        return "complex128"
    return "complex64"


def _shape_of(x) -> Tuple[int, ...]:
    if isinstance(x, SplitComplex):
        return tuple(x.re.shape)
    return tuple(np.shape(x)) if isinstance(x, np.ndarray) else tuple(torch.as_tensor(x).shape)


def _axes_tuple(ndim, axis=None, axes=None) -> Tuple[int, ...]:
    if axis is not None:
        return (axis % ndim,)
    if axes is None:
        return tuple(range(ndim))
    return tuple(a % ndim for a in axes)


def _crop_pad(a, axes, sizes):
    for ax, n in zip(axes, sizes):
        if n is None or a.shape[ax] == n:
            continue
        if a.shape[ax] > n:
            a = a.narrow(ax, 0, n) if isinstance(a, torch.Tensor) else np.take(
                a, np.arange(n), axis=ax)
        elif isinstance(a, torch.Tensor):
            shape = list(a.shape)
            shape[ax] = n - a.shape[ax]
            a = torch.cat([a, a.new_zeros(shape)], ax)
        else:
            pad = [(0, 0)] * a.ndim
            pad[ax] = (0, n - a.shape[ax])
            a = np.pad(a, pad)
    return a


def _padded(x, axes, sizes):
    """numpy.fft n/s semantics: crop or zero-pad each axis to its target.

    Counterpart: ``regent_fft_tpu/api.py:64``.
    """
    if sizes is None:
        return x
    for n in sizes:
        if n is not None and n < 1:
            raise ValueError(f"invalid number of FFT data points: {n}")
    if isinstance(x, SplitComplex):
        return SplitComplex(_crop_pad(x.re, axes, sizes),
                            _crop_pad(x.im, axes, sizes))
    if not isinstance(x, np.ndarray):
        x = torch.as_tensor(x)
    return _crop_pad(x, axes, sizes)


def _c2c(x, axes_t, direction, norm, **opts):
    """Counterpart: ``regent_fft_tpu/api.py:102``."""
    opts.setdefault("dtype", _dtype_of(x))
    spec = PlanSpec(shape=_shape_of(x), axes=axes_t, kind=Kind.C2C,
                    direction=direction, norm=_NORMS[norm], **opts)
    return make_plan(spec)(x)


def _ndim(x) -> int:
    return len(_shape_of(x))


def fft(x, n: Optional[int] = None, axis: int = -1, norm=None, **opts):
    """1-D forward DFT.  Counterpart: ``regent_fft_tpu/api.py:112``."""
    axes_t = _axes_tuple(_ndim(x), axis=axis)
    x = _padded(x, axes_t, (n,) if n is not None else None)
    return _c2c(x, axes_t, Direction.FORWARD, norm, **opts)


def ifft(x, n: Optional[int] = None, axis: int = -1, norm=None, **opts):
    """1-D inverse DFT.  Counterpart: ``regent_fft_tpu/api.py:118``."""
    axes_t = _axes_tuple(_ndim(x), axis=axis)
    x = _padded(x, axes_t, (n,) if n is not None else None)
    return _c2c(x, axes_t, Direction.BACKWARD, norm, **opts)


def fft2(x, s=None, axes=(-2, -1), norm=None, **opts):
    """Counterpart: ``regent_fft_tpu/api.py:124``."""
    return fftn(x, s=s, axes=axes, norm=norm, **opts)


def ifft2(x, s=None, axes=(-2, -1), norm=None, **opts):
    """Counterpart: ``regent_fft_tpu/api.py:128``."""
    return ifftn(x, s=s, axes=axes, norm=norm, **opts)


def fftn(x, s=None, axes=None, norm=None, **opts):
    """N-D forward DFT.  Counterpart: ``regent_fft_tpu/api.py:132``."""
    nd = _ndim(x)
    if s is not None and axes is None:
        axes = tuple(range(nd - len(s), nd))
    axes_t = _axes_tuple(nd, axes=axes)
    x = _padded(x, axes_t, s)
    return _c2c(x, axes_t, Direction.FORWARD, norm, **opts)


def ifftn(x, s=None, axes=None, norm=None, **opts):
    """N-D inverse DFT.  Counterpart: ``regent_fft_tpu/api.py:141``."""
    nd = _ndim(x)
    if s is not None and axes is None:
        axes = tuple(range(nd - len(s), nd))
    axes_t = _axes_tuple(nd, axes=axes)
    x = _padded(x, axes_t, s)
    return _c2c(x, axes_t, Direction.BACKWARD, norm, **opts)


def _real_input(x):
    """The data of an R2C call as a numpy array or tensor (a SplitComplex
    gives its real plane)."""
    if isinstance(x, SplitComplex):
        x = x.re
    if not isinstance(x, (np.ndarray, torch.Tensor)):
        x = torch.as_tensor(x)
    return x


def rfft(x, n: Optional[int] = None, axis: int = -1, norm=None, **opts):
    """1-D DFT of real input -> half spectrum.

    Counterpart: ``regent_fft_tpu/api.py:150``.
    """
    return rfftn(x, s=(n,) if n is not None else None, axes=(axis,),
                 norm=norm, **opts)


def rfftn(x, s=None, axes=None, norm=None, **opts):
    """N-D DFT of real input; the last of ``axes`` is halved.  float64
    data plans complex128, other data complex64.

    Counterpart: ``regent_fft_tpu/api.py:154``.
    """
    x = _real_input(x)
    nd = x.ndim
    if s is not None and axes is None:
        axes = tuple(range(nd - len(s), nd))
    axes_t = _axes_tuple(nd, axes=axes)
    x = _padded(x, axes_t, s)
    opts.setdefault("dtype", _dtype_of(x))
    spec = PlanSpec(shape=tuple(x.shape), axes=axes_t, kind=Kind.R2C,
                    direction=Direction.FORWARD, norm=_NORMS[norm], **opts)
    return make_plan(spec)(x)


def irfft(x, n: Optional[int] = None, axis: int = -1, norm=None, **opts):
    """Inverse of :func:`rfft`: half spectrum -> real output of length
    ``n`` (default 2*(m-1)).  Counterpart: ``regent_fft_tpu/api.py:168``.
    """
    return irfftn(x, s=(n,) if n is not None else None, axes=(axis,),
                  norm=norm, **opts)


def irfftn(x, s=None, axes=None, norm=None, **opts):
    """Inverse of :func:`rfftn`: real output (float32; float64 from
    complex128 input, bfloat16 from a SplitComplex), the last of ``axes``
    of length s[-1] (default 2*(m-1)); the other axes are cropped or
    padded to ``s``.  Counterpart: ``regent_fft_tpu/api.py:172``.
    """
    shape = _shape_of(x)
    nd = len(shape)
    if s is not None and axes is None:
        axes = tuple(range(nd - len(s), nd))
    axes_t = _axes_tuple(nd, axes=axes)
    out_shape = list(shape)
    if s is not None:
        for ax, n in zip(axes_t, s):
            if n is not None:
                out_shape[ax] = n
    if s is None or s[-1] is None:
        out_shape[axes_t[-1]] = 2 * (shape[axes_t[-1]] - 1)
    in_sizes = ([out_shape[a] for a in axes_t[:-1]]
                + [out_shape[axes_t[-1]] // 2 + 1])
    x = _padded(x, axes_t, in_sizes)
    opts.setdefault("dtype", _dtype_of(x))
    spec = PlanSpec(shape=tuple(out_shape), axes=axes_t, kind=Kind.C2R,
                    direction=Direction.BACKWARD, norm=_NORMS[norm], **opts)
    return make_plan(spec)(x)


def rfft2(x, s=None, axes=(-2, -1), norm=None, **opts):
    """Counterpart: ``regent_fft_tpu/api.py:201``."""
    return rfftn(x, s=s, axes=axes, norm=norm, **opts)


def irfft2(x, s=None, axes=(-2, -1), norm=None, **opts):
    """Counterpart: ``regent_fft_tpu/api.py:197``."""
    return irfftn(x, s=s, axes=axes, norm=norm, **opts)


# Hermitian-input transforms: hfft(a) == irfft(conj(a)) at the swapped norm
# (numpy.fft / scipy.fft semantics).  Counterpart: regent_fft_tpu/api.py:205.
_SWAP_NORM = {None: "forward", "backward": "forward",
              "forward": "backward", "ortho": "ortho", "none": "none"}


def _conj(x):
    if isinstance(x, SplitComplex):
        return SplitComplex(x.re, -x.im)
    if isinstance(x, np.ndarray):
        return np.conj(x)
    return torch.conj_physical(torch.as_tensor(x))


def hfft(x, n: Optional[int] = None, axis: int = -1, norm=None, **opts):
    """FFT of a Hermitian half spectrum -> real output of length ``n``
    (default 2*(m-1)).  Counterpart: ``regent_fft_tpu/api.py:218``."""
    return irfft(_conj(x), n=n, axis=axis, norm=_SWAP_NORM[norm], **opts)


def ihfft(x, n: Optional[int] = None, axis: int = -1, norm=None, **opts):
    """Inverse of :func:`hfft`: real input -> conjugated half spectrum.
    Counterpart: ``regent_fft_tpu/api.py:224``."""
    return _conj(rfft(x, n=n, axis=axis, norm=_SWAP_NORM[norm], **opts))


def hfftn(x, s=None, axes=None, norm=None, **opts):
    """N-D FFT of Hermitian input -> real output (scipy.fft.hfftn).
    Counterpart: ``regent_fft_tpu/api.py:229``."""
    return irfftn(_conj(x), s=s, axes=axes, norm=_SWAP_NORM[norm], **opts)


def hfft2(x, s=None, axes=(-2, -1), norm=None, **opts):
    """Counterpart: ``regent_fft_tpu/api.py:235``."""
    return hfftn(x, s=s, axes=axes, norm=norm, **opts)


def ihfftn(x, s=None, axes=None, norm=None, **opts):
    """N-D inverse of :func:`hfftn` (scipy.fft.ihfftn).
    Counterpart: ``regent_fft_tpu/api.py:240``."""
    return _conj(rfftn(x, s=s, axes=axes, norm=_SWAP_NORM[norm], **opts))


def ihfft2(x, s=None, axes=(-2, -1), norm=None, **opts):
    """Counterpart: ``regent_fft_tpu/api.py:246``."""
    return ihfftn(x, s=s, axes=axes, norm=norm, **opts)


# ---------------------------------------------------------------------------
# Shift and frequency helpers (numpy.fft parity); a SplitComplex shifts
# plane by plane.  Counterpart: regent_fft_tpu/api.py:253-276.
# ---------------------------------------------------------------------------
def _roll_half(x, axes, inverse: bool):
    x = torch.as_tensor(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    shifts = [(-(x.shape[a] // 2) if inverse else x.shape[a] // 2)
              for a in axes]
    return torch.roll(x, shifts, tuple(axes))


def fftshift(x, axes=None):
    """Move the zero-frequency bin to the centre.
    Counterpart: ``regent_fft_tpu/api.py:253``."""
    if isinstance(x, SplitComplex):
        return SplitComplex(_roll_half(x.re, axes, False),
                            _roll_half(x.im, axes, False))
    return _roll_half(x, axes, False)


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift`.
    Counterpart: ``regent_fft_tpu/api.py:260``."""
    if isinstance(x, SplitComplex):
        return SplitComplex(_roll_half(x.re, axes, True),
                            _roll_half(x.im, axes, True))
    return _roll_half(x, axes, True)


def fftfreq(n, d=1.0, dtype=torch.float32, device="cuda"):
    """numpy.fft.fftfreq as a tensor on ``device`` (the card by default,
    like plans).  Counterpart: ``regent_fft_tpu/api.py:267``."""
    return torch.from_numpy(np.fft.fftfreq(n, d)).to(device=device,
                                                     dtype=dtype)


def rfftfreq(n, d=1.0, dtype=torch.float32, device="cuda"):
    """numpy.fft.rfftfreq as a tensor on ``device``.
    Counterpart: ``regent_fft_tpu/api.py:271``."""
    return torch.from_numpy(np.fft.rfftfreq(n, d)).to(device=device,
                                                      dtype=dtype)


# ---------------------------------------------------------------------------
# Reference-parity interface (src/fft.rg:31 generate_fft_interface)
# ---------------------------------------------------------------------------
class FFTInterface:
    """Typed interface for a fixed (dim, dtype_in, dtype_out): ``make_plan``
    checks the rank against ``dim`` and plans the interface's kind and
    dtype, as the reference's per-type ``iface`` table does
    (the reference's ``src/fft.rg:31-664``).  Real input (float32/float64)
    means R2C, anything else C2C; the plan dtype is complex32 when either
    side is (a SplitComplex), complex128 when the output is, else
    complex64.  Keyword options go to every plan (``device``, ...).

    Counterpart: ``regent_fft_tpu/api.py:278``.
    """

    def __init__(self, dim: int, dtype_in, dtype_out, **default_opts):
        if not 1 <= dim <= 3:
            raise ValueError("generate_fft_interface supports 1 <= dim <= 3 "
                             "(use the numpy-style API for higher rank)")
        self.dim = dim
        self.dtype_in = canonical_dtype(dtype_in)
        self.dtype_out = canonical_dtype(dtype_out)
        self.kind = (Kind.R2C if self.dtype_in in ("float32", "float64")
                     else Kind.C2C)
        self._opts = default_opts

    def _dtype_str(self) -> str:
        if "complex32" in (self.dtype_in, self.dtype_out):
            return "complex32"
        if self.dtype_out == "complex128":
            return "complex128"
        return "complex64"

    def _spec(self, shape, axes, direction, norm, opts) -> PlanSpec:
        return PlanSpec(shape=shape, axes=axes, kind=self.kind,
                        direction=direction, norm=_NORMS[norm],
                        dtype=self._dtype_str(), **{**self._opts, **opts})

    def make_plan(self, shape, direction=Direction.FORWARD, norm="none",
                  **opts) -> Plan:
        """Plan over all ``dim`` axes (the reference's whole-region FFT).
        Counterpart: ``regent_fft_tpu/api.py:308``."""
        shape = tuple(shape)
        if len(shape) != self.dim:
            raise ValueError(f"interface is {self.dim}-D, got shape {shape}")
        return make_plan(self._spec(shape, tuple(range(self.dim)), direction,
                                    norm, opts))

    def make_plan_batch(self, shape, direction=Direction.FORWARD,
                        norm="none", batch_axis: int = -1, **opts) -> Plan:
        """Transform every axis but ``batch_axis``, at any rank (the
        reference's is 3-D only, with an off-by-one, ``src/fft.rg:416-504``).
        Counterpart: ``regent_fft_tpu/api.py:318``."""
        shape = tuple(shape)
        b = batch_axis % len(shape)
        axes = tuple(a for a in range(len(shape)) if a != b)
        return make_plan(self._spec(shape, axes, direction, norm, opts))

    def make_plan_distrib(self, shape, mesh=None,
                          direction=Direction.FORWARD, norm="none", **opts):
        """Per-shard plans over the leading axis (``src/fft.rg:513-537``):
        ``parallel.distributed.make_plan_shards`` in the interface's kind
        and dtype, built collectively over the ``torch.distributed``
        world; each rank transforms its own block.
        Counterpart: ``regent_fft_tpu/api.py:335``."""
        from .parallel import distributed as _dist
        return _dist.make_plan_shards(
            shape, kind=self.kind, direction=direction, norm=_NORMS[norm],
            dtype=self._dtype_str(), mesh=mesh, **{**self._opts, **opts})

    @staticmethod
    def execute_plan(plan: Plan, x):
        return execute_plan(plan, x)

    # the reference wraps execute in a task for its mapper
    # (src/fft.rg:613-617); here the plan's device decides
    execute_plan_task = execute_plan

    @staticmethod
    def destroy_plan(plan: Plan):
        destroy_plan(plan)

    destroy_plan_task = destroy_plan

    @staticmethod
    def get_num_nodes() -> int:
        """The reference's tunable (src/fft.rg:146-148): the
        ``torch.distributed`` world size, or 1 outside a process group."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    @staticmethod
    def get_num_local_devices() -> int:
        """The reference's tunable (src/fft.rg:151-153): CUDA devices."""
        return torch.cuda.device_count()


def generate_fft_interface(dim: int, dtype_in, dtype_out,
                           **opts) -> FFTInterface:
    """Reference-parity factory (the reference's ``src/fft.rg:31``).
    Counterpart: ``regent_fft_tpu/api.py:372``."""
    return FFTInterface(dim, dtype_in, dtype_out, **opts)


# ---------------------------------------------------------------------------
# Worker count (scipy.fft.set_workers analog)
# ---------------------------------------------------------------------------
_WORKERS = [1]


class set_workers:
    """Context manager mirroring ``scipy.fft.set_workers``.  Advisory, as
    in the JAX package: the count is recorded for :func:`get_workers` and
    changes nothing on the card, whose kernels use every SM.
    Counterpart: ``regent_fft_tpu/api.py:384``."""

    def __init__(self, workers: int):
        workers = int(workers)
        if workers == 0:
            raise ValueError("workers must be nonzero")
        self.workers = workers

    def __enter__(self):
        _WORKERS.append(self.workers)
        return self.workers

    def __exit__(self, *exc):
        _WORKERS.pop()
        return False


def get_workers() -> int:
    """The current advisory worker count (``scipy.fft.get_workers``).
    Counterpart: ``regent_fft_tpu/api.py:414``."""
    return _WORKERS[-1]
