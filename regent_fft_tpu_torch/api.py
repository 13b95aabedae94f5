"""numpy.fft-style one-shot C2C functions over the plan cache.

Counterpart: ``regent_fft_tpu/api.py`` (:102-147).  Each call plans
through the cache, so repeated calls for one problem reuse the plan.
Extra keyword options (``device``, ``backend``, ...) go to
:class:`PlanSpec`.  The real and Hermitian functions are ROADMAP slice 3.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import Direction, Kind, Norm, SplitComplex
from .plan import PlanSpec, make_plan

_NORMS = {None: Norm.BACKWARD, "backward": Norm.BACKWARD, "ortho": Norm.ORTHO,
          "forward": Norm.FORWARD, "none": Norm.NONE}


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


def _real_transform(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (real/Hermitian transforms) is ROADMAP slice 3 of the "
            "PyTorch port")
    fn.__name__ = name
    fn.__doc__ = (f"Counterpart: ``regent_fft_tpu.api.{name}``; ROADMAP "
                  "slice 3, raises NotImplementedError.")
    return fn


rfft = _real_transform("rfft")
irfft = _real_transform("irfft")
rfft2 = _real_transform("rfft2")
irfft2 = _real_transform("irfft2")
rfftn = _real_transform("rfftn")
irfftn = _real_transform("irfftn")
hfft = _real_transform("hfft")
ihfft = _real_transform("ihfft")
