"""``torch.fft`` drop-in namespace on the port's plans and kernels.

Counterpart: ``regent_fft_tpu/torch_fft.py``.  The ``torch.fft`` names,
signatures (``input, n/s, dim, norm, *, out``) and dtype promotion, so a
torch program switches engines with one import::

    from regent_fft_tpu_torch import torch_fft as fft   # was: from torch import fft

There is no host bridge: a CUDA tensor runs the port's plans on its own
card and returns a CUDA tensor; a CPU tensor is the caller asking for the
CPU and runs the kernels' plain versions there.  The output stays on the
input's device.  The JAX adapter computes on the configured JAX device
and copies back across the host.

Promotion as ``torch.fft``: integer and bool inputs become float32;
bfloat16 and float16 widen to float32, complex32 to complex64, and give
complex64 (the JAX adapter's rule); float32/complex64 give complex64 and
float64/complex128 give complex128, computed in float64 on the port's f64
route (the JAX adapter computes them in float32 unless JAX x64 is on).
Like the JAX adapter this is an inference-path adapter: the input is
detached from autograd.
"""
from __future__ import annotations

import numpy as np
import torch

from . import api as _api

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
           "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq"]


def _input(x) -> torch.Tensor:
    """The tensor a transform runs on, promoted and detached.
    Counterpart: ``regent_fft_tpu/torch_fft.py:48``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    x = x.detach()
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        return x.to(torch.float32)  # torch promotes int/bool to the default
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float32)
    if x.dtype == torch.complex32:
        return x.to(torch.complex64)
    return x


def _wrap_1d(fn):
    def h(input, n=None, dim=-1, norm=None, *, out=None):
        if out is not None:
            raise NotImplementedError("out= is not supported")
        x = _input(input)
        return fn(x, n=n, axis=dim, norm=norm, device=x.device)
    h.__name__ = h.__qualname__ = fn.__name__
    h.__doc__ = f"``torch.fft.{fn.__name__}`` on the port's plans."
    return h


def _wrap_nd(fn, default_dim):
    def h(input, s=None, dim=default_dim, norm=None, *, out=None):
        if out is not None:
            raise NotImplementedError("out= is not supported")
        x = _input(input)
        if isinstance(dim, int):
            dim = (dim,)
        return fn(x, s=s, axes=dim, norm=norm, device=x.device)
    h.__name__ = h.__qualname__ = fn.__name__
    h.__doc__ = f"``torch.fft.{fn.__name__}`` on the port's plans."
    return h


fft = _wrap_1d(_api.fft)
ifft = _wrap_1d(_api.ifft)
rfft = _wrap_1d(_api.rfft)
irfft = _wrap_1d(_api.irfft)
hfft = _wrap_1d(_api.hfft)
ihfft = _wrap_1d(_api.ihfft)

fft2 = _wrap_nd(_api.fft2, (-2, -1))
ifft2 = _wrap_nd(_api.ifft2, (-2, -1))
fftn = _wrap_nd(_api.fftn, None)
ifftn = _wrap_nd(_api.ifftn, None)
rfft2 = _wrap_nd(_api.rfft2, (-2, -1))
irfft2 = _wrap_nd(_api.irfft2, (-2, -1))
rfftn = _wrap_nd(_api.rfftn, None)
irfftn = _wrap_nd(_api.irfftn, None)
hfft2 = _wrap_nd(_api.hfft2, (-2, -1))
ihfft2 = _wrap_nd(_api.ihfft2, (-2, -1))
hfftn = _wrap_nd(_api.hfftn, None)
ihfftn = _wrap_nd(_api.ihfftn, None)


def _dims(x, dim):
    if dim is None:
        return list(range(x.ndim))
    if isinstance(dim, int):
        return [dim]
    return list(dim)


def fftshift(input, dim=None):
    """``torch.fft.fftshift``.  Counterpart: torch_fft.py:127."""
    x = input if isinstance(input, torch.Tensor) else torch.as_tensor(input)
    dims = _dims(x, dim)
    return torch.roll(x, [x.shape[d] // 2 for d in dims], dims)


def ifftshift(input, dim=None):
    """``torch.fft.ifftshift``.  Counterpart: torch_fft.py:134."""
    x = input if isinstance(input, torch.Tensor) else torch.as_tensor(input)
    dims = _dims(x, dim)
    return torch.roll(x, [-(x.shape[d] // 2) for d in dims], dims)


def _freq(values: np.ndarray, out, dtype, device, requires_grad):
    if out is not None:
        raise NotImplementedError("out= is not supported")
    y = torch.from_numpy(values).to(dtype=dtype or torch.get_default_dtype(),
                                    device=device)
    return y.requires_grad_(True) if requires_grad else y


def fftfreq(n, d=1.0, *, out=None, dtype=None, layout=None, device=None,
            requires_grad=False):
    """``torch.fft.fftfreq``.  Counterpart: torch_fft.py:149."""
    return _freq(np.fft.fftfreq(int(n), d=float(d)), out, dtype, device,
                 requires_grad)


def rfftfreq(n, d=1.0, *, out=None, dtype=None, layout=None, device=None,
             requires_grad=False):
    """``torch.fft.rfftfreq``.  Counterpart: torch_fft.py:160."""
    return _freq(np.fft.rfftfreq(int(n), d=float(d)), out, dtype, device,
                 requires_grad)
