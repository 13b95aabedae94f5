"""scipy.fft backend: route ``scipy.fft.*`` through the port's plans.

Counterpart: ``regent_fft_tpu/scipy_backend.py``.  scipy.fft dispatches
every transform through the ``uarray`` protocol (domain
``"numpy.scipy.fft"``); a backend object per device implements it::

    import scipy.fft
    from regent_fft_tpu_torch.scipy_backend import RegentFFTBackend, backend

    with scipy.fft.set_backend(RegentFFTBackend):     # the card
        y = scipy.fft.fft(x)
    with scipy.fft.set_backend(backend("cpu")):       # the plain versions
        y = scipy.fft.fft(x)

    from regent_fft_tpu_torch import scipy_backend
    scipy_backend.enable()                            # process-wide
    ...
    scipy_backend.disable()

Covered: the complex, real and Hermitian families (fft/ifft/fft2/ifft2/
fftn/ifftn, rfft/irfft/rfft2/irfft2/rfftn/irfftn, hfft/ihfft/hfft2/ihfft2/
hfftn/ihfftn), the DCT/DST family with scipy's norm and orthogonalize
(dct/idct/dst/idst, dctn/idctn/dstn/idstn), the fast Hankel transform
(fht/ifht) and next_fast_len/prev_fast_len.

numpy input is copied to the backend's device, transformed there and
copied back as numpy (tensor input gives tensor output on that device).
The output keeps the input's precision class: float64/complex128 input
computes in float64 on the port's f64 route and returns complex128 or
float64; float32/complex64 input computes in float32 (``fht``/``ifht``
compute in float32 for every input, as in the JAX package).

Declining: a function or an argument combination the handlers refuse
before anything runs (``plan=``, an unknown norm, complex input to a real
transform, arguments that do not bind) returns ``NotImplemented``, so
scipy's own pocketfft answers; a refusal by ``TypeError``/``ValueError``
warns once per function.  Nothing that happens once the transform runs is
declined: a missing card, a kernel build failure and any error of a plan
or kernel propagate to the caller, so pocketfft never answers in their
place.
"""
from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from . import api as _api
from .ops import factor as _factor
from .ops import fftlog as _fftlog
from .ops import r2r as _r2r

__all__ = ["RegentFFTBackend", "backend", "enable", "disable"]

_NOT = object()  # sentinel: the handler declines, scipy falls back
_NORMS = (None, "backward", "ortho", "forward")


def _in_precision(x0) -> int:
    """64 if the caller's array was double precision, else 32.
    Counterpart: ``regent_fft_tpu/scipy_backend.py:68``."""
    d = getattr(x0, "dtype", None)
    if d is not None:
        d = np.dtype(d)
        if (d.kind == "c" and d.itemsize >= 16) or \
           (d.kind == "f" and d.itemsize >= 8):
            return 64
        if d.kind in "cf":
            return 32
        return 64  # integer input: numpy promotes to f64
    if isinstance(x0, (list, tuple, float, complex)):
        return 64  # numpy would promote python scalars/lists to f64
    return 32


def _to_numpy(y: torch.Tensor, prec: int) -> np.ndarray:
    """A numpy caller's output in its precision class.
    Counterpart: ``regent_fft_tpu/scipy_backend.py:86``."""
    out = y.detach().cpu().numpy()
    if out.dtype.kind == "c":
        return out.astype(np.complex128 if prec == 64 else np.complex64,
                          copy=False)
    if out.dtype.kind == "f":
        return out.astype(np.float64 if prec == 64 else np.float32,
                          copy=False)
    return out


def _operand(x, real: bool = False):
    """(tensor on the host or where it lies, numpy-in flag) of an input;
    raises TypeError for data the port does not take."""
    if isinstance(x, torch.Tensor):
        t, numpy_in = x, False
    else:
        arr = np.asarray(x)
        if arr.dtype.kind in "biu":
            arr = arr.astype(np.float64)  # numpy's promotion
        elif arr.dtype.kind not in "fc" or arr.dtype.itemsize > 16:
            raise TypeError(f"unsupported input dtype {arr.dtype}")
        t, numpy_in = torch.from_numpy(np.ascontiguousarray(arr)), True
    if real and t.is_complex():
        raise TypeError("x must be a real sequence")
    return t, numpy_in


def _result(y, x0, numpy_in: bool):
    return _to_numpy(y, _in_precision(x0)) if numpy_in else y


# ---------------------------------------------------------------------------
# Handlers: scipy's signature outside; they validate and return the run
# (a function of the device), or _NOT to decline.  No plan runs in them.
# ---------------------------------------------------------------------------
def _cplx(fn, real_in=False):
    def h(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None,
          *, plan=None):
        if plan is not None or norm not in _NORMS:
            return _NOT
        if n is not None and int(n) < 1:
            raise ValueError(f"invalid number of data points ({n})")
        t, numpy_in = _operand(x, real_in)
        return lambda device: _result(
            fn(t, n=n, axis=axis, norm=norm, device=device), x, numpy_in)
    return h


def _cplx_nd(fn, default_axes=None, real_in=False):
    # uarray passes only the caller's arguments: these defaults stand in
    # for scipy's, so the 2-D family needs its (-2, -1)
    def h(x, s=None, axes=default_axes, norm=None, overwrite_x=False,
          workers=None, *, plan=None):
        if plan is not None or norm not in _NORMS:
            return _NOT
        if isinstance(axes, int):
            axes = (axes,)
        if s is not None and any(int(v) < 1 for v in s):
            raise ValueError(f"invalid number of data points ({s})")
        t, numpy_in = _operand(x, real_in)
        return lambda device: _result(
            fn(t, s=s, axes=axes, norm=norm, device=device), x, numpy_in)
    return h


def _r2r_check(type, norm):
    if type not in (1, 2, 3, 4):
        raise ValueError(f"type must be 1-4, got {type}")
    if norm not in _NORMS:
        raise ValueError(f"invalid norm {norm!r}")


def _r2r_1d(fn):
    def h(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
          workers=None, orthogonalize=None):
        _r2r_check(type, norm)
        t, numpy_in = _operand(x, real=True)
        return lambda device: _result(
            fn(t, type=type, n=n, axis=axis, norm=norm,
               orthogonalize=orthogonalize, device=device), x, numpy_in)
    return h


def _r2r_nd(fn):
    def h(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
          workers=None, orthogonalize=None):
        _r2r_check(type, norm)
        t, numpy_in = _operand(x, real=True)
        return lambda device: _result(
            fn(t, type=type, s=s, axes=axes, norm=norm,
               orthogonalize=orthogonalize, device=device), x, numpy_in)
    return h


def _hankel(fn):
    def h(a, dln, mu, offset=0.0, bias=0.0):
        t, numpy_in = _operand(a, real=True)
        return lambda device: _result(
            fn(t, dln, mu, offset=offset, bias=bias, device=device), a,
            numpy_in)
    return h


def _fast_len(fn):
    # lengths fast for THIS engine: the kernels' radix set
    def h(target, real=False):
        return lambda device: int(fn(int(target)))
    return h


_HANDLERS = {
    "fft": _cplx(_api.fft), "ifft": _cplx(_api.ifft),
    "rfft": _cplx(_api.rfft, True), "irfft": _cplx(_api.irfft),
    "hfft": _cplx(_api.hfft), "ihfft": _cplx(_api.ihfft, True),
    "fft2": _cplx_nd(_api.fft2, (-2, -1)),
    "ifft2": _cplx_nd(_api.ifft2, (-2, -1)),
    "fftn": _cplx_nd(_api.fftn), "ifftn": _cplx_nd(_api.ifftn),
    "rfft2": _cplx_nd(_api.rfft2, (-2, -1), True),
    "irfft2": _cplx_nd(_api.irfft2, (-2, -1)),
    "rfftn": _cplx_nd(_api.rfftn, None, True),
    "irfftn": _cplx_nd(_api.irfftn),
    "hfft2": _cplx_nd(_api.hfft2, (-2, -1)),
    "ihfft2": _cplx_nd(_api.ihfft2, (-2, -1), True),
    "hfftn": _cplx_nd(_api.hfftn), "ihfftn": _cplx_nd(_api.ihfftn, None, True),
    "dct": _r2r_1d(_r2r.dct), "idct": _r2r_1d(_r2r.idct),
    "dst": _r2r_1d(_r2r.dst), "idst": _r2r_1d(_r2r.idst),
    "dctn": _r2r_nd(_r2r.dctn), "idctn": _r2r_nd(_r2r.idctn),
    "dstn": _r2r_nd(_r2r.dstn), "idstn": _r2r_nd(_r2r.idstn),
    "fht": _hankel(_fftlog.fht), "ifht": _hankel(_fftlog.ifht),
    "next_fast_len": _fast_len(_factor.next_fast_len),
    "prev_fast_len": _fast_len(_factor.prev_fast_len),
}


class _Backend:
    """A uarray backend for ``scipy.fft.set_backend`` /
    ``set_global_backend`` that runs on one device.
    Counterpart: ``regent_fft_tpu/scipy_backend.py:204``."""

    __ua_domain__ = "numpy.scipy.fft"

    def __init__(self, device: str):
        self.device = device
        self._warned = set()   # functions whose refusal already warned

    def __repr__(self):
        return f"regent_fft_tpu_torch.scipy_backend.backend({self.device!r})"

    def __ua_function__(self, method, args, kwargs):
        name = getattr(method, "__name__", None)
        handler = _HANDLERS.get(name)
        if handler is None:
            return NotImplemented
        try:
            run = handler(*args, **kwargs)
        except NotImplementedError:
            return NotImplemented
        except (TypeError, ValueError) as e:
            # refused before anything ran: scipy answers, and says so once
            # per function so that acceleration is never lost silently
            if name not in self._warned:
                self._warned.add(name)
                warnings.warn(
                    f"regent_fft_tpu_torch scipy backend: {name}() refused "
                    f"its arguments ({type(e).__name__}: {e}); scipy "
                    f"answers this call (shown once per function)",
                    RuntimeWarning, stacklevel=2)
            return NotImplemented
        if run is _NOT:
            return NotImplemented
        return run(self.device)


@functools.lru_cache(maxsize=None)
def backend(device: str = "cuda") -> _Backend:
    """The backend object that runs scipy.fft calls on ``device``
    (``"cuda"``: the card, ``"cpu"``: the kernels' plain versions)."""
    return _Backend(str(torch.device(device)))


RegentFFTBackend = backend("cuda")


def enable(coerce: bool = False, device: str = "cuda"):
    """Install the backend of ``device`` process-wide
    (``scipy.fft.set_global_backend``); uncovered functions and declined
    arguments fall back to scipy's own (``only=False``).
    Counterpart: ``regent_fft_tpu/scipy_backend.py:241``."""
    import scipy.fft
    scipy.fft.set_global_backend(backend(device), coerce=coerce, only=False)


def disable():
    """Restore scipy's default backend.
    Counterpart: ``regent_fft_tpu/scipy_backend.py:251``."""
    import scipy.fft
    scipy.fft.set_global_backend("scipy")
