"""Core type vocabulary of the PyTorch port.

Counterpart: ``regent_fft_tpu/dtypes.py``.  The enums keep the JAX
package's values so specs map across by value.

Terminology (SURVEY.md "terminology trap"): the names follow numpy/torch,
not Regent.

* ``complex64``  = 2 x float32 planes (the default);
* ``complex128`` = 2 x float64 planes (the reference's own precision;
  real data is float64);
* ``complex32``  = split re/im bfloat16 planes with float32 compute, the
  fast path that halves the bytes of every kernel pass.  It is carried as a
  :class:`SplitComplex` of bf16 planes at the API boundary.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch


class Direction(enum.IntEnum):
    """Transform direction, FFTW sign convention (FORWARD = -1).

    Counterpart: ``regent_fft_tpu/dtypes.py:26``.
    """

    FORWARD = -1
    BACKWARD = +1


class Kind(enum.Enum):
    """Transform kind.  Counterpart: ``regent_fft_tpu/dtypes.py:37``."""

    C2C = "c2c"
    R2C = "r2c"
    C2R = "c2r"


class Norm(enum.Enum):
    """Normalization convention (numpy.fft strings).

    Counterpart: ``regent_fft_tpu/dtypes.py:51``.
    """

    BACKWARD = "backward"
    ORTHO = "ortho"
    FORWARD = "forward"
    NONE = "none"


class SplitComplex(NamedTuple):
    """A complex tensor stored as separate real/imaginary planes: bf16
    (complex32), f32 or f64.

    Counterpart: ``regent_fft_tpu/dtypes.py:60``.
    """

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return tuple(self.re.shape)

    @property
    def dtype(self):
        return self.re.dtype


# Canonical dtype spellings of a plan, and the plane dtype of each.
# Counterpart: ``regent_fft_tpu/dtypes.py:150``.
COMPLEX_DTYPES = ("complex32", "complex64", "complex128")
PLANE_DTYPES = {"complex32": torch.bfloat16, "complex64": torch.float32,
                "complex128": torch.float64}


def check_dtype(dtype: str) -> str:
    """Accept the three plan dtypes; anything else raises ValueError."""
    if dtype not in COMPLEX_DTYPES:
        raise ValueError(f"unsupported dtype for FFT: {dtype!r}")
    return dtype


def canonical_dtype(dtype) -> str:
    """The canonical name of a dtype (``SplitComplex`` means complex32).

    Counterpart: ``regent_fft_tpu/dtypes.py:153``.
    """
    if dtype is SplitComplex:
        return "complex32"
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = getattr(dtype, "name", None) or str(np.dtype(dtype))
    if name not in COMPLEX_DTYPES + ("float32", "float64", "bfloat16"):
        raise ValueError(f"unsupported dtype for FFT: {dtype!r}")
    return name


def _plane_dtype(dtype) -> torch.dtype:
    """A plan dtype name, or a torch floating dtype, as the plane dtype."""
    return dtype if isinstance(dtype, torch.dtype) else PLANE_DTYPES[dtype]


def as_split(x, device, dtype="complex64") -> SplitComplex:
    """Convert a complex / real / SplitComplex input to contiguous planes on
    ``device``: bf16 for complex32, f32 for complex64, f64 for complex128
    (or the torch floating dtype given).  Host inputs (numpy, CPU tensors)
    are moved there.  A numpy complex input narrower than f64 planes goes
    through f32 first, as in the JAX package.

    Counterpart: ``regent_fft_tpu/dtypes.py:97``.
    """
    device = torch.device(device)
    pd = _plane_dtype(dtype)

    def plane(t):
        return t.to(device=device, dtype=pd).contiguous()

    if isinstance(x, SplitComplex):
        return SplitComplex(plane(torch.as_tensor(x.re)),
                            plane(torch.as_tensor(x.im)))
    if isinstance(x, np.ndarray):
        npd = np.float64 if pd == torch.float64 else np.float32
        if np.iscomplexobj(x):
            return SplitComplex(
                plane(torch.from_numpy(np.ascontiguousarray(x.real, npd))),
                plane(torch.from_numpy(np.ascontiguousarray(x.imag, npd))))
        x = torch.from_numpy(np.ascontiguousarray(x, npd))
    x = torch.as_tensor(x).to(device)
    if x.is_complex():
        if pd != torch.float64 and x.dtype == torch.complex128:
            x = x.to(torch.complex64)
        return SplitComplex(plane(x.real), plane(x.imag))
    xr = plane(x)
    return SplitComplex(xr, torch.zeros_like(xr))


def as_real(x, device, dtype=torch.float32) -> torch.Tensor:
    """Convert a real input (numpy array or tensor; a SplitComplex gives its
    real plane) to one contiguous plane of ``dtype`` (f32, or f64 for a
    complex128 plan) on ``device``, the input of an R2C plan.  Complex
    input raises.

    Counterpart: the R2C branch of ``regent_fft_tpu/plan.py:1060``.
    """
    if isinstance(x, SplitComplex):
        x = x.re
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            raise TypeError("R2C plans take real input, got a complex array")
        npd = np.float64 if dtype == torch.float64 else np.float32
        x = torch.from_numpy(np.ascontiguousarray(x, npd))
    x = torch.as_tensor(x)
    if x.is_complex():
        raise TypeError("R2C plans take real input, got a complex tensor")
    return x.to(device=torch.device(device), dtype=dtype).contiguous()


def from_split(s: SplitComplex, out_dtype: str = "complex64"):
    """Split planes -> the output representation of a plan dtype: a
    SplitComplex of bf16 planes for complex32, else a torch.complex64 or
    torch.complex128 tensor, on the planes' device.

    Counterpart: ``regent_fft_tpu/dtypes.py:124``.
    """
    if out_dtype == "complex32":
        return SplitComplex(s.re.to(torch.bfloat16), s.im.to(torch.bfloat16))
    pd = PLANE_DTYPES[check_dtype(out_dtype)]
    return torch.complex(s.re.to(pd), s.im.to(pd))
