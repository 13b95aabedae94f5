"""Core type vocabulary of the PyTorch port.

Counterpart: ``regent_fft_tpu/dtypes.py``.  The enums keep the JAX
package's values so specs map across by value.

Terminology: ``complex64`` means torch/numpy complex64 = 2 x float32 (not
Regent's meaning of the name, see SURVEY.md); its real counterpart is
float32.  The port carries complex64 only; complex32 (split bf16) and
complex128 (with float64 real data) are ROADMAP slice 4.
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
    """A complex tensor stored as separate real/imaginary f32 planes.

    Counterpart: ``regent_fft_tpu/dtypes.py:60``.
    """

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return tuple(self.re.shape)


def check_dtype(dtype: str) -> str:
    """Accept complex64 only; name the ROADMAP slice for the others."""
    if dtype in ("complex32", "complex128"):
        raise NotImplementedError(
            f"{dtype} plans are ROADMAP slice 4 of the PyTorch port; this "
            "slice carries complex64 only")
    if dtype != "complex64":
        raise ValueError(f"unsupported dtype for FFT: {dtype!r}")
    return dtype


def as_split(x, device) -> SplitComplex:
    """Convert a complex / real / SplitComplex input to f32 planes on
    ``device``.  Host inputs (numpy, CPU tensors) are moved there.

    Counterpart: ``regent_fft_tpu/dtypes.py:97``.
    """
    device = torch.device(device)
    if isinstance(x, SplitComplex):
        return SplitComplex(
            x.re.to(device=device, dtype=torch.float32).contiguous(),
            x.im.to(device=device, dtype=torch.float32).contiguous())
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            return SplitComplex(
                torch.from_numpy(np.ascontiguousarray(x.real, np.float32)).to(device),
                torch.from_numpy(np.ascontiguousarray(x.imag, np.float32)).to(device))
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    x = torch.as_tensor(x).to(device)
    if x.is_complex():
        if x.dtype == torch.complex128:
            x = x.to(torch.complex64)
        return SplitComplex(x.real.contiguous(), x.imag.contiguous())
    xr = x.to(torch.float32).contiguous()
    return SplitComplex(xr, torch.zeros_like(xr))


def as_real(x, device) -> torch.Tensor:
    """Convert a real input (numpy array or tensor; a SplitComplex gives its
    real plane) to one contiguous f32 plane on ``device``, the input of an
    R2C plan.  Complex input raises.

    Counterpart: the R2C branch of ``regent_fft_tpu/plan.py:1060``.
    """
    if isinstance(x, SplitComplex):
        x = x.re
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            raise TypeError("R2C plans take real input, got a complex array")
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    x = torch.as_tensor(x)
    if x.is_complex():
        raise TypeError("R2C plans take real input, got a complex tensor")
    return x.to(device=torch.device(device), dtype=torch.float32).contiguous()


def from_split(s: SplitComplex) -> torch.Tensor:
    """Split planes -> a torch.complex64 tensor on the planes' device.

    Counterpart: ``regent_fft_tpu/dtypes.py:124``.
    """
    return torch.complex(s.re, s.im)
