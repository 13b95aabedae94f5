"""NPB FT's iteration in plain PyTorch: the plain reference of the
``npb_ft_c_c128`` configuration (NAS Parallel Benchmarks 3.4, kernel FT;
class C is 512 x 512 x 512, 20 iterations, alpha = 1e-6).

FT solves the heat equation spectrally.  The field is transformed forward
once; then each iteration t = 1..T multiplies the spectrum by the evolve
factor exp(-4 alpha pi^2 |kbar|^2) once more (so the spectrum of
iteration t carries it to the power t), runs an inverse 3-D FFT and sums
1024 sampled elements of the result into a checksum:

    chk_t = sum_{j=1..1024} u_t[j mod n0, 3j mod n1, 5j mod n2]

where kbar = k for k < n/2, else k - n, on each axis.  Everything is
complex128 through ``torch.fft``.  The inverse is backward-normalised
(1/N): NPB's inverse is unscaled and its checksum divides by N, so the
numbers are the same.

Departure from NPB: the initial field is seeded standard normal values
(re and im, from ``torch.Generator``), not NPB's ``randlc`` sequence, so
the checksums are not NPB's published verification values.

Imports nothing of the program (``regent_fft_tpu_torch``) and nothing of
JAX.
"""
from __future__ import annotations

import math

import torch

ALPHA = 1e-6
SAMPLES = 1024
# NPB 3.4 classes (setparams): grid (nx, ny, nz) and iterations
CLASSES = {"S": ((64, 64, 64), 6), "W": ((128, 128, 32), 6),
           "A": ((256, 256, 128), 6), "B": ((512, 256, 256), 20),
           "C": ((512, 512, 512), 20)}


def kbar(n: int, device="cpu") -> torch.Tensor:
    """The signed wave numbers of an n-point axis, float64."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    return torch.where(k < n / 2, k, k - n)


def evolve_factor(shape, alpha: float = ALPHA, device="cpu") -> torch.Tensor:
    """exp(-4 alpha pi^2 |kbar|^2) over the grid, float64: the factor one
    iteration multiplies the spectrum by."""
    n0, n1, n2 = shape
    k2 = (kbar(n0, device)[:, None, None] ** 2
          + kbar(n1, device)[None, :, None] ** 2
          + kbar(n2, device)[None, None, :] ** 2)
    return torch.exp(-4.0 * alpha * math.pi ** 2 * k2)


def sample_index(shape, device="cpu") -> tuple:
    """The index tensors of the checksum's 1024 elements."""
    j = torch.arange(1, SAMPLES + 1, device=device)
    return j % shape[0], (3 * j) % shape[1], (5 * j) % shape[2]


def checksum(u: torch.Tensor, index: tuple) -> complex:
    """The sum of ``u`` at ``index`` (:func:`sample_index`)."""
    return complex(u[index].sum().item())


def initial_field(shape, seed: int, device="cpu") -> torch.Tensor:
    """Seeded standard normal complex128 field (not NPB's ``randlc``)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    re = torch.randn(tuple(shape), generator=g, dtype=torch.float64,
                     device=device)
    im = torch.randn(tuple(shape), generator=g, dtype=torch.float64,
                     device=device)
    return torch.complex(re, im)


def iterate(u0: torch.Tensor, iters: int, alpha: float = ALPHA) -> tuple:
    """FT's iterations from the complex128 field ``u0``: (the ``iters``
    checksums, the last iteration's field)."""
    shape = tuple(u0.shape)
    spec = torch.fft.fftn(u0)
    factor = evolve_factor(shape, alpha, u0.device)
    index = sample_index(shape, u0.device)
    sums, u = [], None
    for _ in range(iters):
        spec.mul_(factor)
        del u
        u = torch.fft.ifftn(spec)
        sums.append(checksum(u, index))
    return sums, u
