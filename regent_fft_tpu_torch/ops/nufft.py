"""Non-uniform FFT (NUFFT), types 1, 2 and 3, dims 1-3.

Counterpart: ``regent_fft_tpu/ops/nufft.py``: the Dutt-Rokhlin /
Greengard-Lee Gaussian-gridding NUFFT (Greengard & Lee, SIAM Review
46(3), 2004), finufft's conventions:

  type 1 (nonuniform -> uniform modes):
      f_k = sum_j c_j exp(isign * i * k . x_j),  k in [-N/2, N/2)
  type 2 (uniform modes -> nonuniform points):
      c_j = sum_k f_k exp(isign * i * k . x_j)
  type 3 (nonuniform points -> nonuniform frequencies):
      f_k = sum_j c_j exp(isign * i * s_k . x_j)

with x wrapped mod 2pi for types 1/2 and unrestricted for type 3 (the
grid scales to max|x| * max|s|).

On the device: the spread is ``index_add_`` into the flat f32 grid (int64
indices; on CUDA its atomics add in no fixed order), the interpolation a
gather times the weights and a sum, over the same (2p)^d tap stencil as
the JAX package; the oversampled-grid FFT is a complex64 C2C plan
(``make_plan`` ... ``execute_split``: on the card the butterfly kernels;
an unbatched 1-D grid is planned as one row, so 4096..2M points take the
four-step last axis).
The Gaussian deconvolution factors are made on the host in float64 and
uploaded once per (shape, p, device).

The tap geometry (the wrap mod 2pi, the nearest cell, the distances, the
Gaussian weights) and type 3's rescaled points and per-target
deconvolution are computed in float64 from the float32 inputs, then the
weights are rounded to float32.  The JAX package computes them in
float32, which is exact enough at its tests' sizes but not at a grid of
millions of cells: a rounding of 2pi's ulp moves a point by a tenth of a
cell at n = 2^20 modes (ROADMAP Queue 3).  Spread, FFT and interpolation
stay float32; outputs are complex64.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["nufft1d1", "nufft1d2", "nufft2d1", "nufft2d2",
           "nufft3d1", "nufft3d2", "nufft1d3", "nufft2d3", "nufft3d3"]

_R = 2  # oversampling ratio (Greengard-Lee recommended)
_F32 = torch.float32
_F64 = torch.float64


def _taps_for_eps(eps: float) -> int:
    """One-sided tap count p: truncation error ~ exp(-pi*p/2), floored at
    3, capped at 12.  Counterpart: ``regent_fft_tpu/ops/nufft.py:47``."""
    p = int(math.ceil(-math.log(max(eps, 1e-12)) / (math.pi / 2) / 2)) + 1
    return max(3, min(12, p))


def _tau(n: int, p: int) -> float:
    """Gaussian width, GL 2004 eq. (10) with R=2.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:54``."""
    return math.pi * p / (n * n * _R * (_R - 0.5))


def _grid_1d(x: torch.Tensor, n: int, p: int, tau: float):
    """Tap indices (nj, 2p) into the M_r = R*n grid (int64) and Gaussian
    weights (f32): 2p taps centred on x, the nearest cell and p-1/p
    neighbours either side; computed in f64 from ``x`` (f32 or f64).
    Counterpart: ``regent_fft_tpu/ops/nufft.py:60``."""
    mr = _R * n
    h = 2.0 * math.pi / mr
    xw = torch.remainder(x.to(_F64), 2.0 * math.pi)        # [0, 2pi)
    m0 = torch.floor(xw / h).to(torch.int64)
    offs = torch.arange(-(p - 1), p + 1, dtype=torch.int64, device=x.device)
    j = m0[..., None] + offs
    idx = torch.remainder(j, mr)                            # (nj, 2p)
    dist = xw[..., None] - j.to(_F64) * h
    w = torch.exp(-(dist * dist) / (4.0 * tau))             # (nj, 2p)
    return idx, w.to(_F32)


def _nd_tap_product(coords, ns, p):
    """Per-dimension taps -> flat stencil indices (nj, (2p)^d) into the
    row-major oversampled grid and separable Gaussian weights.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:227``."""
    idxs, ws, strides = [], [], []
    stride = 1
    mrs = [_R * n for n in ns]
    for mr in reversed(mrs):
        strides.append(stride)
        stride *= mr
    strides = list(reversed(strides))
    for x, n, st in zip(coords, ns, strides):
        ix, w = _grid_1d(x, n, p, _tau(n, p))
        idxs.append(ix * st)
        ws.append(w)
    if len(ns) == 2:
        idx = idxs[0][:, :, None] + idxs[1][:, None, :]
        w = ws[0][:, :, None] * ws[1][:, None, :]
    else:
        idx = (idxs[0][:, :, None, None] + idxs[1][:, None, :, None]
               + idxs[2][:, None, None, :])
        w = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
             * ws[2][:, None, None, :])
    nj = idx.shape[0]
    return idx.reshape(nj, -1), w.reshape(nj, -1)


def _spread_grid(ys, cr, ci, ns, p: int):
    """Gaussian scatter-add of (cr, ci) at points ``ys`` onto the flat
    oversampled grid (length prod(2 ns)): ``index_add_`` with int64
    indices.  Counterpart: ``regent_fft_tpu/ops/nufft.py:77``."""
    if len(ns) == 1:
        idx, w = _grid_1d(ys[0], ns[0], p, _tau(ns[0], p))
    else:
        idx, w = _nd_tap_product(ys, ns, p)
    total = int(np.prod([_R * n for n in ns]))
    sr = cr[..., :, None] * w
    si = ci[..., :, None] * w
    flat = idx.reshape(-1)
    batch = tuple(sr.shape[:-2])
    gr = torch.zeros(batch + (total,), dtype=_F32, device=cr.device)
    gi = torch.zeros(batch + (total,), dtype=_F32, device=cr.device)
    gr.index_add_(-1, flat, sr.reshape(batch + (-1,)))
    gi.index_add_(-1, flat, si.reshape(batch + (-1,)))
    return gr, gi


def _interp(gr2, gi2, idx, w):
    """Type 2's interpolation: the grid gathered at the taps, times the
    weights, summed.  Counterpart: ``regent_fft_tpu/ops/nufft.py:182-184``."""
    flat = idx.reshape(-1)
    shape = tuple(gr2.shape[:-1]) + tuple(idx.shape)
    cr = (gr2.index_select(-1, flat).reshape(shape) * w).sum(-1)
    ci = (gi2.index_select(-1, flat).reshape(shape) * w).sum(-1)
    return cr, ci


def _deconv_1d(n: int, tau: float) -> np.ndarray:
    """sqrt(pi/tau) * exp(k^2 tau) for k = -n/2 .. n/2-1 (f64 host).
    Counterpart: ``regent_fft_tpu/ops/nufft.py:102``."""
    k = np.arange(-(n // 2), (n + 1) // 2, dtype=np.float64)
    return (math.sqrt(math.pi / tau) * np.exp(k * k * tau)).astype(
        np.float64)


def _deconv_nd(ns, p) -> np.ndarray:
    """Counterpart: ``regent_fft_tpu/ops/nufft.py:259``."""
    d = None
    for n in ns:
        tau = _tau(n, p)
        dk = _deconv_1d(n, tau) / (_R * n)
        d = dk if d is None else np.multiply.outer(d, dk)
    return d.astype(np.float64)


@functools.lru_cache(maxsize=64)
def _deconv_tensor(ns: tuple, p: int, device: str) -> torch.Tensor:
    """The deconvolution factors of modes ``ns`` as an f32 tensor on
    ``device``, uploaded once."""
    d = (_deconv_1d(ns[0], _tau(ns[0], p)) / (_R * ns[0]) if len(ns) == 1
         else _deconv_nd(ns, p))
    return torch.from_numpy(d).to(device=device, dtype=_F32)


def _mode_slices(n: int, mr: int):
    """Positions of modes k=-n/2..n/2-1 in the length-mr DFT output.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:109``."""
    neg = slice(mr - n // 2, mr)
    pos = slice(0, (n + 1) // 2)
    return neg, pos


def grid_plan(shape, ndim: int, inverse: bool, device):
    """The complex64 C2C plan over the trailing ``ndim`` axes of the
    oversampled grid: forward (norm none), or for ``isign > 0`` backward
    with norm backward (the callers then multiply by the grid size, as
    the JAX package does).  Never a one-shot on a SplitComplex, which
    would plan complex32.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:117`` (``_c2c_core``)."""
    from ..dtypes import Direction, Kind, Norm
    from ..plan import PlanSpec, make_plan
    nd = len(shape)
    return make_plan(PlanSpec(
        shape=tuple(shape), axes=tuple(range(nd - ndim, nd)), kind=Kind.C2C,
        direction=Direction.BACKWARD if inverse else Direction.FORWARD,
        norm=Norm.BACKWARD if inverse else Norm.NONE, dtype="complex64",
        device=str(device)))


def _fft_grid(gr, gi, ndim: int, isign: int):
    """The grid's FFT in the sign of ``isign``, unnormalized.  An unbatched
    1-D grid is planned as one row, (1, 2n): the plans send a rank-1 axis
    to the dense pipeline (the JAX package's rule, plan.py:333), a row of
    4096..2M points to the four-step last axis on the card."""
    inverse = isign > 0
    shape = tuple(gr.shape)
    if ndim == 1 and len(shape) == 1:
        gr, gi = gr[None], gi[None]
    gr2, gi2 = grid_plan(gr.shape, ndim, inverse, gr.device).execute_split(
        gr.contiguous(), gi.contiguous())
    gr2, gi2 = gr2.reshape(shape), gi2.reshape(shape)
    if inverse:
        # the inverse plan includes 1/size; the coefficient sum needs the
        # plain sum
        total = float(np.prod(gr.shape[-ndim:]))
        gr2 = gr2 * total
        gi2 = gi2 * total
    return gr2, gi2


def _nufft1d1_impl(x, cr, ci, n: int, isign: int, p: int):
    """Counterpart: ``regent_fft_tpu/ops/nufft.py:141``."""
    mr = _R * n
    gr, gi = _spread_grid((x,), cr, ci, (n,), p)
    gr2, gi2 = _fft_grid(gr, gi, 1, isign)
    neg, pos = _mode_slices(n, mr)
    fr = torch.cat([gr2[..., neg], gr2[..., pos]], -1)
    fi = torch.cat([gi2[..., neg], gi2[..., pos]], -1)
    d = _deconv_tensor((n,), p, str(x.device))
    return fr * d, fi * d


def _nufft1d2_impl(x, fr, fi, isign: int, p: int):
    """Counterpart: ``regent_fft_tpu/ops/nufft.py:162``."""
    n = fr.shape[-1]
    mr = _R * n
    d = _deconv_tensor((n,), p, str(fr.device))
    fr = fr * d
    fi = fi * d
    neg, pos = _mode_slices(n, mr)
    gr = fr.new_zeros(tuple(fr.shape[:-1]) + (mr,))
    gi = fi.new_zeros(tuple(fi.shape[:-1]) + (mr,))
    gr[..., neg] = fr[..., :n // 2]
    gr[..., pos] = fr[..., n // 2:]
    gi[..., neg] = fi[..., :n // 2]
    gi[..., pos] = fi[..., n // 2:]
    # the DFT matrix is symmetric, so the adjoint uses the same
    # exponential sign as type 1
    gr2, gi2 = _fft_grid(gr, gi, 1, isign)
    idx, w = _grid_1d(x, n, p, _tau(n, p))
    return _interp(gr2, gi2, idx, w)


def _center_from_dft(g, ns, mrs):
    """Modes -n/2..n/2-1 per axis from DFT-ordered oversampled output.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:268``."""
    for ax, (n, mr) in enumerate(zip(ns, mrs)):
        a = g.ndim + ax - len(ns)
        neg = g.narrow(a, mr - n // 2, n // 2)
        pos = g.narrow(a, 0, (n + 1) // 2)
        g = torch.cat([neg, pos], a)
    return g


def _embed_to_dft(f, ns, mrs):
    """Adjoint of :func:`_center_from_dft`: centred modes into the
    oversampled DFT-ordered grid, zero elsewhere.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:279``."""
    for ax, (n, mr) in enumerate(zip(ns, mrs)):
        a = f.ndim + ax - len(ns)
        half = n // 2
        shape = list(f.shape)
        shape[a] = mr
        g = f.new_zeros(shape)
        g.narrow(a, 0, n - half).copy_(f.narrow(a, half, n - half))
        g.narrow(a, mr - half, half).copy_(f.narrow(a, 0, half))
        f = g
    return f


def _nufftnd1_impl(coords, cr, ci, ns, isign: int, p: int):
    """Counterpart: ``regent_fft_tpu/ops/nufft.py:298``."""
    mrs = tuple(_R * n for n in ns)
    gr, gi = _spread_grid(coords, cr, ci, ns, p)
    gr = gr.reshape(tuple(gr.shape[:-1]) + mrs)
    gi = gi.reshape(tuple(gi.shape[:-1]) + mrs)
    gr2, gi2 = _fft_grid(gr, gi, len(ns), isign)
    fr = _center_from_dft(gr2, ns, mrs)
    fi = _center_from_dft(gi2, ns, mrs)
    d = _deconv_tensor(tuple(ns), p, str(cr.device))
    return fr * d, fi * d


def _nufftnd2_impl(coords, fr, fi, ns, isign: int, p: int):
    """Counterpart: ``regent_fft_tpu/ops/nufft.py:315``."""
    mrs = tuple(_R * n for n in ns)
    d = _deconv_tensor(tuple(ns), p, str(fr.device))
    gr = _embed_to_dft(fr * d, ns, mrs)
    gi = _embed_to_dft(fi * d, ns, mrs)
    gr2, gi2 = _fft_grid(gr, gi, len(ns), isign)
    total = int(np.prod(mrs))
    gr2 = gr2.reshape(tuple(gr2.shape[:-len(ns)]) + (total,))
    gi2 = gi2.reshape(tuple(gi2.shape[:-len(ns)]) + (total,))
    idx, w = _nd_tap_product(coords, ns, p)
    return _interp(gr2, gi2, idx, w)


def _points(x, device) -> torch.Tensor:
    """Points or frequencies as float32 on ``device`` (the JAX package's
    ``jnp.asarray(x, jnp.float32)``)."""
    from ..dtypes import as_real
    return as_real(x, device, _F32)


def _split_in(c, device):
    from ..dtypes import as_split
    s = as_split(c, device, "complex64")
    return s.re, s.im


def _join_out(r, i):
    return torch.complex(r.contiguous(), i.contiguous())


def _device(device):
    from ..plan import resolve_device
    return resolve_device(device)


def nufft1d1(x, c, n_modes: int, isign: int = 1, eps: float = 1e-6,
             device="cuda"):
    """Type-1 (adjoint) NUFFT: nonuniform samples -> ``n_modes`` Fourier
    modes, f_k = sum_j c_j e^{isign i k x_j}, k = -N/2..N/2-1.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:199``."""
    p = _taps_for_eps(eps)
    dev = _device(device)
    cr, ci = _split_in(c, dev)
    return _join_out(*_nufft1d1_impl(_points(x, dev), cr, ci, int(n_modes),
                                     int(isign), p))


def nufft1d2(x, f, isign: int = 1, eps: float = 1e-6, device="cuda"):
    """Type-2 (forward) NUFFT: Fourier modes -> nonuniform samples,
    c_j = sum_k f_k e^{isign i k x_j}.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:209``."""
    p = _taps_for_eps(eps)
    dev = _device(device)
    fr, fi = _split_in(f, dev)
    return _join_out(*_nufft1d2_impl(_points(x, dev), fr, fi, int(isign), p))


def _nd_entry1(coords, c, ns, isign, eps, device):
    """Counterpart: ``regent_fft_tpu/ops/nufft.py:335``."""
    p = _taps_for_eps(eps)
    dev = _device(device)
    coords = tuple(_points(v, dev) for v in coords)
    cr, ci = _split_in(c, dev)
    return _join_out(*_nufftnd1_impl(coords, cr, ci,
                                     tuple(int(n) for n in ns), int(isign), p))


def _nd_entry2(coords, f, isign, eps, ndim, device):
    """Counterpart: ``regent_fft_tpu/ops/nufft.py:344``."""
    p = _taps_for_eps(eps)
    dev = _device(device)
    coords = tuple(_points(v, dev) for v in coords)
    fr, fi = _split_in(f, dev)
    ns = tuple(int(n) for n in fr.shape[-ndim:])
    return _join_out(*_nufftnd2_impl(coords, fr, fi, ns, int(isign), p))


def nufft2d1(x, y, c, n1: int, n2: int, isign: int = 1, eps: float = 1e-6,
             device="cuda"):
    """2-D type-1 NUFFT: f[k1, k2] = sum_j c_j e^{isign i (k1 x_j + k2 y_j)}.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:353``."""
    return _nd_entry1((x, y), c, (n1, n2), isign, eps, device)


def nufft2d2(x, y, f, isign: int = 1, eps: float = 1e-6, device="cuda"):
    """2-D type-2 NUFFT: c_j = sum_{k1,k2} f[k1,k2] e^{isign i (k1 x_j +
    k2 y_j)}.  Counterpart: ``regent_fft_tpu/ops/nufft.py:358``."""
    return _nd_entry2((x, y), f, isign, eps, 2, device)


def nufft3d1(x, y, z, c, n1: int, n2: int, n3: int, isign: int = 1,
             eps: float = 1e-6, device="cuda"):
    """3-D type-1 NUFFT.  Counterpart: ``regent_fft_tpu/ops/nufft.py:363``."""
    return _nd_entry1((x, y, z), c, (n1, n2, n3), isign, eps, device)


def nufft3d2(x, y, z, f, isign: int = 1, eps: float = 1e-6, device="cuda"):
    """3-D type-2 NUFFT.  Counterpart: ``regent_fft_tpu/ops/nufft.py:369``."""
    return _nd_entry2((x, y, z), f, isign, eps, 3, device)


# ---------------------------------------------------------------------------
# Type 3 (Lee & Greengard 2005 section 4; finufft's t3 strategy): rescale
# the sources into the centre half of a 2pi-periodic fine grid, spread
# them, evaluate the grid as a type-2 NUFFT at u = isign*sigma*h, and
# divide by the spreading Gaussian's transform per target.
# ---------------------------------------------------------------------------
def _t3_dim_params(X: float, S: float, p: int):
    """(gamma, n3, tau) of one dimension: gamma maps sources into
    [-pi/2, pi/2]; the grid half-size n3 keeps every rescaled target inside
    |u| <= pi/2 and the taps interior.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:388``."""
    from .factor import next_fast_len
    X = max(float(X), 1e-12)
    S = max(float(S), 1e-12)
    gamma = X / (math.pi / 2.0)
    sigma_max = S * gamma
    n3 = next_fast_len(max(int(math.ceil(2.0 * sigma_max)), 4 * p, 16))
    tau = _tau(n3, p)
    return gamma, n3, tau


def _t3_deconv(sigma, n3: int, tau: float):
    """h / w_hat(sigma) for the spreading Gaussian e^{-x^2/(4 tau)}:
    w_hat(s) = 2 sqrt(pi tau) e^{-s^2 tau}.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:406``."""
    mr = _R * n3
    h = 2.0 * math.pi / mr
    return (h / (2.0 * math.sqrt(math.pi * tau))) * torch.exp(
        (sigma * sigma) * tau)


def t3_params(xs, ss, eps: float = 1e-6):
    """Type 3's per-dimension (gamma, n3, tau) from max|x| and max|s| (host
    values, as finufft sizes its grid at setpts time).
    Counterpart: ``regent_fft_tpu/ops/nufft.py:427-431``."""
    p = _taps_for_eps(eps)
    return [_t3_dim_params(float(x.abs().max().item()),
                           float(s.abs().max().item()), p)
            for x, s in zip(xs, ss)]


def _nd_entry3(xs, c, ss, isign, eps, device):
    """The type-3 entries' shared body: per-dim parameters on the host,
    one spread, an inner type 2 at u = isign*sigma*h, per-target
    deconvolution; the rescaled points in f64.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:416``."""
    p = _taps_for_eps(eps)
    isign = 1 if int(isign) >= 0 else -1
    dev = _device(device)
    xs = tuple(_points(v, dev) for v in xs)
    ss = tuple(_points(v, dev) for v in ss)
    cr, ci = _split_in(c, dev)
    dims = t3_params(xs, ss, eps)
    ys = tuple(x.to(_F64) / g + math.pi for x, (g, _, _) in zip(xs, dims))
    ns3 = tuple(n3 for (_, n3, _) in dims)
    gr, gi = _spread_grid(ys, cr, ci, ns3, p)
    us, d = [], 1.0
    for s, (gamma, n3, tau) in zip(ss, dims):
        sigma = s.to(_F64) * gamma
        us.append((isign * 2.0 * math.pi / (_R * n3)) * sigma)
        d = d * _t3_deconv(sigma, n3, tau)
    d = d.to(_F32)
    if len(xs) == 1:
        vr, vi = _nufft1d2_impl(us[0], gr, gi, 1, p)
    else:
        mrs = tuple(_R * n3 for n3 in ns3)
        gr = gr.reshape(tuple(gr.shape[:-1]) + mrs)
        gi = gi.reshape(tuple(gi.shape[:-1]) + mrs)
        vr, vi = _nufftnd2_impl(tuple(us), gr, gi, mrs, 1, p)
    return _join_out(vr * d, vi * d)


def nufft1d3(x, c, s, isign: int = 1, eps: float = 1e-6, device="cuda"):
    """Type-3 NUFFT: f_k = sum_j c_j e^{isign i s_k x_j} for arbitrary real
    points ``x`` and frequencies ``s`` (finufft ``nufft1d3``).
    Counterpart: ``regent_fft_tpu/ops/nufft.py:452``."""
    return _nd_entry3((x,), c, (s,), isign, eps, device)


def nufft2d3(x, y, c, s, t, isign: int = 1, eps: float = 1e-6,
             device="cuda"):
    """2-D type-3 NUFFT: f_k = sum_j c_j e^{isign i (s_k x_j + t_k y_j)}.
    Counterpart: ``regent_fft_tpu/ops/nufft.py:458``."""
    return _nd_entry3((x, y), c, (s, t), isign, eps, device)


def nufft3d3(x, y, z, c, s, t, u, isign: int = 1, eps: float = 1e-6,
             device="cuda"):
    """3-D type-3 NUFFT: f_k = sum_j c_j e^{isign i (s_k x_j + t_k y_j +
    u_k z_j)}.  Counterpart: ``regent_fft_tpu/ops/nufft.py:463``."""
    return _nd_entry3((x, y, z), c, (s, t, u), isign, eps, device)
