"""FFT convolution, correlation, overlap-add, analytic signal, Fourier
resampling and the short-time Fourier transform (``scipy.signal`` parity)
on the port's plans.

Counterpart: ``regent_fft_tpu/signal.py``.  Every transform is a cached
plan of the port on the caller's ``device`` (the card by default;
``device="cpu"`` runs the kernels' plain versions):

* :func:`fftconvolve` takes C2C plans at ``next_fast_len`` sizes for
  complex input, R2C/C2R plans at those sizes for real input, and where
  every convolved axis rounds to a power of two whose last axis the
  row-pair kernels take Nyquist-packed (n = 256, 512, 1024 on the card:
  ``stockham_kernels.r2c_packed_supported``), the packed layout
  (``PlanSpec.packed_layout``): lane 0 holds the tangled bin-0/Nyquist
  pair, untangled and re-tangled on that one column,

      A0  = (P_a + conj(rev(P_a))) / 2       rev = mid-axis frequency
      ANq = (P_a - conj(rev(P_a))) / (2i)          reversal
      P_c = (A0*B0) + i * (ANq*BNq)

  and the product of the other lanes is the plain one.  Where the packed
  plans cannot be made (another backend, a longer last axis) ``auto``
  drops to the plain sizes, as the JAX package does.
* :func:`stft` frames with ``Tensor.unfold`` (a view, no gather copy) and
  runs one batched R2C plan over every segment; :func:`istft` one batched
  C2R plan and a scatter-free overlap-add (slice adds in a fixed order).

The spectral products, the windows and the overlap-add are PyTorch
elementwise ops, as they are ``jnp`` ops outside any kernel in the JAX
package.  Data computes in float32 / complex64, as the JAX package does
without x64; windows are made by ``scipy.signal.get_window`` in float64
and rounded to float32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .api import fft, fft2, ifft, ifft2, irfft, rfft
from .dtypes import Direction, Kind, Norm
from .ops import factor as _factor
from .plan import PlanSpec, _rev_freq, make_plan, resolve_device

__all__ = ["fftconvolve", "correlate", "oaconvolve", "hilbert", "hilbert2",
           "resample", "stft", "istft"]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _conv_sizes(sa, sb, axes, method: str) -> Tuple[Tuple[int, ...], bool]:
    """Padded FFT sizes per axis and whether the packed path applies.

    ``auto`` uses packed power-of-two sizes when their total padding
    stays within 1.35x of the next_fast_len sizes (the packed roundtrip
    saves ~25%, so a bigger blowup loses); else plain fast sizes.
    Counterpart: ``regent_fft_tpu/signal.py:42``.
    """
    full = [sa[a] + sb[a] - 1 for a in range(len(sa))]
    fast = [(_factor.next_fast_len(f) if a in axes else sa[a])
            for a, f in enumerate(full)]
    pow2 = [(_next_pow2(f) if a in axes else sa[a])
            for a, f in enumerate(full)]
    last = axes[-1]
    packed_ok = pow2[last] >= 256 and (pow2[last] // 2) % 128 == 0
    if method == "plain" or not packed_ok:
        return tuple(fast), False
    if method == "packed":
        return tuple(pow2), True
    blowup = np.prod([pow2[a] / fast[a] for a in axes])
    if blowup <= 1.35:
        return tuple(pow2), True
    return tuple(fast), False


def _tensor(x, device) -> torch.Tensor:
    """An input (array, tensor, list) as a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device)


def _single(x: torch.Tensor) -> torch.Tensor:
    """float32, or complex64 for complex data (the JAX package's classes)."""
    return x.to(torch.complex64 if x.is_complex() else torch.float32)


def _pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad every axis at its end to ``shape`` (``F.pad`` lists the
    axes from the last)."""
    pad = []
    for s, t in reversed(list(zip(x.shape, shape))):
        pad += [0, t - s]
    return F.pad(x, pad) if any(pad) else x


def _packed_mul(za: torch.Tensor, zb: torch.Tensor, mid_axes):
    """Spectral product of two Nyquist-packed half spectra.
    Counterpart: ``regent_fft_tpu/signal.py:76``."""
    c = za * zb  # correct on lanes >= 1; lane 0 fixed below

    def untangle(z):
        z0 = z[..., 0]
        r = _rev_freq(z0, mid_axes).conj()
        return 0.5 * (z0 + r), -0.5j * (z0 - r)

    a0, anq = untangle(za)
    b0, bnq = untangle(zb)
    c[..., 0] = a0 * b0 + 1j * (anq * bnq)
    return c


def _slice_mode(y, sa, sb, axes, mode: str):
    """Counterpart: ``regent_fft_tpu/signal.py:103``."""
    if mode == "full":
        idx = [slice(0, sa[a] + sb[a] - 1) if a in axes else slice(None)
               for a in range(y.ndim)]
    elif mode == "same":
        idx = []
        for a in range(y.ndim):
            if a in axes:
                start = (sb[a] - 1) // 2
                idx.append(slice(start, start + sa[a]))
            else:
                idx.append(slice(None))
    elif mode == "valid":
        idx = []
        for a in range(y.ndim):
            if a in axes:
                if sa[a] < sb[a]:
                    raise ValueError("valid mode needs a no smaller than b "
                                     "on every convolved axis")
                idx.append(slice(sb[a] - 1, sa[a]))
            else:
                idx.append(slice(None))
    else:
        raise ValueError(f"mode must be full|same|valid, got {mode!r}")
    return y[tuple(idx)]


def _conv_axes(ndim: int, axes) -> Tuple[int, ...]:
    return (tuple(range(ndim)) if axes is None
            else tuple(sorted(ax % ndim for ax in axes)))


def fftconvolve(a, b, mode: str = "full", axes: Optional[Sequence[int]] = None,
                method: str = "auto", backend: str = "auto", device="cuda"):
    """Convolve ``a`` with ``b`` via cached FFT plans
    (``scipy.signal.fftconvolve`` semantics).

    ``method``: 'auto' picks the packed power-of-two real path when its
    padding blowup is small; 'packed' forces it; 'plain' forces
    next_fast_len sizes with the numpy-layout plans.  Complex inputs
    always use C2C plans.  ``backend`` passes through to the plans (on the
    CPU, packed needs backend='stockham').  Returns a float32 or complex64
    tensor on ``device``.  Counterpart: ``regent_fft_tpu/signal.py:130``.
    """
    dev = resolve_device(device)
    a = _tensor(a, dev)
    b = _tensor(b, dev)
    if a.ndim != b.ndim:
        raise ValueError(f"rank mismatch: {a.ndim} vs {b.ndim}")
    axes = _conv_axes(a.ndim, axes)
    for ax in range(a.ndim):
        if ax not in axes and a.shape[ax] != b.shape[ax]:
            raise ValueError(f"non-convolved axis {ax} must match: "
                             f"{tuple(a.shape)} vs {tuple(b.shape)}")
    sa, sb = tuple(a.shape), tuple(b.shape)

    if a.is_complex() or b.is_complex():
        fft_shape = tuple(
            _factor.next_fast_len(sa[ax] + sb[ax] - 1) if ax in axes
            else sa[ax] for ax in range(a.ndim))
        fwd = make_plan(PlanSpec(shape=fft_shape, axes=axes, kind=Kind.C2C,
                                 direction=Direction.FORWARD, norm=Norm.NONE,
                                 use_3m=True, backend=backend, device=device))
        inv = fwd.inverse()
        za = fwd(_pad_to(a.to(torch.complex64), fft_shape))
        zb = fwd(_pad_to(b.to(torch.complex64), fft_shape))
        return _slice_mode(inv(za * zb), sa, sb, axes, mode)

    fft_shape, packed = _conv_sizes(sa, sb, axes, method)

    def _plans(fft_shape, packed):
        common = dict(shape=fft_shape, axes=axes, use_3m=True,
                      backend=backend, packed_layout=packed, device=device)
        return (make_plan(PlanSpec(kind=Kind.R2C, direction=Direction.FORWARD,
                                   norm=Norm.NONE, **common)),
                make_plan(PlanSpec(kind=Kind.C2R,
                                   direction=Direction.BACKWARD,
                                   norm=Norm.BACKWARD, **common)))

    if packed:
        try:
            fwd, inv = _plans(fft_shape, True)
        except ValueError:
            if method == "packed":
                raise  # the caller demanded it; surface the reason
            # auto: the packed kernel path is not available (the resolved
            # backend, or a last axis the row-pair kernels do not take)
            fft_shape, packed = _conv_sizes(sa, sb, axes, "plain")
            fwd, inv = _plans(fft_shape, False)
    else:
        fwd, inv = _plans(fft_shape, False)
    za = fwd(_pad_to(a.to(torch.float32), fft_shape))
    zb = fwd(_pad_to(b.to(torch.float32), fft_shape))
    zc = _packed_mul(za, zb, axes[:-1]) if packed else za * zb
    return _slice_mode(inv(zc), sa, sb, axes, mode)


def correlate(a, b, mode: str = "full", axes: Optional[Sequence[int]] = None,
              method: str = "auto", backend: str = "auto", device="cuda"):
    """Cross-correlation via FFT (``scipy.signal.correlate(method='fft')``
    semantics): ``correlate(a, b) = convolve(a, reversed(conj(b)))``,
    sliced on the correlation lattice as scipy does.
    Counterpart: ``regent_fft_tpu/signal.py:211``.
    """
    dev = resolve_device(device)
    a = _tensor(a, dev)
    b = _tensor(b, dev)
    if a.ndim != b.ndim:
        raise ValueError(f"rank mismatch: {a.ndim} vs {b.ndim}")
    axes_t = _conv_axes(a.ndim, axes)
    brev = torch.flip(b, axes_t)
    if b.is_complex():
        brev = brev.conj_physical()
    y = fftconvolve(a, brev, mode="full", axes=axes_t, method=method,
                    backend=backend, device=device)
    if mode == "full":
        return y
    sa, sb = a.shape, b.shape
    idx = []
    for ax in range(a.ndim):
        if ax not in axes_t:
            idx.append(slice(None))
        elif mode == "same":
            start = (sb[ax] - 1) // 2
            idx.append(slice(start, start + sa[ax]))
        elif mode == "valid":
            if sa[ax] < sb[ax]:
                raise ValueError("valid mode needs a no smaller than b "
                                 "on every correlated axis")
            idx.append(slice(sb[ax] - 1, sa[ax]))
        else:
            raise ValueError(f"mode must be full|same|valid, got {mode!r}")
    return y[tuple(idx)]


def oaconvolve(a, b, mode: str = "full", axes: Optional[Sequence[int]] = None,
               method: str = "auto", backend: str = "auto", device="cuda"):
    """Overlap-add convolution (``scipy.signal.oaconvolve`` semantics).

    When one input is much longer than the other along some convolved
    axis, blocks of the long input convolve against the short kernel
    through ONE batched plan (the blocks ride a new leading batch axis)
    and the overlap-add stitches the seams with one pad, reshape and add;
    otherwise this is :func:`fftconvolve`.
    Counterpart: ``regent_fft_tpu/signal.py:254``.
    """
    dev = resolve_device(device)
    a = _tensor(a, dev)
    b = _tensor(b, dev)
    if a.ndim != b.ndim:
        raise ValueError(f"rank mismatch: {a.ndim} vs {b.ndim}")
    axes_t = _conv_axes(a.ndim, axes)
    swapped = False
    if any(a.shape[ax] < b.shape[ax] for ax in axes_t) and \
            all(a.shape[ax] <= b.shape[ax] for ax in axes_t):
        a, b = b, a  # convolution commutes; keep 'a' the long one
        swapped = True
    sa, sb = tuple(a.shape), tuple(b.shape)
    # the blocking axis: the largest long/short ratio
    ratio, ax_s = max((sa[ax] / max(sb[ax], 1), ax) for ax in axes_t)
    k = sb[ax_s]
    if ratio < 8 or k < 2 or sa[ax_s] < 64:
        y = fftconvolve(a, b, mode="full", axes=axes_t, method=method,
                        backend=backend, device=device)
        return _slice_mode(y, sb if swapped else sa,
                           sa if swapped else sb, axes_t, mode)
    # block length: a power-of-two FFT of ~8x the kernel
    fftlen = _next_pow2(8 * k)
    L = fftlen - (k - 1)
    n_long = sa[ax_s]
    nb = -(-n_long // L)
    # the blocking axis last, split into (nb, L) blocks, blocks in front
    am = F.pad(torch.movedim(a, ax_s, -1), (0, nb * L - n_long))
    blocks = torch.movedim(am.reshape(am.shape[:-1] + (nb, L)), -2, 0)
    bm = torch.movedim(b, ax_s, -1)[None]
    bm = bm.expand((nb,) + tuple(bm.shape[1:]))
    # convolve the blocks against the kernel over every convolved axis;
    # the other axes shift by one for the block axis, the blocked one is
    # last
    conv_axes = tuple((ax + 1 if ax < ax_s else ax) for ax in axes_t
                      if ax != ax_s) + (blocks.ndim - 1,)
    yb = fftconvolve(blocks, bm, mode="full", axes=conv_axes, method=method,
                     backend=backend, device=device)   # (nb, ..., L + k - 1)
    # overlap-add along the last axis: body | tail split at L
    body = torch.movedim(yb[..., :L], 0, -2)             # (..., nb, L)
    tail = torch.movedim(yb[..., L:], 0, -2)             # (..., nb, k - 1)
    flat_body = F.pad(body.reshape(body.shape[:-2] + (nb * L,)), (0, L))
    tail_pad = F.pad(tail, (0, L - (k - 1), 1, 0))       # (..., nb+1, L)
    flat = flat_body + tail_pad.reshape(tail_pad.shape[:-2] + ((nb + 1) * L,))
    y = torch.movedim(flat[..., :n_long + k - 1], -1, ax_s)
    return _slice_mode(y, sb if swapped else sa,
                       sa if swapped else sb, axes_t, mode)


def hilbert(x, N: Optional[int] = None, axis: int = -1, device="cuda"):
    """Analytic signal via the FFT (``scipy.signal.hilbert`` semantics):
    ``ifft(fft(x) * h)`` with the one-sided step multiplier ``h`` (DC and
    Nyquist kept, positive frequencies doubled, negative zeroed); one
    forward and one inverse cached C2C plan.  complex64 out.
    Counterpart: ``regent_fft_tpu/signal.py:326``.
    """
    x = _tensor(x, resolve_device(device))
    if x.is_complex():
        raise ValueError("x must be real.")
    axis = axis % x.ndim
    n = x.shape[axis] if N is None else int(N)
    if n <= 0:
        raise ValueError("N must be positive.")
    h = np.zeros(n, np.float32)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    shape = [1] * x.ndim
    shape[axis] = n
    Xf = fft(x.to(torch.float32), n=n, axis=axis, device=device)
    hh = torch.from_numpy(h).to(Xf.device).reshape(shape)
    return ifft(Xf * hh, axis=axis, device=device)


def hilbert2(x, N=None, device="cuda"):
    """2-D analytic signal (``scipy.signal.hilbert2`` semantics): the
    separable one-sided multiplier applied to ``fft2(x)``.
    Counterpart: ``regent_fft_tpu/signal.py:356``."""
    x = _tensor(x, resolve_device(device))
    if x.ndim != 2:
        raise ValueError("x must be 2-D.")
    if x.is_complex():
        raise ValueError("x must be real.")
    if N is None:
        n1, n2 = x.shape
    elif np.isscalar(N):
        n1 = n2 = int(N)
    else:
        n1, n2 = (int(v) for v in N)
    if n1 <= 0 or n2 <= 0:
        raise ValueError("N must be positive.")

    def _h(n):
        # scipy's single-orthant convention: DC kept, strictly positive
        # frequencies doubled, the Nyquist bin (even n) ZEROED, unlike
        # the 1-D hilbert, which keeps it
        h = np.zeros(n, np.float32)
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
        return h

    Xf = fft2(x.to(torch.float32), s=(n1, n2), device=device)
    hh = torch.from_numpy(np.outer(_h(n1), _h(n2))).to(Xf.device)
    return ifft2(Xf * hh, device=device)


def resample(x, num: int, t=None, axis: int = 0, window=None,
             domain: str = "time", device="cuda"):
    """Fourier-method resampling (``scipy.signal.resample`` semantics).

    Real input rides the R2C/C2R plans (half-spectrum resize); complex
    input the C2C plans with the two-sided resize and scipy's Nyquist-bin
    split and merge rules.  Returns ``y`` or ``(y, new_t)``.
    Counterpart: ``regent_fft_tpu/signal.py:388``.
    """
    x = _tensor(x, resolve_device(device))
    num = int(num)
    if num < 1:
        raise ValueError("num must be positive")
    axis = axis % x.ndim
    Nx = x.shape[axis]
    real_input = not x.is_complex()

    if domain == "time":
        Xf = (rfft(x.to(torch.float32), axis=axis, device=device) if real_input
              else fft(x.to(torch.complex64), axis=axis, device=device))
    elif domain == "freq":
        Xf = _single(x)  # already a spectrum (the dtype decides the layout)
    else:
        raise ValueError("domain must be 'time' or 'freq'")

    # optional spectral window (applied over the full-length spectrum)
    if window is not None:
        if callable(window):
            W = np.asarray(window(np.fft.fftfreq(Nx).astype(np.float32)),
                           np.float64)
        elif isinstance(window, (np.ndarray, torch.Tensor)):
            W = np.asarray(window.cpu() if isinstance(window, torch.Tensor)
                           else window, np.float64)
            if W.shape != (Nx,):
                raise ValueError("window must have length Nx")
        else:
            from scipy.signal import get_window as _gw
            W = np.fft.ifftshift(_gw(window, Nx)).astype(np.float64)
        shape = [1] * x.ndim
        if real_input:
            # fold the two-sided window onto the half spectrum
            Wr = W.copy()
            Wr[1:] += Wr[:0:-1]
            Wr[1:] *= 0.5
            W = Wr[:Nx // 2 + 1]
        shape[axis] = len(W)
        Xf = Xf * torch.from_numpy(W.astype(np.float32)).to(
            Xf.device).reshape(shape)

    N = min(num, Nx)
    nyq = N // 2 + 1
    newshape = list(Xf.shape)
    newshape[axis] = num // 2 + 1 if real_input else num
    Y = Xf.new_zeros(newshape)

    def _sl(t, a, b):
        return t.narrow(axis, a, b - a)

    _sl(Y, 0, nyq).copy_(_sl(Xf, 0, nyq))
    if not real_input and N > 2:
        # negative frequencies
        m = N - nyq
        _sl(Y, num - m, num).copy_(_sl(Xf, Nx - m, Nx))

    if N % 2 == 0:
        half = _sl(Y, N // 2, N // 2 + 1)
        if num < Nx:  # downsampling: fold the split Nyquist pair
            if real_input:
                half.mul_(2.0)
            else:
                half.add_(_sl(Xf, Nx - N // 2, Nx - N // 2 + 1))
        elif num > Nx:  # upsampling: split the Nyquist bin
            half.mul_(0.5)
            if not real_input:
                _sl(Y, num - N // 2, num - N // 2 + 1).copy_(half)

    y = (irfft(Y, n=num, axis=axis, device=device) if real_input
         else ifft(Y, axis=axis, device=device))
    y = y * (float(num) / float(Nx))
    if t is None:
        return y
    new_t = np.arange(0, num) * (t[1] - t[0]) * Nx / float(num) + t[0]
    return y, new_t


def _frame_params(nperseg, noverlap, nfft):
    """Counterpart: ``regent_fft_tpu/signal.py:476``."""
    nperseg = int(nperseg)
    if nperseg < 1:
        raise ValueError("nperseg must be positive")
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    return nperseg, noverlap, nfft


def _get_window(window, nperseg) -> np.ndarray:
    """The window in float64 (``scipy.signal.get_window`` for a name).
    Counterpart: ``regent_fft_tpu/signal.py:489``."""
    from scipy.signal import get_window as _gw
    if isinstance(window, (str, tuple)):
        w = _gw(window, nperseg)
    else:
        w = np.asarray(window.cpu() if isinstance(window, torch.Tensor)
                       else window)
        if w.shape != (nperseg,):
            raise ValueError(f"window length {w.shape} != nperseg {nperseg}")
    return w.astype(np.float64)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A host float64 vector rounded to float32 on ``like``'s device."""
    return torch.from_numpy(np.asarray(v, np.float32)).to(like.device)


def stft(x, fs: float = 1.0, window="hann", nperseg: int = 256,
         noverlap: Optional[int] = None, nfft: Optional[int] = None,
         boundary: Optional[str] = "zeros", padded: bool = True,
         axis: int = -1, scaling: str = "spectrum", device="cuda"):
    """Short-time Fourier transform (``scipy.signal.stft`` semantics,
    ``detrend=False, return_onesided=True``).

    The frames are an unfold view times the window, then ONE batched R2C
    plan over every segment.  Returns ``(f, t, Zxx)`` like scipy, ``Zxx``
    complex64 on ``device``, shaped (..., nfreq, nseg).
    Counterpart: ``regent_fft_tpu/signal.py:500``.
    """
    x = _tensor(x, resolve_device(device))
    axis = axis % x.ndim
    nperseg, noverlap, nfft = _frame_params(nperseg, noverlap, nfft)
    win = _get_window(window, nperseg)
    step = nperseg - noverlap

    xm = torch.movedim(x, axis, -1).to(torch.float32)
    n = xm.shape[-1]
    if boundary is not None:
        if boundary != "zeros":
            raise NotImplementedError("boundary: only 'zeros'/None")
        xm = F.pad(xm, (nperseg // 2, nperseg // 2))
        n = xm.shape[-1]
    if padded:
        nseg = max(1, -(-(n - nperseg) // step) + 1)
        total = (nseg - 1) * step + nperseg
        if total > n:
            xm = F.pad(xm, (0, total - n))
            n = total
    nseg = (n - nperseg) // step + 1
    frames = xm.unfold(-1, nperseg, step) * _f32(win, xm)  # (..., nseg, nperseg)
    if nfft > nperseg:
        frames = F.pad(frames, (0, nfft - nperseg))
    z = rfft(frames, axis=-1, device=device)           # (..., nseg, nfft//2+1)
    if scaling == "spectrum":
        z = z * float(np.float32(1.0 / win.sum()))
    elif scaling == "psd":
        z = z * float(np.float32(1.0 / np.sqrt(fs * (win * win).sum())))
    else:
        raise ValueError("scaling must be 'spectrum' or 'psd'")
    # scipy's layout: the frequency axis before time, (..., nfreq, nseg)
    z = z.transpose(-1, -2)
    f = np.arange(nfft // 2 + 1) * (fs / nfft)
    t = np.arange(nseg) * step / fs
    if boundary is None:
        t = (np.arange(nseg) * step + nperseg / 2) / fs
    return f, t, z


def istft(Zxx, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
          noverlap: Optional[int] = None, nfft: Optional[int] = None,
          boundary: bool = True, time_axis: int = -1, freq_axis: int = -2,
          scaling: str = "spectrum", device="cuda"):
    """Inverse STFT (``scipy.signal.istft`` semantics, one-sided input): a
    batched C2R plan over the segments, then the windowed overlap-add with
    the COLA normalisation.  Returns ``(t, x)`` like scipy, ``x`` float32
    on ``device``.  Counterpart: ``regent_fft_tpu/signal.py:568``."""
    z = _tensor(Zxx, resolve_device(device))
    time_axis = time_axis % z.ndim
    freq_axis = freq_axis % z.ndim
    nfreq = z.shape[freq_axis]
    nfft = 2 * (nfreq - 1) if nfft is None else int(nfft)
    nperseg = nfft if nperseg is None else int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    step = nperseg - noverlap
    win = _get_window(window, nperseg)

    # (freq, time) to the trailing axes as (..., nseg, nfreq)
    z = torch.movedim(_single(z), (freq_axis, time_axis), (-1, -2))
    nseg = z.shape[-2]
    segs = irfft(z, n=nfft, axis=-1, device=device)[..., :nperseg]
    if scaling == "spectrum":
        gain = np.float32(win.sum())
    elif scaling == "psd":
        gain = np.float32(np.sqrt(fs * (win * win).sum()))
    else:
        raise ValueError("scaling must be 'spectrum' or 'psd'")
    wsegs = segs * float(gain) * _f32(win, segs)       # (..., nseg, nperseg)

    total = (nseg - 1) * step + nperseg
    lead = tuple(wsegs.shape[:-2])
    # scatter-free overlap-add where step divides nperseg (the common hops,
    # the 50% default among them): each segment as nperseg/step chunks, the
    # j-th chunks of all segments one contiguous slice add; a fixed order
    if nperseg % step == 0:
        q = nperseg // step
        chunks = wsegs.reshape(lead + (nseg, q, step))
        out = wsegs.new_zeros(lead + ((nseg + q - 1) * step,))
        for j in range(q):
            out[..., j * step:(j + nseg) * step] += \
                chunks[..., :, j, :].reshape(lead + (nseg * step,))
        out = out[..., :total]
    else:
        out = wsegs.new_zeros(lead + (total,))
        for i in range(nseg):
            out[..., i * step:i * step + nperseg] += wsegs[..., i, :]
    norm = np.zeros(total)
    for i in range(nseg):
        norm[i * step:i * step + nperseg] += win * win
    norm = np.where(norm > 1e-10, norm, 1.0)
    x = out / _f32(norm, out)
    if boundary:
        x = x[..., nperseg // 2: total - nperseg // 2]
    t = np.arange(x.shape[-1]) / fs
    return t, x
