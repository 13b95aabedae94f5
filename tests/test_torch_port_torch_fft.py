"""The port's ``torch.fft`` namespace (``regent_fft_tpu_torch.torch_fft``)
on CPU tensors against ``torch.fft`` itself and the JAX package's adapter
(``regent_fft_tpu.torch_fft``), mirroring every test of
``tests/test_torch_fft.py`` at its bound (``_agree``: 2e-5 in rel_l2, the
same dtype and shape).

The port computes float64 input in float64, so its f64 rows also meet
1e-12; the JAX adapter computes them in float32 (1e-5, its own bound).
Also: with every ``torch.fft`` function patched to raise, each entry of
the four modules of this slice still runs on the CPU, so none of them
reaches ``torch.fft``.
"""
import numpy as np
import pytest
import torch

from regent_fft_tpu import torch_fft as jfft

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import scipy_backend, signal, spectral
from regent_fft_tpu_torch import torch_fft as tfft


def _agree(ours, ref, tol=2e-5):
    """tests/test_torch_fft.py:_agree."""
    ours = ours.resolve_conj().numpy()
    ref = ref.resolve_conj().numpy()
    assert ours.shape == ref.shape
    assert ours.dtype == ref.dtype
    denom = max(np.linalg.norm(ref), 1e-30)
    assert np.linalg.norm(ours - ref) / denom < tol


def _trio(name, x, tol=2e-5, **kw):
    ref = getattr(torch.fft, name)(x, **kw)
    ours = getattr(tfft, name)(x, **kw)
    assert ours.device == x.device
    _agree(ours, ref, tol)
    _agree(getattr(jfft, name)(x, **kw), ref, tol)
    _agree(ours, getattr(jfft, name)(x, **kw), 2 * tol)
    return ours


def _randn(*shape, dtype=torch.float32, seed=0):
    return torch.randn(*shape, dtype=dtype,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name,kw", [
    ("fft", {}), ("ifft", {}), ("fft", {"n": 20}), ("fft", {"n": 12}),
    ("fft", {"norm": "ortho"}), ("ifft", {"norm": "forward"}),
    ("rfft", {}), ("ihfft", {}),
])
def test_1d_complex_input_free(name, kw):
    _trio(name, _randn(3, 16, seed=1), **kw)


@pytest.mark.parametrize("name,kw", [
    ("fft", {"dim": 0}), ("ifft", {"dim": -2}),
])
def test_1d_complex_over_dims(name, kw):
    _trio(name, _randn(8, 16, dtype=torch.complex64, seed=2), **kw)


@pytest.mark.parametrize("name,kw", [
    ("irfft", {}), ("irfft", {"n": 16}), ("hfft", {}),
])
def test_1d_real_output(name, kw):
    _trio(name, _randn(3, 9, dtype=torch.complex64, seed=3), **kw)


@pytest.mark.parametrize("name", ["fft2", "ifft2", "rfft2", "ihfft2"])
def test_2d(name):
    _trio(name, _randn(2, 12, 16, seed=4))


@pytest.mark.parametrize("name,kw", [
    ("fftn", {}), ("ifftn", {"norm": "ortho"}),
    ("fftn", {"dim": (0, 2)}), ("rfftn", {}), ("ihfftn", {}),
    ("fftn", {"s": (4, 8, 8)}),
])
def test_nd(name, kw):
    _trio(name, _randn(4, 6, 8, seed=5), **kw)


@pytest.mark.parametrize("name", ["irfft2", "irfftn", "hfft2", "hfftn"])
def test_nd_real_output(name):
    _trio(name, _randn(4, 6, 5, dtype=torch.complex64, seed=6))


def test_dtype_promotion_matches_torch():
    for dt in (torch.float32, torch.float64, torch.int32, torch.bool):
        x = (_randn(8, seed=7) > 0).to(dt) if dt is torch.bool else \
            torch.arange(8).to(dt)
        ref = torch.fft.fft(x)
        assert tfft.fft(x).dtype == jfft.fft(x).dtype == ref.dtype
    # the f64 class is kept; the port computes it in float64
    x = _randn(16, dtype=torch.float64, seed=8)
    _agree(tfft.fft(x), torch.fft.fft(x), tol=1e-12)
    _agree(jfft.fft(x), torch.fft.fft(x), tol=1e-5)
    z = _randn(4, 9, dtype=torch.complex128, seed=9)
    _agree(tfft.irfft(z), torch.fft.irfft(z), tol=1e-12)


def test_device_and_autograd_detach():
    x = _randn(16, seed=10).requires_grad_(True)
    for mod in (tfft, jfft):
        y = mod.fft(x)
        assert not y.requires_grad  # an inference-path adapter
        assert y.device == x.device


def test_helpers():
    x = _randn(4, 6, seed=11)
    for mod in (tfft, jfft):
        _agree(mod.fftshift(x), torch.fft.fftshift(x))
        _agree(mod.ifftshift(x, dim=1), torch.fft.ifftshift(x, dim=1))
        _agree(mod.fftfreq(10, d=0.5), torch.fft.fftfreq(10, d=0.5))
        _agree(mod.rfftfreq(9), torch.fft.rfftfreq(9))
    f = tfft.fftfreq(8, dtype=torch.float64, requires_grad=True)
    assert f.dtype == torch.float64 and f.requires_grad


def test_namespace_complete():
    ours = set(dir(tfft))
    theirs = {n for n in dir(torch.fft) if not n.startswith("_")
              and n not in ("torch", "Tensor", "common_args",
                            "factory_common_args")}
    assert theirs <= ours, theirs - ours
    assert set(tfft.__all__) == set(jfft.__all__)
    for n in tfft.__all__:
        assert callable(getattr(tfft, n)), n


def test_half_precision_inputs():
    """bf16/f16 tensors widen to f32 and give complex64, as in the JAX
    adapter; complex32 widens to complex64."""
    for dt in (torch.bfloat16, torch.float16):
        x = _randn(16, seed=12).to(dt)
        y = tfft.fft(x)
        assert y.dtype == jfft.fft(x).dtype == torch.complex64
        ref = torch.fft.fft(x.to(torch.float32))
        _agree(y, ref, tol=5e-2)        # the half-precision data
        _agree(y, ref, tol=2e-5)        # the widened data, computed in f32
    z = _randn(16, dtype=torch.complex64, seed=13).to(torch.complex32)
    assert tfft.fft(z).dtype == torch.complex64


def test_out_is_refused():
    x = _randn(8, seed=14)
    with pytest.raises(NotImplementedError):
        tfft.fft(x, out=torch.empty(8, dtype=torch.complex64))
    with pytest.raises(NotImplementedError):
        tfft.fftn(x, out=torch.empty(8, dtype=torch.complex64))


def test_nothing_of_the_slice_reaches_torch_fft(monkeypatch):
    """With every torch.fft function raising, each entry of signal,
    spectral, torch_fft and scipy_backend still runs on the CPU."""
    import scipy.fft as sfft
    x = _randn(2, 600, seed=15)
    xc = _randn(2, 600, dtype=torch.complex64, seed=16)
    z = tfft.rfft(x)
    ref = {"stft": signal.stft(x, nperseg=64, device="cpu")[2]}

    def boom(*a, **k):
        raise AssertionError("torch.fft reached")

    for name in dir(torch.fft):
        if not name.startswith("_") and callable(getattr(torch.fft, name)) \
                and name not in ("Tensor",):
            monkeypatch.setattr(torch.fft, name, boom)
    cpu = {"device": "cpu"}
    for call in (
            lambda: signal.fftconvolve(x, x[:, :30], axes=(1,), **cpu),
            lambda: signal.fftconvolve(xc, xc[:, :30], axes=(1,), **cpu),
            lambda: signal.fftconvolve(x[:, :200], x[:, :50],
                                       method="packed", backend="stockham",
                                       **cpu),
            lambda: signal.correlate(x, x[:, :30], axes=(1,), **cpu),
            lambda: signal.oaconvolve(x, x[:, :20], axes=(1,), **cpu),
            lambda: signal.hilbert(x, **cpu),
            lambda: signal.hilbert2(x, **cpu),
            lambda: signal.resample(x, 300, axis=1, **cpu),
            lambda: signal.resample(xc, 900, axis=1, **cpu),
            lambda: signal.istft(ref["stft"], nperseg=64, **cpu),
            lambda: spectral.welch(x, nperseg=128, average="median", **cpu),
            lambda: spectral.csd(x, x.flip(0), nperseg=128, **cpu),
            lambda: spectral.coherence(x, x.flip(0), nperseg=128, **cpu),
            lambda: spectral.periodogram(x, **cpu),
            lambda: spectral.spectrogram(x, nperseg=128, mode="complex",
                                         **cpu)):
        out = call()
        out = out[-1] if isinstance(out, tuple) else out
        assert torch.isfinite(out.abs()).all()
    for name in tfft.__all__:
        if name.startswith(("fft", "ifft")) and "freq" not in name \
                and "shift" not in name:
            getattr(tfft, name)(xc)
        elif name.startswith(("rfft", "ihfft")) and "freq" not in name:
            getattr(tfft, name)(x)
        elif name.startswith(("irfft", "hfft")):
            getattr(tfft, name)(z)
        else:
            getattr(tfft, name)(8) if "freq" in name else \
                getattr(tfft, name)(x)
    with sfft.set_backend(scipy_backend.backend("cpu"), only=True):
        xn = x.numpy()
        for fn in ("fft", "ifft", "fft2", "fftn", "rfft", "irfft", "rfftn",
                   "hfft", "ihfft", "dct", "idst", "dctn"):
            assert np.isfinite(getattr(sfft, fn)(xn)).all(), fn
        assert np.isfinite(sfft.fht(xn[0], 0.1, 0.5)).all()
    assert rt.cached_plans()
