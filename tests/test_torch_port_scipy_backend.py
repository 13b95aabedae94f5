"""The port's scipy.fft backend (``regent_fft_tpu_torch.scipy_backend``)
driving real ``scipy.fft`` calls on the CPU (``backend("cpu")``), against
scipy's own pocketfft in float64 and the JAX package's backend
(``RegentFFTBackend`` of ``regent_fft_tpu.scipy_backend``) on the same
numpy inputs, mirroring every test of ``tests/test_scipy_backend.py`` at
its bounds (``_rel``: 1e-5, 1e-4 for the Hermitian, r2r and FFTLog rows).

Float64 input computes in float64 on the port's f64 route (1e-12 against
scipy); the JAX backend computes it in float32.  Also: no fallback hides
the card or a failure: with no CUDA device the card's backend raises, and
so does an error raised while a plan runs; only arguments refused before
anything runs go to pocketfft.  Every ``enable()`` is undone by
``disable()`` in a ``finally``.
"""
import numpy as np
import pytest
import scipy.fft as sfft
import torch

from regent_fft_tpu.scipy_backend import RegentFFTBackend as JAXBackend

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch import scipy_backend
from regent_fft_tpu_torch import signal
from regent_fft_tpu_torch.ops import factor

CPU = scipy_backend.backend("cpu")


def _rel(got, ref):
    got = np.asarray(got, dtype=np.complex128)
    ref = np.asarray(ref, dtype=np.complex128)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _c64(shape, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape)
            + 1j * r.standard_normal(shape)).astype(np.complex64)


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(fn, args, kw=None, tol=1e-5, ref=None):
    """``scipy.fft.fn`` under the port's CPU backend and under the JAX
    one, each against pocketfft in float64 (``ref`` when given); returns
    the port's."""
    kw = kw or {}
    if ref is None:
        wide = [a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
                if isinstance(a, np.ndarray) else a for a in args]
        ref = getattr(sfft, fn)(*wide, **kw)
    with sfft.set_backend(CPU):
        ours = getattr(sfft, fn)(*args, **kw)
    with sfft.set_backend(JAXBackend):
        theirs = getattr(sfft, fn)(*args, **kw)
    assert isinstance(ours, np.ndarray)
    assert ours.shape == ref.shape == theirs.shape, fn
    assert ours.dtype == theirs.dtype, fn
    assert _rel(ours, ref) < tol, fn
    assert _rel(theirs, ref) < tol, fn
    return ours


# ---------------------------------------------------------------------------
# complex family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["fft", "ifft"])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_fft_ifft_match_scipy(fn, norm):
    got = _both(fn, (_c64((4, 96), 1),), {"norm": norm})
    assert got.dtype == np.complex64


@pytest.mark.parametrize("fn", ["fft2", "ifft2", "fftn", "ifftn"])
def test_nd_complex_match_scipy(fn):
    _both(fn, (_c64((3, 16, 32), 2),))


def test_fft_n_and_axis_kwargs():
    got = _both("fft", (_c64((5, 40), 3),), {"n": 64, "axis": -1})
    assert got.shape == (5, 64)


# ---------------------------------------------------------------------------
# real family
# ---------------------------------------------------------------------------
def test_rfft_irfft_roundtrip_and_values():
    x = _f32((6, 64), 4)
    got = _both("rfft", (x,))
    assert got.dtype == np.complex64
    with sfft.set_backend(CPU):
        back = sfft.irfft(got, n=64)
    assert back.dtype == np.float32
    assert _rel(back, x) < 1e-5


def test_rfftn_hfft_match_scipy():
    _both("rfftn", (_f32((4, 16, 32), 5),))
    _both("hfft", (_c64((4, 33), 6),), tol=1e-4)


# ---------------------------------------------------------------------------
# r2r family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["dct", "idct", "dst", "idst"])
@pytest.mark.parametrize("typ", [1, 2, 3, 4])
def test_r2r_1d_match_scipy(fn, typ):
    got = _both(fn, (_f32((3, 24), 7),), {"type": typ}, tol=1e-4)
    assert got.dtype == np.float32


def test_r2r_nd_match_scipy():
    _both("dctn", (_f32((2, 12, 16), 8),), {"type": 2}, tol=1e-4)


# ---------------------------------------------------------------------------
# dtype contract: the input's precision class is kept
# ---------------------------------------------------------------------------
def test_f64_in_c128_out():
    x = np.random.default_rng(9).standard_normal((4, 32))
    assert x.dtype == np.float64
    for fn in ("fft", "rfft"):
        got = _both(fn, (x,))
        assert got.dtype == np.complex128
        # the port computes float64 data in float64
        assert _rel(got, getattr(sfft, fn)(x)) < 1e-12


def test_irfft_f64_in_f64_out():
    r = np.random.default_rng(10)
    x = r.standard_normal((2, 33)) + 1j * r.standard_normal((2, 33))
    got = _both("irfft", (x,))
    assert got.dtype == np.float64
    assert _rel(got, sfft.irfft(x)) < 1e-12


# ---------------------------------------------------------------------------
# fallback contract
# ---------------------------------------------------------------------------
def test_declined_args_still_behave_like_scipy():
    # an invalid norm is declined; scipy's own backend then raises its
    # usual error
    x = _f32((4, 20), 11).astype(np.complex64)
    for b in (CPU, JAXBackend):
        with sfft.set_backend(b):
            with pytest.raises(ValueError):
                sfft.fft(x, norm="bogus")


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("orth", [None, True, False])
def test_r2r_norm_orthogonalize_through_backend(norm, orth):
    x = _f32((3, 20), 12)
    for fn in ("dct", "idct", "dst", "idst"):
        got = _both(fn, (x,), {"type": 2, "norm": norm,
                               "orthogonalize": orth}, tol=1e-4)
        assert got.dtype == np.float32, fn


def test_hermitian_nd_through_backend():
    z = _c64((3, 8, 9), 13)
    xr = _f32((3, 8, 16), 14)
    for fn, arg in (("hfft2", z), ("hfftn", z),
                    ("ihfft2", xr), ("ihfftn", xr)):
        _both(fn, (arg,), tol=1e-4)


def _dispatches_via_uarray(fn) -> bool:
    # scipy >= 1.17 made the fast_len helpers plain lru_cache functions
    # (no uarray dispatch); older scipys expose multimethods
    return hasattr(fn, "_extractor") or type(fn).__module__.startswith("uarray")


@pytest.mark.parametrize("which", ["prev_fast_len", "next_fast_len"])
def test_fast_len_is_engine_specific(which):
    got = scipy_backend.RegentFFTBackend.__ua_function__(
        getattr(sfft, which), (1009,), {})
    assert got == JAXBackend.__ua_function__(getattr(sfft, which), (1009,),
                                             {})
    assert got == getattr(factor, which)(1009)
    assert isinstance(got, int)
    assert got <= 1009 if which == "prev_fast_len" else got >= 1009
    if _dispatches_via_uarray(getattr(sfft, which)):
        with sfft.set_backend(CPU):
            assert getattr(sfft, which)(1009) == got


def test_fht_matches_scipy():
    a = _f32(64, 15).astype(np.float64)
    got = _both("fht", (a, 0.1, 0.5), tol=1e-4)
    assert got.dtype == np.float64
    _both("ifht", (a, 0.1, 0.5), tol=1e-4)


def test_global_enable_disable_roundtrip():
    x = _c64((2, 32), 16)
    ref = sfft.fft(x.astype(np.complex128))
    scipy_backend.enable(device="cpu")
    try:
        got = sfft.fft(x)
        assert _rel(got, ref) < 1e-5
    finally:
        scipy_backend.disable()
    assert any(p.spec.shape == (2, 32) and p.spec.device == "cpu"
               for p in rt.cached_plans())
    # after disable, scipy's own backend answers again
    assert _rel(sfft.fft(x), ref) < 1e-5


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------
def test_one_backend_object_per_device():
    assert scipy_backend.backend("cpu") is CPU
    assert scipy_backend.backend("cuda") is scipy_backend.RegentFFTBackend
    assert CPU.device == "cpu" and CPU.__ua_domain__ == "numpy.scipy.fft"


def test_tensor_in_tensor_out():
    x = torch.from_numpy(_c64((4, 64), 17))
    with sfft.set_backend(CPU, only=True):
        y = sfft.fft(x)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.complex64
    assert _rel(y.numpy(), np.fft.fft(x.numpy().astype(np.complex128))) < 1e-5


def test_card_backend_raises_without_a_card(monkeypatch):
    """No CUDA device: the card's backend and device='cuda' entries raise;
    pocketfft does not answer in their place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _c64((4, 64), 18)
    with sfft.set_backend(scipy_backend.RegentFFTBackend):
        for call in (lambda: sfft.fft(x), lambda: sfft.rfftn(x.real),
                     lambda: sfft.dctn(x.real), lambda: sfft.fht(
                         x.real[0].astype(np.float64), 0.1, 0.5)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    scipy_backend.enable()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sfft.ifft(x)
    finally:
        scipy_backend.disable()
    for call in (lambda: signal.fftconvolve(x.real, x.real[:, :9]),
                 lambda: signal.stft(x.real),
                 lambda: rt.welch(x.real)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_errors_while_running_propagate(monkeypatch):
    """An error raised by a plan as it runs is not answered by pocketfft,
    even a ValueError or TypeError (the refusals that decline)."""
    x = _c64((4, 64), 19)
    for exc in (ValueError, TypeError, RuntimeError):
        def broken(self, *a, exc=exc, **k):
            raise exc("plan failed")
        monkeypatch.setattr(tplan.Plan, "__call__", broken)
        with sfft.set_backend(CPU):
            with pytest.raises(exc, match="plan failed"):
                sfft.fft(x)
        monkeypatch.undo()


def test_refusals_decline_and_warn_once(recwarn):
    b = scipy_backend._Backend("cpu")  # a fresh one: nothing warned yet
    assert b.__ua_function__(sfft.fft, (np.zeros(8),), {"plan": 1}) \
        is NotImplemented
    assert b.__ua_function__(sfft.fft, (np.zeros(8),), {"norm": "x"}) \
        is NotImplemented
    assert not recwarn.list
    assert b.__ua_function__(sfft.rfft, (np.zeros(8, np.complex64),), {}) \
        is NotImplemented
    assert b.__ua_function__(sfft.rfft, (np.zeros(8, np.complex64),), {}) \
        is NotImplemented
    assert b.__ua_function__(sfft.dct, (np.zeros(8),), {"type": 5}) \
        is NotImplemented
    msgs = [str(w.message) for w in recwarn.list]
    assert len(msgs) == 2 and ": rfft()" in msgs[0] and ": dct()" in msgs[1]
    assert all(w.category is RuntimeWarning for w in recwarn.list)
    assert b.__ua_function__(sfft.fftfreq, (8,), {}) is NotImplemented
