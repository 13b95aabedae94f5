"""The port's FFTLog (``regent_fft_tpu_torch/ops/fftlog.py``) against
``scipy.fft.fht``/``ifht``/``fhtoffset`` in float64 and the JAX package on
the CPU, mirroring ``tests/test_fftlog.py``.

Inputs are made with numpy from a seed and fed to JAX as float32.
Tolerances: 2e-5 in rel_l2 against scipy (2e-4 for the round trip), the
JAX suite's bounds, and 2e-5 against the JAX function; the coefficients
and offsets are the JAX package's exactly.
"""
import warnings

import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.ops import fftlog as jfftlog

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.ops import fftlog as tfftlog
from regent_fft_tpu_torch.ops import stockham_kernels as sk

scipy_fft = pytest.importorskip("scipy.fft")
CPU = "cpu"


def _sample(n):
    r = np.logspace(-3, 3, n)
    return (r ** 1.5 * np.exp(-r ** 2 / 2)).astype(np.float32), r


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("n", [64, 128, 100])
@pytest.mark.parametrize("mu,bias", [(0.0, 0.0), (0.5, 0.0), (2.0, 0.0),
                                     (0.5, 0.1)])
def test_fht_matches_scipy(n, mu, bias):
    a, r = _sample(n)
    dln = float(np.log(r[1] / r[0]))
    offset = float(scipy_fft.fhtoffset(dln, mu, bias=bias))
    got = rt.fht(a, dln, mu, offset=offset, bias=bias, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    ref = scipy_fft.fht(a.astype(np.float64), dln, mu, offset=offset,
                        bias=bias)
    assert _rel(got, ref) < 2e-5
    jref = np.asarray(R.fht(a, dln, mu, offset=offset, bias=bias))
    assert _rel(got, jref) < 2e-5


@pytest.mark.parametrize("mu", [0.0, 0.5])
def test_ifht_roundtrip(mu):
    n = 128
    a, r = _sample(n)
    dln = float(np.log(r[1] / r[0]))
    offset = float(rt.fhtoffset(dln, mu))
    A = rt.fht(a, dln, mu, offset=offset, device=CPU)
    back = rt.ifht(A, dln, mu, offset=offset, device=CPU)
    assert _rel(back, a) < 2e-4


@pytest.mark.parametrize("bias", [0.0, -0.5])
def test_ifht_matches_scipy(bias):
    n = 64
    a, r = _sample(n)
    dln = float(np.log(r[1] / r[0]))
    mu = 1.0
    offset = float(scipy_fft.fhtoffset(dln, mu, bias=bias))
    got = rt.ifht(a, dln, mu, offset=offset, bias=bias, device=CPU)
    ref = scipy_fft.ifht(a.astype(np.float64), dln, mu, offset=offset,
                         bias=bias)
    assert _rel(got, ref) < 2e-5
    jref = np.asarray(R.ifht(a, dln, mu, offset=offset, bias=bias))
    assert _rel(got, jref) < 2e-5


def test_fhtoffset_matches_scipy():
    for dln, mu, bias in [(0.1, 0.0, 0.0), (0.05, 2.5, 0.2), (0.2, -0.5, 0.0)]:
        got = rt.fhtoffset(dln, mu, bias=bias)
        ref = scipy_fft.fhtoffset(dln, mu, bias=bias)
        assert abs(got - float(ref)) < 1e-12
        assert got == R.fhtoffset(dln, mu, bias=bias)


def test_fht_batched():
    n = 128
    a, r = _sample(n)
    dln = float(np.log(r[1] / r[0]))
    batch = np.stack([a, 2 * a, a ** 2])
    got = rt.fht(torch.from_numpy(batch), dln, 0.5, device=CPU)
    assert tuple(got.shape) == batch.shape
    for i in range(3):
        ref = scipy_fft.fht(batch[i].astype(np.float64), dln, 0.5)
        assert _rel(got[i], ref) < 2e-5


@pytest.mark.parametrize("n,dln,mu,offset,bias,inverse", [
    (64, 0.2, 0.0, 0.0, 0.0, False), (100, 0.1, 0.5, 0.3, 0.1, True),
    (128, 0.05, 2.0, -0.2, -0.5, False), (65, 0.1, -1.0, 0.0, 0.0, False),
    (64, 0.1, -1.0, 0.0, 0.0, True), (32, 0.1, 0.5, 0.0, 1.5, False),
    (32, 0.1, 0.5, 0.0, -1.5, True)])
def test_fhtcoeff_equals_jax(n, dln, mu, offset, bias, inverse):
    """The coefficients, the Gamma-pole limit (poch) and the singular
    warnings are the JAX package's."""
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        u = tfftlog._fhtcoeff(n, dln, mu, offset, bias, inverse)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        j = jfftlog._fhtcoeff(n, dln, mu, offset, bias, inverse)
    assert np.array_equal(u, j, equal_nan=True)
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]


def test_singular_transform_warns_every_call():
    """mu = -1.5, bias 0.5 puts a Gamma pole at xp = 0: the forward
    transform warns and zeroes u_0, on every call though the tables are
    cached."""
    n = 64
    a, r = _sample(n)
    dln = float(np.log(r[1] / r[0]))
    for _ in range(2):
        with pytest.warns(UserWarning, match="singular transform"):
            y = rt.fht(a, dln, -1.5, bias=0.5, device=CPU)
        assert bool(torch.isfinite(y).all())
    with pytest.warns(UserWarning, match="singular transform"):
        R.fht(a, dln, -1.5, bias=0.5)


def test_coefficients_uploaded_once(monkeypatch):
    tfftlog._tables.cache_clear()
    a, r = _sample(64)
    dln = float(np.log(r[1] / r[0]))
    for _ in range(3):
        rt.fht(a, dln, 0.5, bias=0.1, device=CPU)
        rt.ifht(a, dln, 0.5, bias=0.1, device=CPU)
    info = tfftlog._tables.cache_info()
    assert (info.misses, info.hits) == (2, 4)


def test_fht_runs_the_real_kernels_route(monkeypatch):
    """On the card fht's rfft takes ``fft_last_r2c`` and its irfft the
    half-length C2R route on ``fft_last`` (n/2): here the same plans with
    the card's backend run both kernels' plain versions once each."""
    from regent_fft_tpu_torch import api
    n, b = 1024, 4
    for name in ("rfft", "irfft"):
        real = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _f=real, **k: _f(
            *a, backend="hybrid", **k))
    calls = []
    for name in ("fft_last_plain", "fft_last_r2c_plain"):
        plain = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *a, _n=name, _f=plain, **k: (
            calls.append((_n, tuple(a[0].shape))) or _f(*a, **k)))
    a, r = _sample(n)
    dln = float(np.log(r[1] / r[0]))
    y = rt.fht(np.stack([a] * b), dln, 0.5, device=CPU)
    assert sorted(calls) == [("fft_last_plain", (b, n // 2)),
                             ("fft_last_r2c_plain", (b, n))]
    ref = scipy_fft.fht(a.astype(np.float64), dln, 0.5)
    for i in range(b):
        assert _rel(y[i], ref) < 2e-5


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, r = _sample(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.fht(a, 0.1, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.ifht(a, 0.1, 0.5)


def test_biased_ifht_float32_floor_is_the_reference_s(monkeypatch):
    """Power-law spectra over eight decades with bias -0.5: the float32
    FFTs' roundoff, amplified up to e^4.6 by the bias post-multiplier at
    the grid's small-r end, puts the biased ifht above 2e-5 against scipy
    in float64 (3.7e-5 to 5.5e-5 on these rows), in both packages alike
    (roundoff, so their errors differ row by row); the same pipeline with
    float64 FFTs reads below 2e-5.  A reference
    behaviour (ROADMAP Queue 3), not a port fault."""
    from regent_fft_tpu_torch import api
    r = np.logspace(-4, 4, 1024)
    dln = float(np.log(r[1] / r[0]))
    slope = 1.0 + 0.5 * np.random.default_rng(0).random((8, 1))
    a = (r ** slope / (1 + r ** 2) ** 1.5).astype(np.float32)
    offset = rt.fhtoffset(dln, 0.5, bias=-0.5)
    ref = scipy_fft.ifht(a.astype(np.float64), dln, 0.5, offset=offset,
                         bias=-0.5)
    ours = _rel(rt.ifht(a, dln, 0.5, offset=offset, bias=-0.5, device=CPU), ref)
    theirs = _rel(R.ifht(a, dln, 0.5, offset=offset, bias=-0.5), ref)
    assert ours > 2e-5 and theirs > 2e-5
    assert _rel(rt.fht(a, dln, 0.5, offset=offset, bias=-0.5, device=CPU),
                scipy_fft.fht(a.astype(np.float64), dln, 0.5, offset=offset,
                              bias=-0.5)) < 2e-5
    monkeypatch.setattr(api, "rfft", lambda x, **k: torch.fft.rfft(x.double()))
    monkeypatch.setattr(api, "irfft", lambda x, n=None, **k: torch.fft.irfft(x, n))
    assert _rel(rt.ifht(a, dln, 0.5, offset=offset, bias=-0.5, device=CPU),
                ref) < 2e-5


def test_chip_power_law_readings_are_the_references():
    """``chip_smoke.py`` holds its power-law FFTLog groups to 2e-5, or to
    ``REFERENCE_MARGIN`` times the JAX package's rel_l2 on the same rows
    where that is larger.  Those readings (``POWER_LAW_JAX_ERR``) are the
    JAX package's on these rows (within 1 %), and the port on the host
    holds the same bounds there."""
    import chip_smoke
    dln, a = chip_smoke.power_law_spectra()
    for (name, bias), want in chip_smoke.POWER_LAW_JAX_ERR.items():
        offset = R.fhtoffset(dln, 0.5, bias=bias)
        ref = getattr(scipy_fft, name)(a.astype(np.float64), dln, 0.5,
                                       offset=offset, bias=bias)
        theirs = _rel(getattr(R, name)(a, dln, 0.5, offset=offset,
                                       bias=bias), ref)
        assert theirs == pytest.approx(want, rel=0.01), (name, bias)
        ours = _rel(getattr(rt, name)(a, dln, 0.5, offset=offset, bias=bias,
                                      device=CPU), ref)
        assert ours <= max(2e-5, chip_smoke.REFERENCE_MARGIN * want), (
            name, bias, ours)
