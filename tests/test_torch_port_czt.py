"""The port's chirp-z transform and zoom FFT (``regent_fft_tpu_torch/_czt.py``)
against scipy.signal in float64 and the JAX package on the CPU, mirroring
``tests/test_czt.py``.

Inputs are made with numpy from a seed, fed to JAX as complex64/float32.
Tolerances: 1e-5 in rel_l2 (the JAX suite's bound; 5e-3 for the off-unit
spiral of |w| = 0.99, as there) against scipy, and against the JAX plan;
the host tables are the JAX package's bit for bit.
"""
import numpy as np
import pytest
import torch
from scipy import signal as ssig

import regent_fft_tpu as R
from regent_fft_tpu import _czt as jczt

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import _czt as tczt
from regent_fft_tpu_torch.ops import factor
from regent_fft_tpu_torch.ops import stockham_kernels as sk

CPU = "cpu"


def _rng(seed):
    return np.random.default_rng(seed)


def _c64(shape, seed):
    r = _rng(seed)
    return (r.standard_normal(shape)
            + 1j * r.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("n,m", [(50, 50), (37, 64), (128, 33)])
def test_czt_default_w(n, m):
    x = _c64(n, n + m)
    got = rt.czt(x, m, device=CPU)
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    assert _rel(got, ssig.czt(x.astype(np.complex128), m)) < 1e-5
    assert _rel(got, np.asarray(R.czt(x, m))) < 1e-5


def test_czt_equals_fft():
    x = _c64(64, 1)
    assert _rel(rt.czt(x, device=CPU), np.fft.fft(x.astype(np.complex128))) < 1e-5


def test_czt_spiral_and_axis():
    n, m = 40, 25
    w = np.exp(-2j * np.pi / 97) * 1.0
    a = np.exp(2j * np.pi * 0.13)
    x = _c64((3, n), 2)
    got = rt.czt(x, m, w, a, axis=1, device=CPU)
    ref = ssig.czt(x.astype(np.complex128), m, w, a, axis=1)
    assert tuple(got.shape) == ref.shape
    assert _rel(got, ref) < 1e-5
    assert _rel(got, np.asarray(R.czt(x, m, w, a, axis=1))) < 1e-5
    xr = _rng(3).standard_normal(n).astype(np.float32)
    assert _rel(rt.czt(xr, m, w, a, device=CPU),
                ssig.czt(xr.astype(np.float64), m, w, a)) < 1e-5
    # a leading axis, through movedim
    xt = np.ascontiguousarray(x.T)
    got0 = rt.czt(xt, m, w, a, axis=0, device=CPU)
    assert _rel(got0, ref.T) < 1e-5
    assert _rel(rt.czt(torch.from_numpy(xt), m, w, a, axis=-2, device=CPU),
                ref.T) < 1e-5


def test_czt_plan_reuse():
    plan = rt.CZT(48, 20, device=CPU)
    x = _c64(48, 4)
    tabs = plan._dev_tabs
    y1 = plan(x)
    y2 = plan(x)
    assert plan._dev_tabs is tabs and torch.equal(y1, y2)
    ref = ssig.CZT(48, 20)(x.astype(np.complex128))
    assert _rel(y1, ref) < 1e-5
    with pytest.raises(ValueError, match="length"):
        plan(np.zeros(47, np.complex64))


@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft(endpoint):
    n, m = 100, 31
    x = _rng(5).standard_normal(n).astype(np.float32)
    got = rt.zoom_fft(x, [0.1, 0.4], m, fs=2, endpoint=endpoint, device=CPU)
    ref = ssig.zoom_fft(x.astype(np.float64), [0.1, 0.4], m, fs=2,
                        endpoint=endpoint)
    assert _rel(got, ref) < 1e-5
    jref = np.asarray(R.zoom_fft(x, [0.1, 0.4], m, fs=2, endpoint=endpoint))
    assert _rel(got, jref) < 1e-5
    z = rt.ZoomFFT(n, [0.1, 0.4], m, fs=2, endpoint=endpoint, device=CPU)
    jz = R.ZoomFFT(n, [0.1, 0.4], m, fs=2, endpoint=endpoint)
    assert (z.n, z.m, z.w, z.a, z._L) == (jz.n, jz.m, jz.w, jz.a, jz._L)
    assert _rel(z(x), ref) < 1e-5


def test_zoom_fft_scalar_fn_matches_fft_prefix():
    x = _rng(6).standard_normal(64).astype(np.float32)
    got = rt.zoom_fft(x, 2, fs=2, device=CPU)
    assert _rel(got, np.fft.fft(x.astype(np.float64))) < 1e-5


def test_czt_overflow_raises_clearly():
    x = _rng(7).standard_normal(80).astype(np.float32)
    with pytest.raises(ValueError, match="overflow"):
        rt.czt(x, 80, w=0.95, device=CPU)
    with pytest.raises(ValueError, match="overflow"):
        R.czt(x, 80, w=0.95)


def test_czt_off_unit_small_spiral():
    n, m, w = 32, 32, 0.99
    x = _c64(n, 8)
    got = rt.czt(x, m, w, device=CPU)
    assert _rel(got, ssig.czt(x.astype(np.complex128), m, w)) < 5e-3


@pytest.mark.parametrize("n,m,w,a", [
    (50, 50, None, 1 + 0j), (37, 64, None, 1 + 0j),
    (40, 25, np.exp(-2j * np.pi / 97), np.exp(2j * np.pi * 0.13)),
    (32, 32, 0.99, 1 + 0j), (1009, 1009, None, 1 + 0j)])
def test_czt_tables_bit_identical(n, m, w, a):
    w = complex(np.exp(-2j * np.pi / m)) if w is None else complex(w)
    L = factor.next_fast_len(n + m - 1)
    ours = tczt._czt_tables(n, m, w, complex(a), L)
    theirs = jczt._czt_tables(n, m, w, complex(a), L)
    for t, j in zip(ours, theirs):
        assert t.dtype == j.dtype == np.float32
        assert np.array_equal(t, j)


def test_czt_length_and_dense_inner(monkeypatch):
    """L = next_fast_len(n + m - 1), the JAX plan's; both inner transforms
    are the dense pipeline (no kernel launch), even where L is a power of
    two."""
    calls = []
    monkeypatch.setattr(sk, "fft_last_plain",
                        lambda *a: calls.append(a) or None)
    for n, m in ((1000, 1000), (1009, 1009), (33, 32)):
        p = rt.CZT(n, m, device=CPU)
        assert p._L == R.CZT(n, m)._L == factor.next_fast_len(n + m - 1)
        p(_c64((2, n), n))
    assert rt.CZT(33, 32, device=CPU)._L == 64
    assert calls == []


def test_czt_cache_keys_on_device(monkeypatch):
    tczt._cached_czt.cache_clear()
    x = _c64(20, 9)
    rt.czt(x, device=CPU)
    rt.czt(torch.from_numpy(x), device="cpu")
    info = tczt._cached_czt.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.czt(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.CZT(20)
