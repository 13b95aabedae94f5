"""The port's ``signal.py`` (``regent_fft_tpu_torch.signal``) against
scipy.signal in float64 and the JAX package's ``regent_fft_tpu.signal`` on
the CPU, mirroring every test of ``tests/test_signal.py``.

The same numpy-seeded inputs go to both packages.  Bounds are the JAX
suite's: ``_check``'s 2e-4 of max|ref| (1e-4 for the STFT rows), each
package against scipy and the port against the JAX package.  The packed
path runs with ``backend="stockham"`` on both sides (the JAX kernels in
interpret mode, the port's plain versions).  Also: ``_conv_sizes`` and the
route chosen (packed or plain) equal the JAX package's over a sweep, and
the packed plans print the JAX plans' step lines.
"""
import numpy as np
import pytest
import torch
from scipy import signal as ssig

import regent_fft_tpu as R
from regent_fft_tpu import signal as J
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import signal as T

CPU = "cpu"


def _np(y):
    """Either package's output as numpy (complex128 for complex data)."""
    if isinstance(y, torch.Tensor):
        y = y.resolve_conj().numpy()
        return y.astype(np.complex128) if np.iscomplexobj(y) else y
    y = np.asarray(y)
    return to_numpy_complex(y) if np.iscomplexobj(y) else y


def _check(got, ref, tol=2e-4):
    """tests/test_signal.py:_check's bound."""
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-6)
    assert np.allclose(got, ref, rtol=tol, atol=tol * scale), \
        np.abs(got - ref).max() / scale


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _c64(shape, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape)
            + 1j * r.standard_normal(shape)).astype(np.complex64)


def _f64(x):
    return x if np.iscomplexobj(x) else x.astype(np.float64)


def _both(name, args, ref, tol=2e-4, **kw):
    """The port's and the JAX package's ``name`` on the same inputs, each
    held against ``ref`` and against each other; returns the port's."""
    ours = getattr(T, name)(*args, device=CPU, **kw)
    theirs = getattr(J, name)(*args, **kw)
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    _check(ours, ref, tol)
    _check(theirs, ref, tol)
    _check(ours, _np(theirs), tol)
    return ours


def _conv(a, b, **kw):
    skw = {k: v for k, v in kw.items() if k in ("mode", "axes")}
    ref = ssig.fftconvolve(_f64(a), _f64(b), **skw)
    return _both("fftconvolve", (a, b), ref, **kw)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_1d_real(mode):
    y = _conv(_f32(200, 1), _f32(31, 2), mode=mode)
    assert y.dtype == torch.float32


def test_fftconvolve_2d_real_plain():
    _conv(_f32((40, 50), 3), _f32((7, 9), 4), mode="same")


def test_fftconvolve_packed_path():
    # sizes rounding to (256, 256): the packed path with the lane-0 fixup
    a, b = _f32((200, 220), 5), _f32((50, 30), 6)
    _conv(a, b, mode="full", method="packed", backend="stockham")
    # the same problem through the plain path agrees with scipy
    _conv(a, b, mode="full", method="plain")


def test_fftconvolve_complex():
    y = _conv(_c64((30, 40), 7), _c64((5, 6), 8), mode="full")
    assert y.dtype == torch.complex64


def test_fftconvolve_axes_subset():
    # batch axis 0 not convolved
    _conv(_f32((3, 64, 64), 9), _f32((3, 9, 9), 10), mode="same",
          axes=(1, 2))


def test_fftconvolve_validation():
    a = np.zeros((4, 8), np.float32)
    b = np.zeros((9, 8), np.float32)
    for fn in (T.fftconvolve, J.fftconvolve):
        kw = {"device": CPU} if fn is T.fftconvolve else {}
        with pytest.raises(ValueError, match="valid mode"):
            fn(a, b, mode="valid", **kw)
        with pytest.raises(ValueError, match="rank"):
            fn(np.zeros(4, np.float32), np.zeros((2, 2), np.float32), **kw)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlate_real(mode):
    a, b = _f32((40, 50), 11), _f32((7, 10), 12)
    ref = ssig.correlate(_f64(a), _f64(b), mode=mode, method="fft")
    _both("correlate", (a, b), ref, mode=mode)


def test_correlate_complex_conjugation():
    a, b = _c64(64, 13), _c64(16, 14)
    ref = ssig.correlate(a.astype(np.complex128), b.astype(np.complex128),
                         mode="full", method="fft")
    _both("correlate", (a, b), ref, mode="full")


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_oaconvolve_1d(mode):
    a, b = _f32(3000, 15), _f32(25, 16)
    ref = ssig.oaconvolve(_f64(a), _f64(b), mode=mode)
    _both("oaconvolve", (a, b), ref, mode=mode)


def test_oaconvolve_2d_and_swap():
    a, b = _f32((8, 2000), 17), _f32((8, 17), 18)
    ref = ssig.oaconvolve(_f64(a), _f64(b), mode="same", axes=1)
    _both("oaconvolve", (a, b), ref, mode="same", axes=(1,))
    # swapped argument order (short first) commutes
    ref2 = ssig.oaconvolve(_f64(b), _f64(a), mode="full", axes=1)
    _both("oaconvolve", (b, a), ref2, mode="full", axes=(1,))


def test_oaconvolve_fallback_similar_sizes():
    a, b = _f32((64, 64), 19), _f32((60, 60), 20)
    _both("oaconvolve", (a, b), ssig.oaconvolve(_f64(a), _f64(b)),
          mode="full")


def test_oaconvolve_2d_blocked_plus_full_axis():
    a, b = _f32((30, 1500), 21), _f32((5, 11), 22)
    _both("oaconvolve", (a, b), ssig.oaconvolve(_f64(a), _f64(b)),
          mode="full")


STFT_KW = [
    dict(),
    dict(nperseg=128, noverlap=96),
    dict(window="hamming", nperseg=64, nfft=128),
    dict(boundary=None, padded=False, nperseg=64),
    dict(scaling="psd", fs=10.0, nperseg=64),
]


def _stft_trio(x, **kw):
    f, t, z = T.stft(x, device=CPU, **kw)
    fj, tj, zj = J.stft(x, **kw)
    fr, tr, zr = ssig.stft(_f64(x), detrend=False, **kw)
    for ff, tt in ((f, t), (fj, tj)):
        assert np.allclose(ff, fr) and np.allclose(tt, tr)
    assert z.dtype == torch.complex64
    for zz in (z, zj):
        _check(zz, zr, 1e-4)
    _check(z, _np(zj), 1e-4)
    return z


@pytest.mark.parametrize("kw", STFT_KW)
def test_stft_matches_scipy(kw):
    _stft_trio(_f32(1000, 23), **kw)


def test_stft_batched_axis():
    _stft_trio(_f32((3, 777), 24), nperseg=64, axis=1)


@pytest.mark.parametrize("kw", [
    dict(nperseg=128),
    dict(nperseg=120, noverlap=90),   # step does not divide nperseg
    dict(window="hamming", nperseg=64, scaling="psd"),
])
def test_stft_istft_roundtrip(kw):
    x = _f32(2000, 25)
    _, _, z = T.stft(x, device=CPU, **kw)
    _, _, zj = J.stft(x, **kw)
    _, xr = T.istft(z, device=CPU, **kw)
    _, xj = J.istft(zj, **kw)
    assert xr.dtype == torch.float32
    xr, xj = _np(xr), _np(xj)
    n = min(len(xr), len(x))
    assert np.allclose(xr[:n], x[:n], atol=1e-4), np.abs(xr[:n] - x[:n]).max()
    assert np.allclose(xr, xj, atol=1e-4)


def test_istft_matches_scipy():
    x = _f32(1500, 26)
    _, _, z = T.stft(x, nperseg=100, noverlap=60, device=CPU)
    _, got = T.istft(z, nperseg=100, noverlap=60, device=CPU)
    _, theirs = J.istft(z.numpy(), nperseg=100, noverlap=60)
    _, ref = ssig.istft(z.numpy().astype(np.complex128), nperseg=100,
                        noverlap=60)
    n = min(got.shape[-1], len(ref))
    for g in (_np(got), _np(theirs)):
        assert np.allclose(g[:n], ref[:n], rtol=1e-4,
                           atol=1e-4 * np.abs(ref).max())


# ------------------------------------------------ the slice's own checks
SWEEP = [((200,), (31,), (0,)), ((1000,), (25,), (0,)),
         ((200, 220), (50, 30), (0, 1)), ((40, 50), (7, 9), (0, 1)),
         ((3, 64, 64), (3, 9, 9), (1, 2)), ((8, 300), (8, 17), (1,)),
         ((64, 200), (64, 60), (0, 1)), ((100, 900), (30, 125), (0, 1)),
         ((700,), (400,), (0,)), ((5, 130, 120), (5, 3, 7), (1, 2)),
         ((2000,), (49,), (0,)), ((16, 16, 200), (4, 4, 57), (0, 1, 2))]


def _makes(make) -> bool:
    try:
        make()
        return True
    except ValueError:
        return False


def _packed_pair(mod, shape, axes, backend, **kw):
    """Whether ``mod`` makes fftconvolve's packed R2C and C2R plans."""
    return [_makes(lambda k=k, d=d: mod.make_plan(
        shape, axes=axes, kind=mod.Kind(k), direction=mod.Direction(d),
        use_3m=True, backend=backend, packed_layout=True, **kw))
        for k, d in (("r2c", -1), ("c2r", 1))]


@pytest.mark.parametrize("method", ["auto", "packed", "plain"])
@pytest.mark.parametrize("sa,sb,axes", SWEEP)
def test_conv_sizes_and_route_match_jax(sa, sb, axes, method):
    """The padded sizes, the packed flag and whether the packed plans can
    be made (on the kernel backend, and on the CPU's default one) are the
    JAX package's: the route fftconvolve takes is the same."""
    got = T._conv_sizes(sa, sb, axes, method)
    assert got == J._conv_sizes(sa, sb, axes, method)
    shape, packed = got
    if not packed:
        return
    for backend in ("stockham", "auto"):
        ours = _packed_pair(rt, shape, axes, backend, device=CPU)
        assert ours == _packed_pair(R, shape, axes, backend), backend
        if backend == "auto":
            assert ours == [False, False]   # the CPU's default: contractions


def _lines(text):
    return [ln.strip() for ln in text.splitlines()[1:-1]]


@pytest.mark.parametrize("shape,axes", [((256, 256), (0, 1)),
                                        ((3, 128, 512), (1, 2)),
                                        ((64, 32, 1024), (0, 1, 2))])
def test_packed_plans_print_the_jax_steps(shape, axes):
    for kind, d in ((rt.Kind.R2C, rt.FORWARD), (rt.Kind.C2R, rt.BACKWARD)):
        ours = rt.make_plan(shape, axes=axes, kind=kind, direction=d,
                            use_3m=True, backend="stockham",
                            packed_layout=True, device=CPU)
        theirs = R.make_plan(shape, axes=axes, kind=R.Kind(kind.value),
                             direction=R.Direction(int(d)), use_3m=True,
                             backend="stockham", packed_layout=True)
        assert _lines(ours.describe()) == _lines(theirs.describe())
        assert "nyquist-packed" in ours.describe()


def test_one_axis_packed_c2r_refused_like_jax():
    """A 1-D C2R prefers the half-length route in both packages, so a 1-D
    problem never takes the packed plans (fftconvolve's auto falls back)."""
    assert _packed_pair(rt, (256,), (0,), "stockham", device=CPU) \
        == _packed_pair(R, (256,), (0,), "stockham") == [True, False]


def test_packed_route_falls_back_like_jax():
    """``auto`` on a power-of-two problem whose packed plans cannot be made
    (the CPU's default backend) takes the plain sizes in both packages;
    ``method='packed'`` raises in both."""
    a, b = _f32((200, 220), 27), _f32((50, 30), 28)
    assert T._conv_sizes(a.shape, b.shape, (0, 1), "auto")[1]
    _conv(a, b, mode="same")
    with pytest.raises(ValueError, match="packed_layout"):
        T.fftconvolve(a, b, method="packed", device=CPU)
    with pytest.raises(ValueError):
        J.fftconvolve(a, b, method="packed")


def test_outputs_stay_on_the_device_and_class():
    a = torch.from_numpy(_f32((2, 300), 29))
    y = T.fftconvolve(a, a[:, :20], axes=(1,), device=CPU)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    z = T.hilbert(a, device=CPU)
    assert z.dtype == torch.complex64 and z.shape == a.shape
    f, t, s = T.stft(a, nperseg=64, device=CPU)
    assert s.shape == (2, 33, len(t)) and s.dtype == torch.complex64
