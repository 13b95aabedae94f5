"""The port's ``spectral.py`` and the analytic-signal and resampling
functions of its ``signal.py`` against scipy.signal in float64 and the JAX
package on the CPU, mirroring every test of ``tests/test_spectral.py``.

The same numpy-seeded inputs go to both packages; bounds are the JAX
suite's ``_close`` (2e-4 of max|ref|; 5e-4 and 1e-3 where it says so),
each package against scipy and the port against the JAX package.  Also:
the median average on an even and an odd number of segments against
scipy (``torch.median`` would take the lower middle value).
"""
import numpy as np
import pytest
import torch
from scipy import signal as ssig

from regent_fft_tpu import signal as JS
from regent_fft_tpu import spectral as JP
from regent_fft_tpu.utils.verify import to_numpy_complex

from regent_fft_tpu_torch import signal as TS
from regent_fft_tpu_torch import spectral as TP

CPU = "cpu"


def _np(y):
    if isinstance(y, torch.Tensor):
        y = y.resolve_conj().numpy()
        return y.astype(np.complex128) if np.iscomplexobj(y) else y
    y = np.asarray(y)
    return to_numpy_complex(y) if np.iscomplexobj(y) else y


def _close(got, ref, tol=2e-4):
    """tests/test_spectral.py:_close."""
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-12)
    err = np.abs(got - ref).max() / scale
    assert err < tol, err


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _c64(shape, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape)
            + 1j * r.standard_normal(shape)).astype(np.complex64)


def _f64(x):
    return x if np.iscomplexobj(x) else x.astype(np.float64)


def _both(ours_mod, theirs_mod, name, args, kw, ref, tol=2e-4, pick=-1):
    """``name`` of both packages on the same inputs; element ``pick`` of a
    tuple result (None: the result itself) held against ``ref`` and each
    other.  Returns the port's whole result."""
    ours = getattr(ours_mod, name)(*args, device=CPU, **kw)
    theirs = getattr(theirs_mod, name)(*args, **kw)
    o, t = (ours, theirs) if pick is None else (ours[pick], theirs[pick])
    assert isinstance(o, torch.Tensor) and o.device.type == "cpu"
    _close(o, ref, tol)
    _close(t, ref, tol)
    _close(o, _np(t), tol)
    return ours


# ---------------------------------------------------------------- welch
@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("detrend", ["constant", "linear", False])
def test_welch_scaling_detrend(scaling, detrend):
    x = _f32(1500, 1)
    kw = dict(fs=10.0, nperseg=256, scaling=scaling, detrend=detrend)
    fr, pr = ssig.welch(_f64(x), **kw)
    f, p = _both(TP, JP, "welch", (x,), kw, pr)
    _close(f, fr)
    assert p.dtype == torch.float32


def test_welch_defaults_and_short_signal():
    x = _f32(100, 2)  # shorter than the default nperseg
    with pytest.warns(UserWarning):
        fr, pr = ssig.welch(_f64(x))
    f, _ = _both(TP, JP, "welch", (x,), {}, pr)
    _close(f, fr)


def test_welch_median_average():
    x = _f32(2048, 3)
    pr = ssig.welch(_f64(x), nperseg=128, average="median")[1]
    _both(TP, JP, "welch", (x,), dict(nperseg=128, average="median"), pr)


def test_welch_complex_twosided():
    x = _c64(1024, 4)
    fr, pr = ssig.welch(x, nperseg=256, return_onesided=False)
    f, _ = _both(TP, JP, "welch", (x,), dict(nperseg=256), pr, tol=5e-4)
    _close(f, fr)


def test_welch_batch_axis():
    x = _f32((3, 1000), 5)
    pr = ssig.welch(_f64(x), nperseg=200, axis=-1)[1]
    _both(TP, JP, "welch", (x,), dict(nperseg=200, axis=-1), pr)
    # and along a non-last axis
    _both(TP, JP, "welch", (x.T.copy(),), dict(nperseg=200, axis=0), pr.T)


# ---------------------------------------------------------- periodogram
@pytest.mark.parametrize("window", ["boxcar", "hann"])
def test_periodogram(window):
    x = _f32(777, 6)
    fr, pr = ssig.periodogram(_f64(x), fs=2.0, window=window)
    f, _ = _both(TP, JP, "periodogram", (x,), dict(fs=2.0, window=window), pr)
    _close(f, fr)


def test_periodogram_nfft():
    x = _f32(300, 7)
    pr = ssig.periodogram(_f64(x), nfft=512)[1]
    _both(TP, JP, "periodogram", (x,), dict(nfft=512), pr)
    # nfft < n truncates like scipy
    pr2 = ssig.periodogram(_f64(x), nfft=128)[1]
    _both(TP, JP, "periodogram", (x,), dict(nfft=128), pr2)


# ------------------------------------------------------------------ csd
def test_csd_matches_scipy():
    x = _f32(1200, 8)
    y = (0.5 * x + 0.1 * _f32(1200, 9)).astype(np.float32)
    fr, pr = ssig.csd(_f64(x), _f64(y), fs=4.0, nperseg=256)
    f, p = _both(TP, JP, "csd", (x, y), dict(fs=4.0, nperseg=256), pr)
    _close(f, fr)
    assert p.dtype == torch.complex64


def test_csd_unequal_lengths_zero_pads():
    x, y = _f32(800, 10), _f32(500, 11)
    pr = ssig.csd(_f64(x), _f64(y), nperseg=128)[1]
    _both(TP, JP, "csd", (x, y), dict(nperseg=128), pr)


# ------------------------------------------------------------ coherence
def test_coherence():
    x = _f32(4096, 12)
    y = (x + 0.5 * _f32(4096, 13)).astype(np.float32)
    cr = ssig.coherence(_f64(x), _f64(y), nperseg=256)[1]
    _both(TP, JP, "coherence", (x, y), dict(nperseg=256), cr, tol=1e-3)


# ---------------------------------------------------------- spectrogram
@pytest.mark.parametrize("mode", ["psd", "magnitude", "complex"])
def test_spectrogram(mode):
    x = _f32(2000, 14)
    fr, tr, sr = ssig.spectrogram(_f64(x), fs=8.0, nperseg=128, mode=mode)
    f, t, _ = _both(TP, JP, "spectrogram", (x,),
                    dict(fs=8.0, nperseg=128, mode=mode), sr, tol=5e-4)
    _close(f, fr)
    _close(t, tr)


def test_spectrogram_defaults():
    x = _f32(1024, 15)
    _, tr, sr = ssig.spectrogram(_f64(x))
    _, t, _ = _both(TP, JP, "spectrogram", (x,), {}, sr, tol=5e-4)
    _close(t, tr)


# -------------------------------------------------------------- hilbert
@pytest.mark.parametrize("n", [256, 255])
def test_hilbert(n):
    x = _f32(n, 16)
    y = _both(TS, JS, "hilbert", (x,), {}, ssig.hilbert(_f64(x)), pick=None)
    assert y.dtype == torch.complex64


def test_hilbert_padded_and_batched():
    x = _f32((4, 200), 17)
    _both(TS, JS, "hilbert", (x,), dict(N=256, axis=-1),
          ssig.hilbert(_f64(x), N=256, axis=-1), pick=None)


def test_hilbert_rejects_complex():
    for fn, kw in ((TS.hilbert, {"device": CPU}), (JS.hilbert, {})):
        with pytest.raises(ValueError):
            fn(np.zeros(8, np.complex64), **kw)


def test_hilbert2():
    x = _f32((32, 48), 18)
    _both(TS, JS, "hilbert2", (x,), {}, ssig.hilbert2(_f64(x)), pick=None)


# ------------------------------------------------------------- resample
@pytest.mark.parametrize("nx,num", [(128, 64), (128, 200), (127, 64),
                                    (127, 201), (128, 129), (100, 50)])
def test_resample_real(nx, num):
    x = _f32(nx, nx + num)
    y = _both(TS, JS, "resample", (x, num), {},
              ssig.resample(_f64(x), num), tol=5e-4, pick=None)
    assert y.dtype == torch.float32


@pytest.mark.parametrize("nx,num", [(128, 64), (128, 200), (127, 63)])
def test_resample_complex(nx, num):
    x = _c64(nx, nx + num)
    y = _both(TS, JS, "resample", (x, num), {}, ssig.resample(x, num),
              tol=5e-4, pick=None)
    assert y.dtype == torch.complex64


def test_resample_axis_and_t():
    x = _f32((6, 90), 19)
    t = np.arange(90) / 10.0
    ref, ref_t = ssig.resample(_f64(x), 45, t=t, axis=1)
    _, new_t = _both(TS, JS, "resample", (x, 45), dict(t=t, axis=1), ref,
                     tol=5e-4, pick=0)
    _close(new_t, ref_t)


def test_resample_window():
    x = _f32(128, 20)
    _both(TS, JS, "resample", (x, 64), dict(window="hann"),
          ssig.resample(_f64(x), 64, window="hann"), tol=5e-4, pick=None)


# ------------------------------------------------ the slice's own checks
@pytest.mark.parametrize("n,nseg", [(2048, 31), (2048 + 64, 32),
                                    (1024 + 64, 16), (128 * 9, 17)])
def test_welch_median_even_and_odd_segment_counts(n, nseg):
    """The median of an even count averages the two middle segments (the
    trap: torch.median returns the lower one)."""
    x = _f32(n, n)
    pr = ssig.welch(_f64(x), nperseg=128, average="median")[1]
    _, p = TP.welch(x, nperseg=128, average="median", device=CPU)
    assert (n - 128) // 64 + 1 == nseg
    _close(p, pr)
    _, lower = TP.welch(x, nperseg=128, average="mean", device=CPU)
    assert not np.allclose(_np(p), _np(lower))
    # the complex median (csd) takes it per part, as scipy does
    y = _f32(n, n + 1)
    _close(TP.csd(x, y, nperseg=128, average="median", device=CPU)[1],
           ssig.csd(_f64(x), _f64(y), nperseg=128, average="median")[1])


def test_median_helper_matches_numpy():
    v = torch.from_numpy(_f32((5, 6, 7), 21))
    for dim, n in ((0, 5), (1, 6), (2, 7)):
        got = TP._median(v, dim).numpy()
        assert np.allclose(got, np.median(v.numpy(), axis=dim)), n
    assert TP._median_bias(31) == JP._median_bias(31)
    assert TP._median_bias(32) == JP._median_bias(32)
