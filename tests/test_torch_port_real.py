"""The port's real transforms on the CPU against the JAX package: the r2c
and c2r kernels' plain versions against the Pallas kernels in interpret
mode, ``ops/real.py`` against its JAX counterpart, the real and Hermitian
API against ``regent_fft_tpu.api`` and numpy/scipy, and the general 1-D
step.

Bound: tolerance(n) for the kernels and build_*_1d, tolerance(logical_n)
for plans and API calls, between the packages and for each side against
the float64 numpy/scipy transform."""
import numpy as np
import pytest
import scipy.fft
import torch
import jax
import jax.numpy as jnp

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.ops import pallas_stockham as jps
from regent_fft_tpu.ops import real as jreal
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, SplitComplex
from regent_fft_tpu_torch.ops import real as treal
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

KERNEL_NS = [2, 8, 64, 128, 256, 1024]
B = 5           # odd: the last row pairs with zeros


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _half(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pack(h, n):
    """numpy (B, n/2+1) half spectrum -> the packed (B, n/2) layout."""
    m = n // 2
    p = h[:, :m].copy()
    p.imag[:, 0] = h.real[:, m]
    return p


def _pair(y):
    return y[0].numpy() + 1j * y[1].numpy()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", KERNEL_NS)
def test_r2c_plain_matches_jax(n, packed):
    x = _real((B, n), n)
    before = dict(sk.LAUNCHES)
    y = sk.fft_last_r2c_stockham(torch.from_numpy(x), packed=packed)
    assert sk.LAUNCHES == before          # CPU rows never launch a kernel
    ref = np.fft.rfft(x.astype(np.float64))
    if packed:
        ref = _pack(ref, n)
    tol = tolerance(n)
    assert rel_l2(_pair(y), ref) <= tol
    direct = sk.fft_last_r2c_plain(torch.from_numpy(x), packed)
    assert torch.equal(direct[0], y[0]) and torch.equal(direct[1], y[1])
    if packed and not jps.r2c_packed_supported(n):
        with pytest.raises(ValueError):
            jps.fft_last_r2c_stockham(jnp.asarray(x), interpret=True,
                                      packed=True)
        return
    jy = jps.fft_last_r2c_stockham(jnp.asarray(x), interpret=True,
                                   packed=packed)
    jy = np.asarray(jy[0]) + 1j * np.asarray(jy[1])
    assert rel_l2(_pair(y), jy) <= tol
    assert rel_l2(jy, ref) <= tol


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", KERNEL_NS)
def test_c2r_plain_matches_jax(n, packed):
    h = _half((B, n // 2 + 1), n)         # endpoint bins not real
    hz = h.astype(np.complex128)
    hz.imag[:, [0, n // 2]] = 0.0
    ref = np.fft.irfft(hz, n=n) * n
    xin = _pack(h, n) if packed else h
    xr = torch.from_numpy(np.ascontiguousarray(xin.real))
    xi = torch.from_numpy(np.ascontiguousarray(xin.imag))
    y = sk.ifft_last_c2r_stockham(xr, xi, n, packed=packed)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, n)
    tol = tolerance(n)
    assert rel_l2(y, ref) <= tol
    assert torch.equal(sk.ifft_last_c2r_plain(xr, xi, n, packed), y)
    if packed and not jps.r2c_packed_supported(n):
        return
    jy = np.asarray(jps.ifft_last_c2r_stockham(
        jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()), n, interpret=True,
        packed=packed))
    assert rel_l2(y, jy) <= tol
    assert rel_l2(jy, ref) <= tol


@pytest.mark.parametrize("scale", [1.0, 0.375])
def test_real_kernels_scale_and_nd_shapes(scale):
    """N-D entry points: leading axes flatten to rows, scale rides the
    write, and c2r inverts r2c (times n)."""
    n = 256
    x = _real((3, 2, n), 1)
    yr, yi = sk.fft_last_r2c_stockham(torch.from_numpy(x), scale=scale)
    assert tuple(yr.shape) == (3, 2, n // 2 + 1)
    ref = np.fft.rfft(x.astype(np.float64)) * scale
    assert rel_l2(torch.complex(yr, yi), ref) <= tolerance(n)
    back = sk.ifft_last_c2r_stockham(yr, yi, n, scale=1.0 / (n * scale))
    assert rel_l2(back, x) <= tolerance(n)
    pr, pi = sk.fft_last_r2c_stockham(torch.from_numpy(x), packed=True)
    assert tuple(pr.shape) == (3, 2, n // 2)
    back = sk.ifft_last_c2r_stockham(pr, pi, n, packed=True, scale=scale)
    assert rel_l2(back, x * n * scale) <= tolerance(n)


def test_real_kernel_wrappers_reject():
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        sk.fft_last_r2c(x)
    with pytest.raises(ValueError):
        sk.fft_last_r2c_stockham(torch.zeros(4, 2048))    # above MAX_REAL_N
    with pytest.raises(ValueError):
        sk.fft_last_r2c_stockham(torch.zeros(4, 96))      # not a power of two
    with pytest.raises(ValueError):
        sk.fft_last_r2c_stockham(torch.zeros(4, 2048), padded=True)
    with pytest.raises(ValueError):     # neither n/2+1 nor n (padded) bins
        sk.ifft_last_c2r_stockham(torch.zeros(4, 48), torch.zeros(4, 48), 64)
    with pytest.raises(ValueError):     # the packed layout is n/2 wide
        sk.ifft_last_c2r_stockham(torch.zeros(4, 64), torch.zeros(4, 64), 64,
                                  packed=True)


@pytest.mark.parametrize("n", [1, 31, 64, 30])
def test_build_r2c_c2r_1d_match_jax(n):
    prec = jax.lax.Precision.HIGHEST
    x = _real((4, n), 3)
    y = treal.build_r2c_1d(n)(torch.from_numpy(x))
    jy = jreal.build_r2c_1d(n, 128, prec)(jnp.asarray(x))
    tol = tolerance(n)
    ref = np.fft.rfft(x.astype(np.float64))
    jyc = np.asarray(jy[0]) + 1j * np.asarray(jy[1])
    assert rel_l2(_pair(y), jyc) <= tol and rel_l2(_pair(y), ref) <= tol
    h = _half((4, n // 2 + 1), 4)
    hr = torch.from_numpy(np.ascontiguousarray(h.real))
    hi = torch.from_numpy(np.ascontiguousarray(h.imag))
    z = treal.build_c2r_1d(n)(hr, hi)
    jz = np.asarray(jreal.build_c2r_1d(n, 128, prec)(jnp.asarray(h.real),
                                                     jnp.asarray(h.imag)))
    hz = h.astype(np.complex128)
    hz.imag[:, 0] = 0.0
    if n % 2 == 0:
        hz.imag[:, n // 2] = 0.0
    assert rel_l2(z, jz) <= tol
    assert rel_l2(z, np.fft.irfft(hz, n=n) * n) <= tol


def test_half_length_core_injected():
    """The half-length reduction with the butterfly kernel as its core (the
    plan's route for a 1-D C2R, or an R2C the row-pair kernel cannot take)
    against JAX's ``build_r2c_1d`` with the Pallas core in interpret mode."""
    n = 512
    prec = jax.lax.Precision.HIGHEST
    x = _real((3, n), 5)
    f = treal.build_r2c_1d(n, cfft=lambda zr, zi: sk.fft_axis_stockham(
        zr, zi, -1, Direction.FORWARD))
    jf = jreal.build_r2c_1d(n, 128, prec, cfft=lambda zr, zi: (
        jps.fft_axis_stockham(zr, zi, -1, JDirection.FORWARD,
                              interpret=True)))
    y, jy = f(torch.from_numpy(x)), jf(jnp.asarray(x))
    jy = np.asarray(jy[0]) + 1j * np.asarray(jy[1])
    tol = tolerance(n)
    assert rel_l2(_pair(y), jy) <= tol
    assert rel_l2(_pair(y), np.fft.rfft(x.astype(np.float64))) <= tol
    g = treal.build_c2r_1d(n, cinv=lambda zr, zi: sk.fft_axis_stockham(
        zr, zi, -1, Direction.BACKWARD))
    back = g(*y)
    assert rel_l2(back, x * n) <= tol


# --- the numpy-style API ---------------------------------------------------
def _both(name, *args, **kw):
    port = getattr(rt, name)(*args, device="cpu", **kw)
    jx = getattr(R, name)(*args, **kw)
    return port, to_numpy_complex(jx)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_rfft_irfft_api(norm):
    x = _real((4, 40), 6)
    tol = tolerance(48)
    for n in (None, 48, 32):
        y, jy = _both("rfft", x, n=n, norm=norm)
        ref = np.fft.rfft(x.astype(np.float64), n=n, norm=norm)
        assert y.dtype == torch.complex64
        assert rel_l2(y, ref) <= tol and rel_l2(y, jy) <= tol
    h = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)    # (4, 21)
    for n in (None, 40, 41, 30, 64):
        y, jy = _both("irfft", h, n=n, norm=norm)
        ref = np.fft.irfft(h.astype(np.complex128), n=n, norm=norm)
        assert y.dtype == torch.float32 and tuple(y.shape) == ref.shape
        assert rel_l2(y, ref) <= tol and rel_l2(y, jy) <= tol
    y, _ = _both("irfft", h, axis=0, n=6, norm=norm)
    assert rel_l2(y, np.fft.irfft(h.astype(np.complex128), n=6, axis=0,
                                  norm=norm)) <= tol


def test_rfftn_irfftn_api():
    x = _real((3, 12, 20), 7)
    xd = x.astype(np.float64)
    tol = tolerance(x.size)
    # (port/JAX keywords, numpy's): numpy 2 wants `axes` beside `s`
    for kw, nkw in ((dict(), dict()),
                    (dict(s=(8, 24)), dict(s=(8, 24), axes=(1, 2))),
                    (dict(axes=(0, 2)), dict(axes=(0, 2))),
                    (dict(s=(16, 10), axes=(1, 0)),
                     dict(s=(16, 10), axes=(1, 0)))):
        y, jy = _both("rfftn", x, **kw)
        ref = np.fft.rfftn(xd, **nkw)
        assert rel_l2(y, ref) <= tol and rel_l2(y, jy) <= tol
    y, jy = _both("rfft2", x, norm="ortho")
    assert rel_l2(y, np.fft.rfft2(xd, norm="ortho")) <= tol
    assert rel_l2(y, jy) <= tol
    h = np.fft.rfftn(xd).astype(np.complex64)                    # (3, 12, 11)
    for kw, nkw in ((dict(), dict()),
                    (dict(s=(3, 12, 20)), dict(s=(3, 12, 20), axes=(0, 1, 2))),
                    (dict(s=(10, 19), axes=(1, 2)),
                     dict(s=(10, 19), axes=(1, 2))),
                    (dict(s=(2, None), axes=(0, 2)),      # default last length
                     dict(s=(2, 20), axes=(0, 2)))):
        y, jy = _both("irfftn", h, **kw)
        ref = np.fft.irfftn(h.astype(np.complex128), **nkw)
        assert tuple(y.shape) == ref.shape
        assert rel_l2(y, ref) <= tol and rel_l2(y, jy) <= tol
    h2 = np.fft.rfft2(xd).astype(np.complex64)
    y, jy = _both("irfft2", h2, s=(12, 20))
    assert rel_l2(y, xd) <= tol and rel_l2(y, jy) <= tol
    t = torch.from_numpy(h)
    split = SplitComplex(t.real.contiguous(), t.imag.contiguous())
    # a SplitComplex plans complex32, as in the JAX package: f32 compute,
    # output rounded to bf16, held at the complex32 bound
    y = rt.irfftn(split, s=(3, 12, 20), device="cpu")
    assert y.dtype == torch.bfloat16
    assert rel_l2(y, xd) <= tolerance(x.size, "complex32")
    assert rel_l2(rt.rfftn(torch.from_numpy(x), device="cpu"),
                  np.fft.rfftn(xd)) <= tol


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hermitian_api(norm):
    h = _half((4, 17), 8)
    hd = h.astype(np.complex128)
    x = _real((4, 32), 9)
    xd = x.astype(np.float64)
    tol = tolerance(64)
    for n in (None, 40):
        y, jy = _both("hfft", h, n=n, norm=norm)
        assert rel_l2(y, np.fft.hfft(hd, n=n, norm=norm)) <= tol
        assert rel_l2(y, jy) <= tol
    for n in (None, 24):
        y, jy = _both("ihfft", x, n=n, norm=norm)
        assert rel_l2(y, np.fft.ihfft(xd, n=n, norm=norm)) <= tol
        assert rel_l2(y, jy) <= tol
    g = _half((3, 8, 9), 10)
    gd = g.astype(np.complex128)
    tol = tolerance(3 * 8 * 16)
    for name, kw in (("hfftn", dict()), ("hfftn", dict(s=(6, 12), axes=(0, 2))),
                     ("hfft2", dict())):
        y, jy = _both(name, g, norm=norm, **kw)
        assert rel_l2(y, getattr(scipy.fft, name)(gd, norm=norm, **kw)) <= tol
        assert rel_l2(y, jy) <= tol
    z = _real((3, 8, 16), 11)
    for name, kw in (("ihfftn", dict()), ("ihfftn", dict(axes=(1, 2))),
                     ("ihfft2", dict(s=(6, 10)))):
        y, jy = _both(name, z, norm=norm, **kw)
        ref = getattr(scipy.fft, name)(z.astype(np.float64), norm=norm, **kw)
        assert rel_l2(y, ref) <= tol and rel_l2(y, jy) <= tol


def test_real_api_rejects_float64_and_complex():
    # float64 data is a complex128 plan now, kept in float64
    assert rt.rfft(np.zeros(16), device="cpu").dtype == torch.complex128
    y = rt.ihfftn(torch.ones(4, 16, dtype=torch.float64), device="cpu")
    assert y.dtype == torch.complex128
    assert rel_l2(y, scipy.fft.ihfftn(np.ones((4, 16)))) <= \
        tolerance(64, "complex128")
    with pytest.raises(TypeError):
        rt.rfft(np.zeros(16, np.complex64), device="cpu")


# --- the general 1-D step --------------------------------------------------
@pytest.mark.parametrize("direction", [Direction.FORWARD, Direction.BACKWARD])
def test_general_step_rank1_32768(direction):
    n = 32768
    x = _half((n,), 12)
    jp = R.make_plan((n,), kind=R.Kind.C2C,
                     direction=JDirection(int(direction)), backend="xla")
    tp = rt.make_plan((n,), direction=direction, device="cpu")
    lines = [ln.strip() for ln in tp.describe().splitlines()[1:-1]]
    assert lines == ["(axis 0: 1d-pipeline[mixed(32768 = 128*128*2): "
                     "radix-128 -> radix-128 -> radix-2])"]
    assert lines == [ln.strip() for ln in jp.describe().splitlines()[1:-1]]
    y = tp(x)
    xd = x.astype(np.complex128)
    ref = np.fft.fft(xd) if direction == Direction.FORWARD else np.fft.ifft(xd)
    tol = tolerance(n)
    assert rel_l2(y, ref) <= tol
    assert rel_l2(y, to_numpy_complex(jp(x))) <= tol
