"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas entry points in interpret mode, and the CUDA
kernels' butterfly schedule + twiddle table emulated in numpy.

Bound: tolerance(n) between the packages and for each side against the
float64 numpy FFT."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.ops import pallas_stockham as jps

from regent_fft_tpu_torch.dtypes import Direction
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _np_ref(xr, xi, axes, sign, scale):
    x = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    y = (np.fft.fftn(x, axes=axes) if sign < 0
         else np.fft.ifftn(x, axes=axes, norm="forward"))
    return y * scale


def _check(port, jax_out, ref, n):
    yt = port[0].numpy() + 1j * port[1].numpy()
    yj = np.asarray(jax_out[0]) + 1j * np.asarray(jax_out[1])
    tol = tolerance(n)
    assert rel_l2(yt, yj) <= tol
    assert rel_l2(yt, ref) <= tol
    assert rel_l2(yj, ref) <= tol


SIGNS = [Direction.FORWARD, Direction.BACKWARD]
SCALES = [1.0, 0.375]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("direction", SIGNS)
@pytest.mark.parametrize("shape", [(6, 1024), (33, 256), (4, 640)])
def test_last_axis_plain_matches_jax(shape, direction, scale):
    xr, xi = _planes(shape, 1)
    before = dict(sk.LAUNCHES)
    port = sk.fft_axis_stockham(torch.from_numpy(xr), torch.from_numpy(xi),
                                -1, direction, scale=scale)
    assert sk.LAUNCHES == before          # CPU planes never launch a kernel
    jx = jps.fft_axis_stockham(jnp.asarray(xr), jnp.asarray(xi), -1,
                               JDirection(int(direction)), scale=scale,
                               interpret=True)
    _check(port, jx, _np_ref(xr, xi, (-1,), int(direction), scale), shape[-1])
    direct = sk.fft_last_plain(torch.from_numpy(xr), torch.from_numpy(xi),
                               int(direction), scale)
    assert torch.equal(direct[0], port[0]) and torch.equal(direct[1], port[1])


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("direction", SIGNS)
@pytest.mark.parametrize("shape,axis", [((64, 32, 128), 0), ((64, 32, 128), 1),
                                        ((8, 64, 256), 0), ((8, 64, 256), 1)])
def test_mid_axis_plain_matches_jax(shape, axis, direction, scale):
    xr, xi = _planes(shape, 2)
    port = sk.fft_axis_stockham(torch.from_numpy(xr), torch.from_numpy(xi),
                                axis, direction, scale=scale)
    jx = jps.fft_axis_stockham(jnp.asarray(xr), jnp.asarray(xi), axis,
                               JDirection(int(direction)), scale=scale,
                               interpret=True)
    _check(port, jx, _np_ref(xr, xi, (axis,), int(direction), scale),
           shape[axis])


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("direction", SIGNS)
@pytest.mark.parametrize("shape", [(2, 128, 256), (3, 16, 128)])
def test_fused2_plain_matches_jax(shape, direction, scale):
    xr, xi = _planes(shape, 3)
    port = sk.fft_axes2_stockham(torch.from_numpy(xr), torch.from_numpy(xi),
                                 direction, scale=scale)
    jx = jps.fft_axes2_stockham(jnp.asarray(xr), jnp.asarray(xi),
                                JDirection(int(direction)), scale=scale,
                                interpret=True)
    _check(port, jx, _np_ref(xr, xi, (-2, -1), int(direction), scale),
           shape[-2] * shape[-1])


def _emulate_kernel_tile(x, n, sign):
    """numpy model of csrc/stockham.cu's fft_tile on (n, B) complex64
    columns: stage (R, Ns) reads x[j + r*m], twiddles by the table entry
    (r-1)*Ns + j%Ns, runs an R-point DFT and writes
    out[(j - j%Ns)*R + j%Ns + q*Ns]."""
    tab = sk._kernel_tables(n, sign)
    tw = (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)
    ns, off = 1, 0
    for r in sk._kernel_stages(n):
        m = n // r
        j = np.arange(m)
        k = j % ns
        v = x.reshape(r, m, -1).copy()
        if ns > 1:
            v[1:] *= tw[off:off + (r - 1) * ns].reshape(r - 1, ns)[:, k][..., None]
        q = np.arange(r)
        dft = np.exp(sign * 2j * np.pi * np.outer(q, q) / r).astype(np.complex64)
        y = np.einsum("qr,rjb->qjb", dft, v)
        out = np.empty_like(x)
        for qq in range(r):
            out[(j - k) * r + k + qq * ns] = y[qq]
        x = out
        off += (r - 1) * ns
        ns *= r
    assert off == len(tw)
    return x


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [2 ** k for k in range(1, 12)]
                         + [24, 96, 160, 384, 640, 768, 896, 1536, 1792])
def test_kernel_schedule_emulation(n, sign):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 3))
         + 1j * rng.standard_normal((n, 3))).astype(np.complex64)
    y = _emulate_kernel_tile(x, n, sign)
    ref = np.fft.fft(x.astype(np.complex128), axis=0) if sign < 0 else \
        np.fft.ifft(x.astype(np.complex128), axis=0) * n
    assert rel_l2(y, ref) <= tolerance(n)
    # what make_plan in csrc/stockham.cu accepts: radices in {2,3,4,5,7}
    # whose running product Ns is a power of two at every stage
    rad = sk._kernel_stages(n)
    assert int(np.prod(rad)) == n and set(rad) <= {2, 3, 4, 5, 7}
    ns = 1
    for r in rad:
        assert ns & (ns - 1) == 0
        ns *= r


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        sk.fft_last(x, x, -1)
    with pytest.raises(ValueError):
        sk.fft_axis_stockham(torch.zeros(4, 12), torch.zeros(4, 12), -1,
                             Direction.FORWARD)
    with pytest.raises(ValueError):
        sk.fft_axes2_stockham(torch.zeros(2, 8, 128), torch.zeros(2, 8, 128),
                              Direction.FORWARD)
