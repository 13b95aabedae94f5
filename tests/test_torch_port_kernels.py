"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas entry points in interpret mode.

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
