"""The port's four-step and slab-ring paths (ops/fourstep.py, CPU tensors,
so the plain versions) against the JAX package's Pallas entry points in
interpret mode, the gates against the JAX gates, the CUDA kernels' column
addressing emulated in numpy, and the plans that route through them.

Bound: tolerance(n) (tolerance(logical_n) for plans) between the packages
and for each side against the float64 numpy FFT."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.ops import pallas_stockham as jps

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, Kind
from regent_fft_tpu_torch.ops import fourstep as fs
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

SIGNS = [Direction.FORWARD, Direction.BACKWARD]


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
    assert yt.shape == yj.shape == ref.shape
    assert rel_l2(yt, yj) <= tol
    assert rel_l2(yt, ref) <= tol
    assert rel_l2(yj, ref) <= tol


def _run(port_fn, jax_fn, shape, seed):
    """Both packages on the same seeded planes; the port's CPU planes must
    launch nothing."""
    xr, xi = _planes(shape, seed)
    before = dict(sk.LAUNCHES)
    port = port_fn(torch.from_numpy(xr), torch.from_numpy(xi))
    assert sk.LAUNCHES == before
    return xr, xi, port, jax_fn(jnp.asarray(xr), jnp.asarray(xi))


# ---------------------------------------------------------------------------
# Entries against the JAX package (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("unit_scale", [True, False])
@pytest.mark.parametrize("direction", SIGNS)
@pytest.mark.parametrize("shape", [(2, 4096), (3, 8192)])
def test_fft_last_four_step_matches_jax(shape, direction, unit_scale):
    n = shape[-1]
    scale = 1.0 if unit_scale else 1.0 / n
    xr, xi, port, jx = _run(
        lambda a, b: fs.fft_last_four_step(a, b, direction, scale),
        lambda a, b: jps.fft_last_four_step(a, b, JDirection(int(direction)),
                                            scale, interpret=True),
        shape, n)
    _check(port, jx, _np_ref(xr, xi, (-1,), int(direction), scale), n)


@pytest.mark.parametrize("shape,axis,direction,scale", [
    ((64, 8, 512), 0, Direction.FORWARD, 1.0),
    ((256, 16, 128), 0, Direction.FORWARD, 1.0),
    ((2, 64, 16, 256), 1, Direction.FORWARD, 1.0),
    ((64, 8, 512), 0, Direction.BACKWARD, 1.0 / 64),
])
def test_fft_axis0_fourstep_matches_jax(shape, axis, direction, scale):
    assert sk.axis0_fourstep_supported(
        shape[axis], int(np.prod(shape[axis + 1:])), shape[-1])
    xr, xi, port, jx = _run(
        lambda a, b: fs.fft_axis0_fourstep(a, b, axis, direction, scale),
        lambda a, b: jps.fft_axis0_fourstep(a, b, axis,
                                            JDirection(int(direction)),
                                            scale, k=2, interpret=True),
        shape, 5)
    _check(port, jx, _np_ref(xr, xi, (axis,), int(direction), scale),
           shape[axis])


@pytest.mark.parametrize("shape,axis", [((64, 8, 512), 0), ((2, 64, 2048), 1)])
def test_fft_axis_dma_matches_jax(shape, axis):
    xr, xi, port, jx = _run(
        lambda a, b: fs.fft_axis_dma(a, b, axis, Direction.FORWARD),
        lambda a, b: jps.fft_axis_dma(a, b, axis, JDirection.FORWARD, k=2,
                                      interpret=True),
        shape, 6)
    _check(port, jx, _np_ref(xr, xi, (axis,), -1, 1.0), shape[axis])


@pytest.mark.parametrize("shape,direction,scale", [
    ((4, 64, 128), Direction.FORWARD, 1.0),
    ((2, 3, 32, 256), Direction.FORWARD, 1.0),
    ((4, 64, 128), Direction.BACKWARD, 1.0 / (64 * 128)),
])
def test_fft_axes2_ring_matches_jax(shape, direction, scale):
    xr, xi, port, jx = _run(
        lambda a, b: fs.fft_axes2_ring(a, b, direction, scale),
        lambda a, b: jps.fft_axes2_ring(a, b, JDirection(int(direction)),
                                        scale, k=2, interpret=True),
        shape, 7)
    _check(port, jx, _np_ref(xr, xi, (-2, -1), int(direction), scale),
           shape[-2] * shape[-1])


# ---------------------------------------------------------------------------
# Plain versions, stage by stage, and the CUDA kernels' addressing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [64, 128, 512, 4096])
def test_a0fs_stages_compose_to_the_fft(n, sign):
    """Stage a then stage b is the natural-order FFT along the middle
    axis, the scale riding stage b; each stage alone is its formula."""
    pre, post = 2, 24
    xr, xi = _planes((pre, n, post), n)
    r1, r2 = sk._a0fs_split(n)
    t = (torch.from_numpy(xr), torch.from_numpy(xi))
    ar, ai = fs.a0fs_stage("a", *t, sign)
    x = (xr.astype(np.float64) + 1j * xi).reshape(pre, r1, r2, post)
    k = np.arange(r1)
    w = np.exp(sign * 2j * np.pi * (np.outer(k, k)[None] / r1
                                    + np.arange(r2)[:, None, None]
                                    * k[None, :, None] / n))
    want_a = np.einsum("bka,pabc->pkbc", w, x).reshape(pre, n, post)
    assert rel_l2(torch.complex(ar, ai), want_a) <= tolerance(r1)
    yr, yi = fs.a0fs_stage("b", ar, ai, sign, 0.25)
    ref = _np_ref(xr, xi, (1,), sign, 0.25)
    assert rel_l2(torch.complex(yr, yi), ref) <= tolerance(n)
    with pytest.raises(ValueError):
        fs.a0fs_stage("c", *t, sign)
    with pytest.raises(ValueError):
        fs.a0fs_stage("a", *t, sign, 0.5)


def _emulate_store_policy(x, g, tdiv, lN, scale, sign):
    """numpy model of csrc/fourstep.cu's fft_cols_fs_kernel at the level of
    its store policy (FsIO, csrc/cols.cuh): over (P, n, V) complex planes,
    the n-point DFT along axis 1; output element k of column v of plane q
    goes to ooff + k*old with ooff = ((q // g)*g*n + q % g)*V + v and
    old = g*V, times W_{2^lN}^{k*(v // tdiv)} when lN > 0 (from the exact
    integer phase), else times the scale.  Every output element is written
    once."""
    p, n, v = x.shape
    y = (np.fft.fft(x, axis=1) if sign < 0
         else np.fft.ifft(x, axis=1) * n)
    k = np.arange(n)[:, None]
    c = np.arange(v)[None, :]
    if lN:
        e = k * (c // tdiv)
        assert e.max() < 2 ** lN <= 2 ** 24
        y = y * np.exp(sign * 2j * np.pi * e / 2 ** lN)
    else:
        y = y * scale
    out = np.full(p * n * v, np.nan, complex)
    for q in range(p):
        idx = ((q // g) * g * n + q % g) * v + c + k * (g * v)
        assert np.isnan(out[idx]).all(), "an element written twice"
        out[idx.ravel()] = y[q].ravel()
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("sign", [-1, 1])
def test_kernel_addressing_emulation(sign):
    """The store-policy arguments of fft_cols_fs_kernel as the C entries
    fft_cols_tw, a0fs_a and a0fs_b (csrc/fourstep.cu) pass them compose to
    the four-step and leading-axis FFTs."""
    rng = np.random.default_rng(11)
    # fft_cols_tw over (b, n1, n2): g = 1, tdiv = 1, N = n1*n2; then the
    # last-axis pass and the swap
    b, n1, n2 = 3, 8, 512
    n = n1 * n2
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    a = _emulate_store_policy(x.reshape(b, n1, n2), 1, 1, 12, 1.0,
                              sign).reshape(b, n1, n2)
    y = (np.fft.fft(a, axis=2) if sign < 0 else np.fft.ifft(a, axis=2) * n2)
    y = y.transpose(0, 2, 1).reshape(b, n)
    ref = np.fft.fft(x, axis=1) if sign < 0 else np.fft.ifft(x, axis=1) * n
    assert rel_l2(y, ref) <= 1e-12
    # a0fs_a over (pre, r1, r2*post): g = 1, tdiv = post, N = n; then a0fs_b
    # over (pre*r1, r2, post): g = r1, the scale
    pre, n, post = 2, 512, 6
    r1, r2 = sk._a0fs_split(n)
    x = (rng.standard_normal((pre, n, post))
         + 1j * rng.standard_normal((pre, n, post)))
    a = _emulate_store_policy(x.reshape(pre, r1, r2 * post), 1, post, 9, 1.0,
                              sign)
    y = _emulate_store_policy(a.reshape(pre * r1, r2, post), r1, 1, 0, 0.5,
                              sign).reshape(pre, n, post)
    ref = np.fft.fft(x, axis=1) if sign < 0 else np.fft.ifft(x, axis=1) * n
    assert rel_l2(y, ref * 0.5) <= 1e-12


def test_cols_tw_and_ring_plain_versions():
    xr, xi = _planes((3, 16, 2048), 12)
    t = (torch.from_numpy(xr), torch.from_numpy(xi))
    yr, yi = fs.fft_cols_tw(*t, 1)
    x = xr.astype(np.float64) + 1j * xi
    k1 = np.arange(16)[:, None]
    j2 = np.arange(2048)[None, :]
    want = np.fft.ifft(x, axis=1) * 16 * np.exp(2j * np.pi * k1 * j2 / 32768)
    assert rel_l2(torch.complex(yr, yi), want) <= tolerance(32768)
    r = fs.fft_axis_ring(*t, -1, 0.5)
    c = sk.fft_cols(*t, -1, 0.5)
    assert torch.equal(r[0], c[0]) and torch.equal(r[1], c[1])
    r = fs.fft_axis_ring(*t, -1, 0.5, fuse_last=True)
    c = sk.fft_fused2(*t, -1, 0.5)
    assert torch.equal(r[0], c[0]) and torch.equal(r[1], c[1])


def test_entries_reject_unsupported_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):
        fs.fft_last_four_step(z(2, 2048), z(2, 2048), Direction.FORWARD)
    with pytest.raises(ValueError):
        fs.fft_axis0_fourstep(z(32, 8, 256), z(32, 8, 256), 0,
                              Direction.FORWARD)
    with pytest.raises(ValueError):
        fs.fft_axis_dma(z(8, 8, 128), z(8, 8, 128), 0, Direction.FORWARD)
    with pytest.raises(ValueError):
        fs.fft_axes2_ring(z(2, 8, 512), z(2, 8, 512), Direction.FORWARD)
    meta = torch.empty((2, 64, 128), device="meta")
    with pytest.raises(ValueError):
        fs.fft_axis_ring(meta, meta, -1)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------
def test_four_step_gates_equal():
    for k in range(0, 24):
        for n in {1 << k, (1 << k) + 8, 3 << k}:
            assert sk.four_step_supported(n) == jps.four_step_supported(n), n
            if n >= 1:
                assert sk._four_step_split(n) == jps._four_step_split(n), n
                assert sk._a0fs_split(n) == jps._a0fs_split(n), n
    assert sk.MAX_BLOCK_ELEMS == jps.MAX_BLOCK_ELEMS


def test_leading_axis_gates_equal():
    ns = sorted({2 ** k for k in range(2, 13)} | {24, 96, 160, 384, 640, 768})
    posts = [64, 96, 128, 384, 512, 1024, 2048, 2560, 4096, 65536, 262144,
             393216]
    for n in ns:
        for post in posts:
            assert (sk.axis0_dma_supported(n, post)
                    == jps.axis0_dma_supported(n, post)), (n, post)
            for x in (0, 64, 128, 256, 384, 512, 2048, 4096):
                assert (sk.axis0_fourstep_supported(n, post, x)
                        == jps.axis0_fourstep_supported(n, post, x)), (
                            n, post, x)


def test_fused2_ring_gate_equal():
    ns = [8, 12, 16, 24, 64, 128, 160, 256, 384, 512, 640, 1024, 2048, 4096]
    for n1 in ns:
        for n2 in ns:
            assert (sk.fused2_ring_supported(n1, n2)
                    == jps.fused2_ring_supported(n1, n2)), (n1, n2)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------
def _lines(plan):
    return [ln.strip() for ln in plan.describe().splitlines()
            if ln.startswith("  (axis")]


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _check_plan(p, x, axes):
    tol = tolerance(p.spec.logical_n)
    y = p(x)
    assert y.dtype == torch.complex64 and tuple(y.shape) == x.shape
    assert rel_l2(y, np.fft.fftn(x.astype(np.complex128), axes=axes)) <= tol
    assert rel_l2(p.inverse()(y), x) <= tol


@pytest.mark.parametrize("shape,backend", [((2, 32768), "hybrid"),
                                           ((3, 4096), "stockham")])
def test_four_step_last_plans(shape, backend):
    n = shape[-1]
    tp = rt.make_plan(shape, axes=(1,), backend=backend, device="cpu")
    jp = R.make_plan(shape, axes=(1,), kind=JKind.C2C,
                     direction=JDirection.FORWARD, backend=backend)
    assert _lines(tp) == [f"(axis 1: kernel-fourstep-last(n={n}))"]
    assert _lines(tp) == [ln.strip() for ln in jp.describe().splitlines()
                          if ln.startswith("  (axis")]
    assert tp.steps[-1][0] in rt.plan.KERNEL_STEPS and tp.fused
    _check_plan(tp, _crand(shape, 21), (1,))


@pytest.mark.parametrize("impl,name", [("fourstep", "kernel-fourstep-ring"),
                                       ("dma", "kernel-dma-ring")])
def test_leading_axis_route_plans(impl, name):
    shape = (64, 256, 256)
    p = rt.make_plan(shape, axes=(0,), backend="stockham", axis0_impl=impl,
                     device="cpu")
    assert _lines(p) == [f"(axis 0: {name}(n=64))"]
    _check_plan(p, _crand(shape, 22), (0,))
    # a trailing extent below 65536 keeps the butterfly
    q = rt.make_plan((64, 16, 256), axes=(0,), backend="stockham",
                     axis0_impl=impl, device="cpu")
    assert _lines(q) == ["(axis 0: kernel-butterfly(n=64))"]


def test_fused2_ring_plan():
    shape = (4, 64, 128)
    p = rt.make_plan(shape, axes=(1, 2), backend="stockham", f2_impl="ring",
                     device="cpu")
    assert _lines(p) == ["(axis 1: kernel-fused2-ring(64, 128))"]
    _check_plan(p, _crand(shape, 23), (1, 2))


def test_auto_routes_keep_their_step_lines():
    """Under axis0_impl/f2_impl "auto" the port keeps the butterfly and
    grid routes (the chip smoke's plans); explicit impls take the rings."""
    def f(shape, axes, **kw):
        return _lines(rt.make_plan(shape, axes=axes, backend="stockham",
                                   device="cpu", **kw))
    assert f((512, 512, 512), (0, 1, 2)) == [
        "(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-butterfly(n=512))"]
    assert f((512, 512, 512), (0, 1, 2), axis0_impl="fourstep") == [
        "(axis 1: kernel-fused2(512, 512))",
        "(axis 0: kernel-fourstep-ring(n=512))"]
    assert f((512, 512, 512), (0, 1, 2), axis0_impl="dma") == [
        "(axis 1: kernel-fused2(512, 512))", "(axis 0: kernel-dma-ring(n=512))"]
    assert f((512, 512, 512), (0, 1, 2), f2_impl="ring") == [
        "(axis 1: kernel-fused2-ring(512, 512))",
        "(axis 0: kernel-butterfly(n=512))"]
    assert f((4, 256, 256, 256), (1, 2, 3), axis0_impl="fourstep") == [
        "(axis 2: kernel-fused2(256, 256))",
        "(axis 1: kernel-fourstep-ring(n=256))"]
    assert f((64, 1048576), (1,)) == [
        "(axis 1: kernel-fourstep-last(n=1048576))"]
    p = rt.make_plan((64, 1048576), axes=(1,), backend="hybrid", device="cpu")
    assert _lines(p) == ["(axis 1: kernel-fourstep-last(n=1048576))"]
    # below 32768 the hybrid backend keeps the two-factor contraction
    q = rt.make_plan((2, 8192), axes=(1,), backend="hybrid", device="cpu")
    assert _lines(q) == ["(axis 1: einsum-mixed2(8192=128x64))"]


def test_real_plan_routes_on_the_half_spectrum():
    """An R2C plan with axis0_impl="fourstep" routes its leading axis on the
    packed half-spectrum planes and matches numpy both ways."""
    shape = (64, 512, 256)
    x = np.random.default_rng(24).standard_normal(shape).astype(np.float32)
    p = rt.make_plan(shape, axes=(0, 1, 2), kind=Kind.R2C,
                     direction=Direction.FORWARD, backend="stockham",
                     axis0_impl="fourstep", device="cpu")
    assert _lines(p) == ["(axis 1: kernel-butterfly(n=512))",
                         "(axis 0: kernel-fourstep-ring(n=64))"]
    y = p(x)
    tol = tolerance(p.spec.logical_n)
    assert rel_l2(y, np.fft.rfftn(x.astype(np.float64))) <= tol
    assert rel_l2(p.inverse()(y), x) <= tol
