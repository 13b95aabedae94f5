"""The port's NUFFT (``regent_fft_tpu_torch/ops/nufft.py``), all nine
entries, against the direct sums in float64 and the JAX package on the
CPU, mirroring ``tests/test_nufft.py``.

Inputs are made with numpy from a seed and fed to JAX as float32 /
complex64.  Tolerances, in rel_l2: the JAX suite's against the direct
sums (2e-5 in 1-D, 5e-5 in 2-D, 1e-4 in 3-D; type 3: 2e-5, 3e-5, 5e-5),
and the same bound against the JAX function.  The port computes the tap
geometry in float64 (the JAX package in float32): at the suite's sizes
both are far inside the bounds; at 2^14 modes only the port is
(``test_tap_geometry_in_float64_at_scale``).  Host tables, grid sizes and
the grid plans' step lines are the JAX package's.
"""
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.ops import nufft as jnufft

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.ops import nufft as tnufft

RNG = np.random.default_rng(31)
CPU = "cpu"


def _pts(nj):
    return RNG.uniform(-np.pi, np.pi, nj).astype(np.float32)


def _coef(shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _k(n):
    return np.arange(-(n // 2), (n + 1) // 2)


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _rel(got, ref):
    return np.linalg.norm(_np(got) - ref) / np.linalg.norm(ref)


def direct1d1(x, c, n, isign):
    return (c[None, :] * np.exp(1j * isign * np.outer(_k(n), x))).sum(axis=1)


def direct1d2(x, f, isign):
    k = _k(f.shape[-1])
    return (f[None, :] * np.exp(1j * isign * np.outer(x, k))).sum(axis=1)


def direct3(coords, c, freqs, isign):
    phase = np.zeros((len(freqs[0]), len(coords[0])), np.float64)
    for x, s in zip(coords, freqs):
        phase += np.outer(s.astype(np.float64), x.astype(np.float64))
    return (c.astype(np.complex128)[None, :]
            * np.exp(1j * isign * phase)).sum(axis=1)


@pytest.mark.parametrize("isign", [1, -1])
@pytest.mark.parametrize("n", [32, 64])
def test_nufft1d1_matches_direct(n, isign):
    nj = 200
    x = _pts(nj)
    c = _coef(nj)
    got = rt.nufft1d1(x, c, n, isign=isign, device=CPU)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (n,)
    ref = direct1d1(x.astype(np.float64), c.astype(np.complex128), n, isign)
    assert _rel(got, ref) < 2e-5
    if n == 64:
        assert _rel(got, np.asarray(R.nufft1d1(x, c, n, isign=isign))) < 2e-5


@pytest.mark.parametrize("isign", [1, -1])
def test_nufft1d2_matches_direct(isign):
    n, nj = 64, 200
    x = _pts(nj)
    f = _coef(n)
    got = rt.nufft1d2(x, f, isign=isign, device=CPU)
    ref = direct1d2(x.astype(np.float64), f.astype(np.complex128), isign)
    assert _rel(got, ref) < 2e-5
    assert _rel(got, np.asarray(R.nufft1d2(x, f, isign=isign))) < 2e-5


def test_nufft1d_odd_modes():
    n, nj = 33, 100
    x = _pts(nj)
    c = _coef(nj)
    got = rt.nufft1d1(x, c, n, device=CPU)
    ref = direct1d1(x.astype(np.float64), c.astype(np.complex128), n, 1)
    assert _rel(got, ref) < 2e-5


def test_nufft1d1_batched():
    n, nj, b = 32, 150, 3
    x = _pts(nj)
    c = _coef((b, nj))
    got = rt.nufft1d1(x, c, n, device=CPU)
    assert tuple(got.shape) == (b, n)
    for i in range(b):
        ref = direct1d1(x.astype(np.float64), c[i].astype(np.complex128), n, 1)
        assert _rel(got[i], ref) < 2e-5
    f = _coef((b, n))
    got2 = rt.nufft1d2(x, f, device=CPU)
    for i in range(b):
        ref = direct1d2(x.astype(np.float64), f[i].astype(np.complex128), 1)
        assert _rel(got2[i], ref) < 2e-5


def test_nufft1d_adjointness():
    """<A c, f> == <c, A^H f> ties type 1 and type 2 together (2e-5)."""
    n, nj = 32, 100
    x = _pts(nj)
    c = _coef(nj).astype(np.complex128)
    f = _coef(n).astype(np.complex128)
    Ac = _np(rt.nufft1d1(x, c.astype(np.complex64), n, isign=1,
                         device=CPU)).astype(np.complex128)
    Ahf = _np(rt.nufft1d2(x, f.astype(np.complex64), isign=-1,
                          device=CPU)).astype(np.complex128)
    lhs = np.vdot(f, Ac)
    rhs = np.vdot(Ahf, c)
    assert abs(lhs - rhs) / abs(lhs) < 2e-5


def test_nufft2d_roundtrip_vs_direct():
    n1, n2, nj = 16, 24, 120
    x, y = _pts(nj), _pts(nj)
    c = _coef(nj)
    got = rt.nufft2d1(x, y, c, n1, n2, device=CPU)
    k1, k2 = _k(n1), _k(n2)
    ph = np.exp(1j * (k1[:, None, None] * x[None, None, :]
                      + k2[None, :, None] * y[None, None, :]))
    ref = (ph * c[None, None, :].astype(np.complex128)).sum(axis=-1)
    assert _rel(got, ref) < 5e-5
    assert _rel(got, np.asarray(R.nufft2d1(x, y, c, n1, n2))) < 5e-5
    f = _coef((n1, n2))
    got2 = rt.nufft2d2(x, y, f, device=CPU)
    ref2 = np.einsum("kl,klj->j", f.astype(np.complex128), ph)
    assert _rel(got2, ref2) < 5e-5
    assert _rel(got2, np.asarray(R.nufft2d2(x, y, f))) < 5e-5


def test_nufft3d_matches_direct():
    n1 = n2 = n3 = 8
    nj = 80
    x, y, z = _pts(nj), _pts(nj), _pts(nj)
    c = _coef(nj)
    got = rt.nufft3d1(x, y, z, c, n1, n2, n3, device=CPU)
    k1, k2, k3 = _k(n1), _k(n2), _k(n3)
    ph = np.exp(1j * (k1[:, None, None, None] * x
                      + k2[None, :, None, None] * y
                      + k3[None, None, :, None] * z))
    ref = (ph * c.astype(np.complex128)).sum(axis=-1)
    assert _rel(got, ref) < 1e-4
    assert _rel(got, np.asarray(R.nufft3d1(x, y, z, c, n1, n2, n3))) < 1e-4
    f = _coef((n1, n2, n3))
    got2 = rt.nufft3d2(x, y, z, f, device=CPU)
    ref2 = np.einsum("klm,klmj->j", f.astype(np.complex128), ph)
    assert _rel(got2, ref2) < 1e-4
    assert _rel(got2, np.asarray(R.nufft3d2(x, y, z, f))) < 1e-4


def test_nufft_eps_controls_accuracy():
    n, nj = 32, 150
    x = _pts(nj)
    c = _coef(nj)
    ref = direct1d1(x.astype(np.float64), c.astype(np.complex128), n, 1)
    r_lo = _rel(rt.nufft1d1(x, c, n, eps=1e-2, device=CPU), ref)
    r_hi = _rel(rt.nufft1d1(x, c, n, eps=1e-6, device=CPU), ref)
    assert r_hi < r_lo
    assert r_lo < 1e-2


def test_nufft_uniform_points_reduce_to_dft():
    n = 32
    x = (2 * np.pi * np.arange(n) / n - np.pi).astype(np.float32)
    f = _coef(n)
    got = rt.nufft1d2(x, f, isign=1, device=CPU)
    ref = direct1d2(x.astype(np.float64), f.astype(np.complex128), 1)
    assert _rel(got, ref) < 2e-5


@pytest.mark.parametrize("isign", [1, -1])
def test_nufft1d3_matches_direct(isign):
    nj, nk = 150, 120
    x = RNG.uniform(-4.0, 4.0, nj).astype(np.float32)
    s = RNG.uniform(-30.0, 30.0, nk).astype(np.float32)
    c = _coef(nj)
    got = rt.nufft1d3(x, c, s, isign=isign, device=CPU)
    assert tuple(got.shape) == (nk,)
    ref = direct3((x,), c, (s,), isign)
    assert _rel(got, ref) < 2e-5
    assert _rel(got, np.asarray(R.nufft1d3(x, c, s, isign=isign))) < 2e-5


def test_nufft2d3_matches_direct():
    nj, nk = 120, 90
    x = RNG.uniform(-1.0, 1.0, nj).astype(np.float32)
    y = RNG.uniform(-7.0, 7.0, nj).astype(np.float32)
    s = RNG.uniform(-20.0, 20.0, nk).astype(np.float32)
    t = RNG.uniform(-3.0, 3.0, nk).astype(np.float32)
    c = _coef(nj)
    got = rt.nufft2d3(x, y, c, s, t, device=CPU)
    assert _rel(got, direct3((x, y), c, (s, t), 1)) < 3e-5
    assert _rel(got, np.asarray(R.nufft2d3(x, y, c, s, t))) < 3e-5


def test_nufft3d3_matches_direct():
    nj, nk = 80, 60
    coords = tuple(RNG.uniform(-2.0, 2.0, nj).astype(np.float32)
                   for _ in range(3))
    freqs = tuple(RNG.uniform(-10.0, 10.0, nk).astype(np.float32)
                  for _ in range(3))
    c = _coef(nj)
    got = rt.nufft3d3(*coords, c, *freqs, device=CPU)
    assert _rel(got, direct3(coords, c, freqs, 1)) < 5e-5
    assert _rel(got, np.asarray(R.nufft3d3(*coords, c, *freqs))) < 5e-5


def test_nufft1d3_t1_consistency():
    """Type 3 at integer target frequencies reproduces type 1 (3e-5)."""
    n, nj = 32, 100
    x = _pts(nj)
    c = _coef(nj)
    s = _k(n).astype(np.float32)
    via_t3 = _np(rt.nufft1d3(x, c, s, device=CPU))
    via_t1 = _np(rt.nufft1d1(x, c, n, device=CPU))
    assert np.linalg.norm(via_t3 - via_t1) / np.linalg.norm(via_t1) < 3e-5


# --- the JAX package's tables, sizes and plans ---------------------------------
@pytest.mark.parametrize("eps", [1e-2, 1e-4, 1e-6, 1e-9, 1e-14])
def test_taps_tau_and_deconvolution_equal_jax(eps):
    p = tnufft._taps_for_eps(eps)
    assert p == jnufft._taps_for_eps(eps)
    for n in (8, 33, 64, 1 << 20):
        assert tnufft._tau(n, p) == jnufft._tau(n, p)
        assert np.array_equal(tnufft._deconv_1d(n, tnufft._tau(n, p)),
                              jnufft._deconv_1d(n, jnufft._tau(n, p)))
        assert tnufft._mode_slices(n, 2 * n) == jnufft._mode_slices(n, 2 * n)
    for ns in ((16, 24), (8, 8, 8)):
        assert np.array_equal(tnufft._deconv_nd(ns, p),
                              jnufft._deconv_nd(ns, p))


@pytest.mark.parametrize("X,S", [(4.0, 30.0), (np.pi, 2.0 ** 17), (1e-20, 5.0),
                                 (7.0, 3.0)])
def test_type3_grid_sizes_equal_jax(X, S):
    for eps in (1e-6, 1e-3):
        p = tnufft._taps_for_eps(eps)
        assert tnufft._t3_dim_params(X, S, p) == jnufft._t3_dim_params(X, S, p)


def test_tap_indices_equal_jax_and_weights_within_f32():
    """The tap stencil is the JAX package's; the weights, made in float64
    and rounded once, agree with its float32 ones within 1e-5 relative at
    n = 64 (its geometry's rounding)."""
    x = _pts(300)
    for n in (16, 64):
        p = 6
        tau = tnufft._tau(n, p)
        ti, tw = tnufft._grid_1d(torch.from_numpy(x), n, p, tau)
        ji, jw = jnufft._grid_1d(x, n, p, tau)
        assert ti.dtype == torch.int64 and tw.dtype == torch.float32
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.abs(tw.numpy() - np.asarray(jw)).max() <= 1e-5
    coords = (torch.from_numpy(_pts(50)), torch.from_numpy(_pts(50)))
    ti, tw = tnufft._nd_tap_product(coords, (8, 12), 6)
    ji, jw = jnufft._nd_tap_product(tuple(c.numpy() for c in coords), (8, 12), 6)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert tuple(tw.shape) == (50, 144)


def _step_lines(text):
    return [ln.strip() for ln in text.splitlines()[1:]
            if ln.startswith("  (axis")]


@pytest.mark.parametrize("shape,ndim", [
    ((128,), 1), ((3, 66), 1), ((32, 48), 2), ((16, 16, 16), 3),
    ((2, 16, 16, 16), 3), ((1 << 21,), 1), ((2048, 2048), 2),
    ((256, 256, 256), 3)])
@pytest.mark.parametrize("inverse", [False, True])
def test_grid_plan_step_lines_equal_jax(shape, ndim, inverse):
    """The grid transform is a complex64 C2C plan, forward with norm none
    or backward with norm backward, whose step lines are the JAX plan's
    (``_c2c_core``'s spec)."""
    from regent_fft_tpu.plan import PlanSpec as JSpec
    tp = tnufft.grid_plan(shape, ndim, inverse, CPU)
    s = tp.spec
    assert s.dtype == "complex64" and s.kind == rt.Kind.C2C
    assert s.axes == tuple(range(len(shape) - ndim, len(shape)))
    jp = R.make_plan(JSpec(shape=shape, axes=s.axes, kind=R.Kind.C2C,
                           direction=R.Direction(int(s.direction)),
                           norm=R.Norm(s.norm.value), dtype="complex64"))
    assert _step_lines(tp.describe()) == _step_lines(jp.describe())


def test_tap_geometry_in_float64_at_scale():
    """At 2^14 modes a float32 wrap and cell distance move each point by a
    fraction of a cell: the JAX package's type 1 misses 2e-5 against the
    direct sum at 64 sampled modes (it reads ~4e-4), the port's float64
    geometry holds it; likewise type 3 at max|x| max|s| ~ 2^14."""
    n, nj = 1 << 14, 2000
    x = _pts(nj)
    c = _coef(nj)
    ks = np.random.default_rng(5).choice(_k(n), 64, replace=False)
    ref = (c.astype(np.complex128)[None, :]
           * np.exp(1j * np.outer(ks, x.astype(np.float64)))).sum(1)
    got = _np(rt.nufft1d1(x, c, n, device=CPU))[ks + n // 2]
    theirs = np.asarray(R.nufft1d1(x, c, n))[ks + n // 2]
    assert _rel(got, ref) < 2e-5
    assert _rel(theirs, ref) > 2e-5
    s = np.concatenate([[-8192.0], RNG.uniform(-8192, 8192, 63)]).astype(
        np.float32)
    ref3 = direct3((x,), c, (s,), 1)
    assert _rel(rt.nufft1d3(x, c, s, device=CPU), ref3) < 2e-5
    assert _rel(np.asarray(R.nufft1d3(x, c, s)), ref3) > 2e-5


def test_unbatched_1d_grid_is_planned_as_a_row(monkeypatch):
    """An unbatched 1-D grid plans (1, 2n), so 4096..2M points take the
    four-step last axis on the card (a rank-1 axis takes the dense
    pipeline); a batched one plans (B, 2n); 2-D and 3-D grids as they are."""
    shapes = []
    plan = tnufft.grid_plan
    monkeypatch.setattr(tnufft, "grid_plan", lambda shape, *a: shapes.append(
        tuple(shape)) or plan(shape, *a))
    x, c = _pts(50), _coef((2, 50))
    rt.nufft1d1(x, c[0], 16, device=CPU)
    rt.nufft1d1(x, c, 16, device=CPU)
    rt.nufft1d2(x, _coef(16), device=CPU)
    rt.nufft2d1(x, x, c[0], 4, 6, device=CPU)
    rt.nufft1d3(x, c[0], x, device=CPU)
    assert shapes[:4] == [(1, 32), (2, 32), (1, 32), (8, 12)]
    assert len(shapes[4]) == 2 and shapes[4][0] == 1
    steps = rt.make_plan((1, 1 << 21), axes=(1,), device=CPU,
                         backend="hybrid").describe()
    assert "kernel-fourstep-last(n=2097152)" in steps
    assert "kernel-fourstep-last" not in rt.make_plan(
        (1 << 21,), axes=(0,), device=CPU, backend="hybrid").describe()


def test_spread_is_an_index_add():
    """The spread puts each weighted value at its taps: against a numpy
    np.add.at over the same stencil, and int64 indices throughout."""
    x = torch.from_numpy(_pts(40))
    c = _coef(40)
    n, p = 16, 6
    gr, gi = tnufft._spread_grid((x,), torch.from_numpy(c.real.copy()),
                                 torch.from_numpy(c.imag.copy()), (n,), p)
    idx, w = tnufft._grid_1d(x, n, p, tnufft._tau(n, p))
    assert idx.dtype == torch.int64
    ref = np.zeros(2 * n, np.complex128)
    np.add.at(ref, idx.numpy().ravel(),
              (c[:, None] * w.numpy().astype(np.float64)).ravel())
    assert np.abs((gr.numpy() + 1j * gi.numpy()) - ref).max() < 1e-5


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, c = _pts(10), _coef(10)
    for call in (lambda: rt.nufft1d1(x, c, 8), lambda: rt.nufft1d2(x, c),
                 lambda: rt.nufft2d1(x, x, c, 4, 4),
                 lambda: rt.nufft3d2(x, x, x, _coef((2, 2, 2))),
                 lambda: rt.nufft1d3(x, c, x),
                 lambda: rt.nufft2d3(x, x, c, x, x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
