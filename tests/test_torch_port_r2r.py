"""The port's real-to-real layer (``regent_fft_tpu_torch/ops/r2r.py``)
against scipy in float64, the textbook definitions and the JAX package on
the CPU, mirroring ``tests/test_r2r.py``.

Inputs are made with numpy from a seed.  Tolerances: ``_tol(n)`` =
2e-5 * max(1, log2 n) in rel_l2 against scipy/numpy float64 and between
the packages (the JAX suite's bound); float64 plans within
``tolerance(n, "complex128")`` = 8 * 2^-52 * sqrt(log2 n) of scipy.  The
host tables are the JAX package's exactly.  The kernel route (``fft_last``
on the card) runs here through ``fft_last_plain``, counted by a fixture.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from scipy import fft as sfft

import regent_fft_tpu as R
from regent_fft_tpu.ops import r2r as jr2r

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.ops import bluestein
from regent_fft_tpu_torch.ops import r2r as r2r_mod
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.ops.r2r import R2RKind, logical_size
from regent_fft_tpu_torch.utils.verify import tolerance

SIZES = [4, 5, 8, 12, 16, 27, 32]
CPU = "cpu"


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _tol(n):
    return 2e-5 * max(1.0, np.log2(max(n, 2)))


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _rel(got, ref):
    got = np.asarray(_np(got), dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.fixture
def fft_last_calls(monkeypatch):
    """Count the plain ``fft_last`` calls (each is a launch of the kernel
    on the card) and check the planes reaching it are contiguous."""
    calls = []
    plain = sk.fft_last_plain

    def counted(xr, xi, sign, scale=1.0):
        assert xr.is_contiguous() and xi.is_contiguous()
        calls.append((tuple(xr.shape), sign))
        return plain(xr, xi, sign, scale)
    monkeypatch.setattr(sk, "fft_last_plain", counted)
    return calls


@pytest.fixture
def kernel_route(monkeypatch):
    """Plans take the kernel pair as a CUDA device's do."""
    monkeypatch.setattr(bluestein, "_inner_kernel_pair",
                        lambda m, device: bluestein.kernel_pair(m))
    r2r_mod._R2R_CACHE.clear()
    yield
    r2r_mod._R2R_CACHE.clear()


# --- scipy parity (tests/test_r2r.py) ---------------------------------------
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("typ", [1, 2, 3, 4])
def test_dct_matches_scipy(n, typ):
    x = _x(n, seed=typ)
    ref = sfft.dct(x.astype(np.float64), typ)
    assert _rel(rt.dct(x, typ, device=CPU), ref) < _tol(n)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("typ", [1, 2, 3, 4])
def test_dst_matches_scipy(n, typ):
    x = _x(n, seed=10 + typ)
    ref = sfft.dst(x.astype(np.float64), typ)
    assert _rel(rt.dst(x, typ, device=CPU), ref) < _tol(n)


@pytest.mark.parametrize("n", SIZES)
def test_dht_definition_and_involution(n):
    x = _x(n, seed=3)
    j = np.arange(n)
    ang = 2 * np.pi * np.outer(j, j) / n
    ref = (np.cos(ang) + np.sin(ang)) @ x.astype(np.float64)
    got = rt.dht(x, device=CPU)
    assert _rel(got, ref) < _tol(n)
    back = rt.dht(got, device=CPU)
    assert _rel(back, n * x.astype(np.float64)) < _tol(n)


@pytest.mark.parametrize("n", SIZES)
def test_r2hc_hc2r_roundtrip_and_layout(n):
    x = _x(n, seed=4)
    hc = _np(rt.r2r(x, R2RKind.R2HC, device=CPU))
    h = np.fft.rfft(x.astype(np.float64))
    ref = np.concatenate([h.real[: n // 2 + 1], h.imag[1:(n + 1) // 2][::-1]])
    assert _rel(hc, ref) < _tol(n)
    back = rt.r2r(hc, R2RKind.HC2R, device=CPU)
    assert _rel(back, n * x.astype(np.float64)) < _tol(n)


def test_redft_rodft_inverse_pairs():
    """FFTW: REDFT10 then REDFT01 = RODFT10 then RODFT01 = 2n I; REDFT11,
    RODFT11 their own inverses up to 2n; REDFT00/RODFT00 up to their
    logical sizes."""
    n = 12
    x = _x(n, seed=5).astype(np.float64)
    pairs = [(R2RKind.REDFT10, R2RKind.REDFT01),
             (R2RKind.RODFT10, R2RKind.RODFT01),
             (R2RKind.REDFT11, R2RKind.REDFT11),
             (R2RKind.RODFT11, R2RKind.RODFT11),
             (R2RKind.REDFT00, R2RKind.REDFT00),
             (R2RKind.RODFT00, R2RKind.RODFT00)]
    for fwd, inv in pairs:
        y = rt.r2r(rt.r2r(x.astype(np.float32), fwd, device=CPU), inv,
                   device=CPU)
        assert _rel(y, logical_size(n, fwd) * x) < _tol(n), (fwd, inv)


def test_plan_r2r_nd_and_api(capsys):
    """Rank-2 mixed-kind plan against scipy axis by axis; destroy; a
    single kind on an axis subset."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    p = rt.plan_r2r(x.shape, (R2RKind.REDFT10, R2RKind.RODFT10), device=CPU)
    ref = sfft.dst(sfft.dct(x.astype(np.float64), 2, axis=0), 2, axis=1)
    assert _rel(p(x), ref) < _tol(12)
    assert p.flops > 0
    p.print_plan()
    assert "plan-r2r" in capsys.readouterr().out
    p.destroy()
    with pytest.raises(RuntimeError):
        p(x)
    p2 = rt.plan_r2r(x.shape, R2RKind.DHT, axes=(1,), device=CPU)
    j = np.arange(12)
    ang = 2 * np.pi * np.outer(j, j) / 12
    ref2 = x.astype(np.float64) @ (np.cos(ang) + np.sin(ang))
    assert _rel(p2(x), ref2) < _tol(12)


def test_r2r_validation():
    with pytest.raises(ValueError):
        rt.plan_r2r((8,), (R2RKind.REDFT10, R2RKind.REDFT10), device=CPU)
    with pytest.raises(ValueError):
        rt.dct(np.ones(8, np.float32), 5, device=CPU)
    with pytest.raises(TypeError):
        rt.plan_r2r((8,), R2RKind.DHT, device=CPU)(np.ones(8, np.complex64))
    with pytest.raises(TypeError):
        rt.plan_r2r((8,), R2RKind.DHT, device=CPU)(torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="planned"):
        rt.plan_r2r((8,), R2RKind.DHT, device=CPU)(np.ones(9, np.float32))
    with pytest.raises(ValueError):
        r2r_mod.build_r2r_1d(1, R2RKind.REDFT00)
    with pytest.raises(ValueError):
        r2r_mod.build_r2r_1d(0, R2RKind.DHT)
    with pytest.raises(TypeError):
        rt.dct(np.ones(8, np.complex64), device=CPU)
    with pytest.raises(ValueError, match="precision"):
        rt.plan_r2r((8,), R2RKind.DHT, precision="bogus", device=CPU)


def test_idct_idst_idht_inverses():
    n = 24
    x = np.random.default_rng(3).standard_normal((3, n)).astype(np.float32)
    for t in (1, 2, 3, 4):
        y = rt.idct(rt.dct(x, type=t, device=CPU), type=t, device=CPU)
        assert _rel(y, x.astype(np.float64)) < _tol(n), ("dct", t)
        y = rt.idst(rt.dst(x, type=t, device=CPU), type=t, device=CPU)
        assert _rel(y, x.astype(np.float64)) < _tol(n), ("dst", t)
    y = rt.idht(rt.dht(x, device=CPU), device=CPU)
    assert _rel(y, x.astype(np.float64)) < _tol(n)


@pytest.mark.parametrize("typ", [1, 2, 3, 4])
def test_dctn_dstn_match_scipy(typ):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 8, 10)).astype(np.float32)
    got = _np(rt.dctn(x, type=typ, axes=(1, 2), device=CPU))
    ref = sfft.dctn(np.asarray(x, np.float64), type=typ, axes=(1, 2))
    assert np.allclose(got, ref, rtol=2e-5, atol=2e-4 * np.abs(ref).max())
    got = _np(rt.dstn(x, type=typ, device=CPU))
    ref = sfft.dstn(np.asarray(x, np.float64), type=typ)
    assert np.allclose(got, ref, rtol=2e-5, atol=2e-4 * np.abs(ref).max())


def test_idctn_idstn_inverses():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    for fwd, inv in ((rt.dctn, rt.idctn), (rt.dstn, rt.idstn)):
        y = inv(fwd(x, type=2, device=CPU), type=2, device=CPU)
        assert np.allclose(_np(y), x, rtol=1e-4, atol=1e-3 * np.abs(x).max())


@pytest.mark.parametrize("typ", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_dct_dst_norms_match_scipy(typ, norm):
    x = np.random.default_rng(5 + typ).standard_normal((3, 20))
    for fam_f, fam_i, sp_f, sp_i in ((rt.dct, rt.idct, sfft.dct, sfft.idct),
                                     (rt.dst, rt.idst, sfft.dst, sfft.idst)):
        got = fam_f(x.astype(np.float32), type=typ, norm=norm, device=CPU)
        assert _rel(got, sp_f(x, type=typ, norm=norm)) < _tol(20), norm
        got = fam_i(x.astype(np.float32), type=typ, norm=norm, device=CPU)
        assert _rel(got, sp_i(x, type=typ, norm=norm)) < _tol(20), norm


@pytest.mark.parametrize("typ", [1, 2, 3])
@pytest.mark.parametrize("orth", [True, False])
def test_orthogonalize_matches_scipy(typ, orth):
    x = np.random.default_rng(9).standard_normal((2, 16))
    for fam, sp in ((rt.dct, sfft.dct), (rt.dst, sfft.dst)):
        got = fam(x.astype(np.float32), type=typ, norm="ortho",
                  orthogonalize=orth, device=CPU)
        ref = sp(x, type=typ, norm="ortho", orthogonalize=orth)
        assert _rel(got, ref) < _tol(16), (fam, typ, orth)


def test_orthogonalize_leaves_the_input_alone():
    x = torch.from_numpy(_x(16, seed=8))
    keep = x.clone()
    rt.dct(x, type=1, norm="ortho", device=CPU)
    assert torch.equal(x, keep)


def test_dct_n_crop_and_pad_match_scipy():
    x = np.random.default_rng(2).standard_normal((4, 18))
    for n in (12, 18, 24):
        got = _np(rt.dct(x.astype(np.float32), type=2, n=n, device=CPU))
        ref = sfft.dct(x, type=2, n=n)
        assert got.shape == ref.shape
        assert _rel(got, ref) < _tol(n)


def test_dctn_s_axes_norm_match_scipy():
    x = np.random.default_rng(4).standard_normal((4, 6, 8))
    got = _np(rt.dctn(x.astype(np.float32), type=3, s=(8, 10), axes=(0, 2),
                      norm="ortho", device=CPU))
    ref = sfft.dctn(x, type=3, s=(8, 10), axes=(0, 2), norm="ortho")
    assert got.shape == ref.shape
    assert _rel(got, ref) < _tol(10)
    with pytest.raises(ValueError):
        rt.dctn(x.astype(np.float32), s=(4,), axes=(0, 1), device=CPU)
    with pytest.raises(ValueError):
        rt.dstn(x.astype(np.float32), axes=(1, 1), device=CPU)
    with pytest.raises(ValueError):
        rt.dct(x.astype(np.float32), norm="bogus", device=CPU)
    with pytest.raises(ValueError, match="data points"):
        rt.dct(x.astype(np.float32), n=0, device=CPU)


def test_integer_input_promotes_to_float32():
    x = np.arange(12, dtype=np.int32)
    y = rt.dct(x, device=CPU)
    assert y.dtype == torch.float32
    assert _rel(y, sfft.dct(x.astype(np.float64))) < _tol(12)


# --- against the JAX package ------------------------------------------------
BUILD_SIZES = [4, 5, 8, 27, 32, 64, 511, 512, 513, 1000]


def _kernel_len(L):
    return L if 64 <= L <= sk.MAX_LAST_N and L & (L - 1) == 0 else None


@functools.lru_cache(maxsize=None)
def _jax_builds(n):
    """(inputs, outputs) of the JAX ``build_r2r_1d`` at length n, all
    eleven kinds in one jitted program (one compile per length)."""
    x = np.random.default_rng(n).standard_normal((11, 3, n)).astype(np.float32)
    fns = [jr2r.build_r2r_1d(n, int(k)) for k in R2RKind]
    out = jax.jit(lambda x: tuple(f(x[i]) for i, f in enumerate(fns)))(x)
    return x, [np.asarray(o) for o in out]


@pytest.mark.parametrize("n", BUILD_SIZES)
@pytest.mark.parametrize("kind", list(R2RKind))
def test_build_r2r_1d_matches_jax(n, kind, fft_last_calls):
    """Both the dense pair and the kernel pair (``fft_last_plain``) against
    JAX ``build_r2r_1d`` on f32 planes; the kernel route where L is a kernel
    length, one launch a call."""
    xs, refs = _jax_builds(n)
    x, ref = xs[int(kind)], refs[int(kind)]
    L = r2r_mod.core_length(n, kind)
    assert L == {R2RKind.REDFT00: 2 * (n - 1), R2RKind.RODFT00: 2 * (n + 1),
                 R2RKind.REDFT11: 2 * n, R2RKind.RODFT11: 2 * n}.get(kind, n)
    dense = r2r_mod.build_r2r_1d(n, kind)
    assert dense.kernel_len is None
    kern = r2r_mod.build_r2r_1d(n, kind, kernel_pair=bluestein.kernel_pair)
    assert kern.kernel_len == _kernel_len(L)
    backward = kind in (R2RKind.HC2R, R2RKind.REDFT01, R2RKind.RODFT01)
    for fn in (dense, kern):
        del fft_last_calls[:]
        y = fn(torch.from_numpy(x))
        assert y.dtype == torch.float32 and tuple(y.shape) == (3, n)
        assert _rel(y, ref) < _tol(n)
        assert fft_last_calls == ([((3, L), 1 if backward else -1)]
                                  if fn.kernel_len else [])


def test_kernel_lengths_of_the_chip_shapes():
    """The L the kernel sees: DST-I on 511 and DCT-I on 513 are 1024, DCT-IV
    and DST-IV on 512 are 1024, DCT-II on 1000 is 1000 (dense)."""
    assert r2r_mod.core_length(511, R2RKind.RODFT00) == 1024
    assert r2r_mod.core_length(513, R2RKind.REDFT00) == 1024
    assert r2r_mod.core_length(512, R2RKind.REDFT11) == 1024
    assert r2r_mod.core_length(512, R2RKind.RODFT11) == 1024
    assert r2r_mod.core_length(1000, R2RKind.REDFT10) == 1000
    assert bluestein.kernel_pair(1000) is None


def test_noncontiguous_rows_reach_the_kernel_contiguous(fft_last_calls):
    base = np.random.default_rng(1).standard_normal((4, 128)).astype(np.float32)
    view = torch.from_numpy(base)[:, ::2]
    assert not view.is_contiguous()
    for kind in (R2RKind.R2HC, R2RKind.DHT, R2RKind.REDFT10):
        fn = r2r_mod.build_r2r_1d(64, kind, kernel_pair=bluestein.kernel_pair)
        ref = np.asarray(jr2r.build_r2r_1d(64, int(kind))(base[:, ::2]))
        assert _rel(fn(view), ref) < _tol(64)
    assert len(fft_last_calls) == 3


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.mark.parametrize("n", [1, 2, 5, 8, 27, 512, 1000])
def test_host_tables_equal_jax(n):
    assert np.array_equal(r2r_mod._unreorder_perm(n), jr2r._unreorder_perm(n))
    assert r2r_mod._unreorder_perm(n).dtype == jr2r._unreorder_perm(n).dtype
    t3 = r2r_mod.host_tables(n, R2RKind.REDFT01)
    j3 = jr2r.build_r2r_1d(n, int(R2RKind.REDFT01))
    for ours, theirs in (("cr", "cr_np"), ("sr", "sr_np"),
                         ("not_first", "not_first")):
        assert np.array_equal(t3[ours], _closure(j3, theirs)), ours
    assert np.array_equal(t3["flip_idx"], np.asarray(_closure(j3, "flip_idx")))
    assert np.array_equal(t3["perm"], np.asarray(_closure(j3, "perm")))
    t4 = r2r_mod.host_tables(n, R2RKind.REDFT11)
    j4 = jr2r.build_r2r_1d(n, int(R2RKind.REDFT11))
    pre, post = _closure(j4, "pre"), _closure(j4, "post")
    for ours, theirs in (("pre_re", pre.real), ("pre_im", pre.imag),
                         ("post_re", post.real), ("post_im", post.imag)):
        assert np.array_equal(t4[ours], theirs), ours
    t2 = r2r_mod.host_tables(n, R2RKind.REDFT10)
    j2 = jr2r.build_r2r_1d(n, int(R2RKind.REDFT10))
    assert np.array_equal(t2["c2"], _closure(j2, "c2_np"))
    assert np.array_equal(t2["s2"], _closure(j2, "s2_np"))
    th = r2r_mod.host_tables(n, R2RKind.HC2R)
    jh = jr2r.build_r2r_1d(n, int(R2RKind.HC2R))
    for name in ("re_idx", "im_idx", "im_sign"):
        assert np.array_equal(th[name], _closure(jh, name)), name
    assert np.array_equal(r2r_mod.host_tables(n, R2RKind.RODFT10)["alt"],
                          jr2r._alt_signs(n))


@pytest.mark.parametrize("shape,kinds,axes", [
    ((8, 12), (R2RKind.REDFT10, R2RKind.RODFT10), None),
    ((6, 8, 10), R2RKind.REDFT00, (1, 2)),
    ((33,), R2RKind.HC2R, None),
    ((4, 5, 7), (R2RKind.RODFT00, R2RKind.DHT), (0, -1)),
    ((2, 1000), R2RKind.REDFT11, (1,))])
def test_description_and_flops_equal_jax(shape, kinds, axes):
    tp = rt.plan_r2r(shape, kinds, axes=axes, device=CPU)
    jp = R.plan_r2r(shape, kinds, axes=axes)
    assert tp.description == jp.description
    assert tp.flops == jp.flops
    assert tp.axes == jp.axes and tuple(map(int, tp.kinds)) == tuple(
        map(int, jp.kinds))
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    n = max(shape[a] for a in tp.axes)
    assert _rel(tp(x), np.asarray(jp(x))) < _tol(n)


@pytest.mark.parametrize("family,typ,norm", [
    ("dct", 1, "ortho"), ("dct", 2, None), ("dct", 3, "forward"),
    ("dct", 4, "ortho"), ("dst", 1, None), ("dst", 2, "ortho"),
    ("dst", 3, "ortho"), ("dst", 4, "forward")])
def test_one_shots_match_jax(family, typ, norm):
    x = np.random.default_rng(typ).standard_normal((5, 6, 9)).astype(np.float32)
    for suffix in ("", "n"):
        for inv in ("", "i"):
            name = f"{inv}{family}{suffix}"
            got = getattr(rt, name)(x, type=typ, norm=norm, device=CPU)
            ref = np.asarray(getattr(R, name)(x, type=typ, norm=norm))
            assert got.shape == ref.shape and _rel(got, ref) < _tol(9), name
    got = rt.idht(rt.dht(x, axis=1, device=CPU), axis=1, device=CPU)
    assert _rel(got, np.asarray(R.idht(R.dht(x, axis=1), axis=1))) < _tol(6)


# --- float64 ------------------------------------------------------------------
def _f64_ref(x, kind):
    n = x.shape[-1]
    if kind == R2RKind.R2HC:
        h = np.fft.rfft(x)
        return np.concatenate([h.real[..., : n // 2 + 1],
                               h.imag[..., 1:(n + 1) // 2][..., ::-1]], -1)
    if kind == R2RKind.DHT:
        h = np.fft.fft(x)
        return h.real - h.imag
    if kind == R2RKind.HC2R:
        k = np.arange(n)
        re = x[..., np.minimum(k, n - k) % n]
        head = (k >= 1) & (k < (n + 1) // 2)
        tail = k > n // 2
        im = np.where(head, x[..., (n - k) % n], 0) - np.where(tail, x[..., k], 0)
        return np.fft.ifft(re + 1j * im).real * n
    typ = {R2RKind.REDFT00: 1, R2RKind.REDFT10: 2, R2RKind.REDFT01: 3,
           R2RKind.REDFT11: 4, R2RKind.RODFT00: 1, R2RKind.RODFT10: 2,
           R2RKind.RODFT01: 3, R2RKind.RODFT11: 4}[kind]
    f = sfft.dct if kind.name.startswith("RE") else sfft.dst
    return f(x, typ)


@pytest.mark.parametrize("n", [27, 64])
@pytest.mark.parametrize("kind", list(R2RKind))
def test_float64_matches_scipy(n, kind, kernel_route, fft_last_calls):
    """float64 input computes in f64 on the dense pipeline, also where an
    f32 plan takes the kernel, within the complex128 tolerance."""
    x = np.random.default_rng(int(kind)).standard_normal((3, n))
    p = rt.plan_r2r(x.shape, kind, axes=(1,), device=CPU)
    y = p(x)
    assert y.dtype == torch.float64
    ref = _f64_ref(x, kind)
    assert _rel(y, ref) <= tolerance(r2r_mod.core_length(n, kind),
                                     "complex128")
    assert fft_last_calls == []


def _nd_ref(x, kind):
    for a in range(x.ndim):
        x = np.moveaxis(_f64_ref(np.moveaxis(x, a, -1), kind), -1, a)
    return x


def test_plan_launches_one_fft_last_per_axis(kernel_route, fft_last_calls):
    """A kernel-route plan runs one ``fft_last`` an axis; a DST adds what
    its DCT adds; an f32 axis whose L no kernel takes adds none."""
    x = np.random.default_rng(0).standard_normal((64, 64, 64)).astype(np.float32)
    for kind in (R2RKind.REDFT10, R2RKind.RODFT10, R2RKind.RODFT01,
                 R2RKind.REDFT11, R2RKind.RODFT11, R2RKind.DHT):
        p = rt.plan_r2r(x.shape, kind, device=CPU)
        assert [r[3] for r in p.routes] == ["kernel"] * 3
        del fft_last_calls[:]
        y = p(x)
        assert len(fft_last_calls) == 3, kind
        L = r2r_mod.core_length(64, kind)
        assert _rel(y, _nd_ref(x.astype(np.float64), kind)) < _tol(L), kind
    p = rt.plan_r2r((4, 1000), R2RKind.REDFT10, axes=(1,), device=CPU)
    assert p.routes == ((1, "REDFT10", 1000, "dense"),)
    del fft_last_calls[:]
    p(np.zeros((4, 1000), np.float32))
    assert fft_last_calls == []


def test_dstn_type1_on_the_kernel(kernel_route, fft_last_calls):
    """DST-I on 63-long axes has L = 128: three kernel launches."""
    x = np.random.default_rng(3).standard_normal((63, 63, 63)).astype(np.float32)
    y = rt.dstn(x, type=1, device=CPU)
    assert [s for s, _ in fft_last_calls] == [(63 * 63, 128)] * 3
    assert _rel(y, sfft.dstn(x.astype(np.float64), type=1)) < _tol(128)


# --- the plan cache -----------------------------------------------------------
def test_plan_cache_and_destroy_evicts():
    r2r_mod._R2R_CACHE.clear()
    p = rt.plan_r2r((8, 12), R2RKind.REDFT10, device=CPU)
    assert rt.plan_r2r((8, 12), R2RKind.REDFT10, device="cpu") is p
    assert rt.plan_r2r((8, 12), (R2RKind.REDFT10,) * 2, axes=(0, 1),
                       device=CPU) is p
    assert rt.plan_r2r((8, 12), R2RKind.REDFT10, device=CPU,
                       max_radix=64) is not p
    key = p._key
    assert key[-1] == "cpu" and r2r_mod._R2R_CACHE[key] is p
    rt.dct(np.ones((8, 12), np.float32), type=2, axis=1, device=CPU)
    n_cached = len(r2r_mod._R2R_CACHE)
    rt.dct(np.ones((8, 12), np.float32), type=2, axis=1, device=CPU)
    assert len(r2r_mod._R2R_CACHE) == n_cached
    p.destroy()
    assert key not in r2r_mod._R2R_CACHE
    q = rt.plan_r2r((8, 12), R2RKind.REDFT10, device=CPU)
    assert q is not p and r2r_mod._R2R_CACHE[key] is q


def test_tables_uploaded_once(monkeypatch):
    """A kind's tables go to the device when its function is built, at the
    planes' dtype; a call uploads nothing."""
    uploads = []
    upload = r2r_mod._upload

    def counted(tables, device, dtype):
        got = upload(tables, device, dtype)
        uploads.append({k: (v.device, v.dtype) for k, v in got.items()})
        return got
    monkeypatch.setattr(r2r_mod, "_upload", counted)
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(rng.standard_normal((2, 16))).to(dtype)
        for kind in R2RKind:
            for device in (CPU, None):      # None: the host
                fn = r2r_mod.build_r2r_1d(16, kind, device=device,
                                          dtype=dtype)
                for tabs in uploads:
                    for name, (dev, dt) in tabs.items():
                        assert dev == torch.device("cpu"), (kind, name)
                        assert dt == (torch.int64 if name.endswith(
                            ("idx", "perm")) else dtype), (kind, name)
                del uploads[:]
                fn(x)
                fn(x)
                assert uploads == [], kind


def test_hfft2_hfftn_match_scipy():
    """The Hermitian N-D transforms that close ``tests/test_r2r.py``, in
    the port: against scipy in float64 (``_tol(16)``; 1e-5 absolute for
    the inverse half spectra, the JAX suite's bounds)."""
    rng = np.random.default_rng(7)
    z = (rng.standard_normal((3, 6, 9))
         + 1j * rng.standard_normal((3, 6, 9))).astype(np.complex64)
    for fn, s in (("hfft2", None), ("hfftn", None), ("hfftn", (6, 6, 16))):
        ref = getattr(sfft, fn)(z.astype(np.complex128), s=s)
        got = _np(getattr(rt, fn)(z, s=s, device=CPU))
        assert got.shape == ref.shape, fn
        assert _rel(got, ref) < _tol(16), fn
    xr = rng.standard_normal((3, 6, 16)).astype(np.float32)
    for fn in ("ihfft2", "ihfftn"):
        ref = getattr(sfft, fn)(xr.astype(np.float64))
        got = _np(getattr(rt, fn)(xr, device=CPU))
        assert got.shape == ref.shape, fn
        assert np.abs(got - ref).max() < 1e-5, fn
