"""The port's guru layer (``regent_fft_tpu_torch/guru.py``: ``IODim``,
``GuruPlan``, ``plan_guru``, ``plan_many``, ``GuruR2RPlan``) against the
JAX package's on the same flat buffers, mirroring the C2C, R2C, C2R and
r2r cases of ``tests/test_guru.py``.

Inputs are made with numpy from a seed.  Tolerance: ``tolerance(n)`` =
8 * 2^-23 * sqrt(log2 n) for complex64 (n the transform's logical size),
against the JAX plan's output and numpy in float64; the layout checks
(spans, fast paths, refusals) must be the JAX package's exactly.
"""
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.dtypes import Norm as JNorm
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import guru
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm, SplitComplex
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance


def _rand_c(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _tuples(dims):
    """The port's IODims as (n, is, os) tuples, which the JAX package takes."""
    return [(d.n, d.ins, d.outs) if isinstance(d, guru.IODim) else d
            for d in dims]


def _pair(dims, howmany=(), kind=Kind.C2C, direction=Direction.FORWARD,
          norm=Norm.NONE, **kw):
    """(port GuruPlan on the CPU, JAX GuruPlan) of one layout."""
    tp = rt.plan_guru(dims, howmany, kind=kind, direction=direction,
                      norm=norm, device="cpu", **kw)
    jp = R.plan_guru(_tuples(dims), _tuples(howmany),
                     kind=JKind(kind.value),
                     direction=JDirection(int(direction)),
                     norm=JNorm(norm.value), **kw)
    for attr in ("in_size", "out_size", "in_is_transpose_view",
                 "out_is_transpose_view", "is_zero_copy"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    return tp, jp


def _check(tp, jp, x, n, ref=None):
    y = tp(x)
    assert y.device.type == "cpu" and y.ndim == 1
    assert tuple(y.shape) == (tp.out_size,)
    tol = tolerance(n)
    assert rel_l2(y, to_numpy_complex(jp(x))) <= tol
    if ref is not None:
        assert rel_l2(y, ref) <= tol
    return to_numpy_complex(y)


def test_iodim_and_index_maps_equal_jax():
    td = guru._as_iodims([(8, 3, 1), guru.IODim(5, 1, 8)])
    jd = R.guru._as_iodims([(8, 3, 1), R.guru.IODim(5, 1, 8)])
    assert td == tuple(guru.IODim(d.n, d.ins, d.outs) for d in jd)
    for which in ("in", "out"):
        assert np.array_equal(guru._index_map(td, which),
                              R.guru._index_map(jd, which))
        assert (guru._dense_permutation(td, which)
                == R.guru._dense_permutation(jd, which))


def test_guru_1d_contiguous_matches_numpy():
    n = 96
    x = _rand_c(n)
    tp, jp = _pair([(n, 1, 1)])
    _check(tp, jp, x, n, np.fft.fft(x.astype(np.complex128)))


def test_guru_strided_column_transform():
    r, c = 64, 5
    a = _rand_c((r, c), seed=1)
    tp, jp = _pair([guru.IODim(r, c, c)], [guru.IODim(c, 1, 1)])
    got = _check(tp, jp, a.reshape(-1), r)
    ref = np.fft.fft(a.astype(np.complex128), axis=0)
    assert rel_l2(got.reshape(r, c), ref) <= tolerance(r)


def test_guru_transposing_layout():
    r, c = 8, 16
    a = _rand_c((r, c), seed=2)
    tp, jp = _pair([guru.IODim(c, 1, r)], [guru.IODim(r, c, 1)])
    got = _check(tp, jp, a.reshape(-1), c)
    ref = np.fft.fft(a.astype(np.complex128), axis=1).T
    assert rel_l2(got.reshape(c, r), ref) <= tolerance(c)


def test_guru_interleaved_fields():
    n = 128
    x = _rand_c(2 * n, seed=3)
    tp, jp = _pair([guru.IODim(n, 2, 2)], [guru.IODim(2, 1, 1)])
    ref = np.empty(2 * n, np.complex128)
    ref[0::2] = np.fft.fft(x[0::2].astype(np.complex128))
    ref[1::2] = np.fft.fft(x[1::2].astype(np.complex128))
    _check(tp, jp, x, n, ref)


def test_guru_r2c_and_c2r_roundtrip():
    n, b = 64, 4
    x = np.random.default_rng(4).standard_normal((b, n)).astype(np.float32)
    fwd, jfwd = _pair([(n, 1, 1)], [(b, n, n // 2 + 1)], kind=Kind.R2C)
    ref = np.fft.rfft(x.astype(np.float64), axis=1)
    y = _check(fwd, jfwd, x.reshape(-1), n, ref.reshape(-1))
    assert fwd(x.reshape(-1)).dtype == torch.complex64
    inv, jinv = _pair([(n, 1, 1)], [(b, n // 2 + 1, n)], kind=Kind.C2R,
                      direction=Direction.BACKWARD, norm=Norm.BACKWARD)
    back = inv(y.astype(np.complex64))
    assert back.dtype == torch.float32
    assert rel_l2(back, to_numpy_complex(jinv(y.astype(np.complex64)))) \
        <= tolerance(n)
    assert rel_l2(back.reshape(b, n), x) <= tolerance(n)


def test_plan_many_matches_reference_batch_semantics():
    n, howmany = 80, 6
    x = _rand_c((howmany, n), seed=5)
    tp = rt.plan_many([n], howmany, device="cpu")
    jp = R.plan_many([n], howmany)
    ref = np.fft.fft(x.astype(np.complex128), axis=1).reshape(-1)
    _check(tp, jp, x.reshape(-1), n, ref)


def test_plan_many_2d_strided_dist():
    n1, n2, howmany, gap = 8, 12, 3, 7
    dist = n1 * n2 + gap
    rng = np.random.default_rng(6)
    buf = (rng.standard_normal(howmany * dist)
           + 1j * rng.standard_normal(howmany * dist)).astype(np.complex64)
    tp = rt.plan_many([n1, n2], howmany, idist=dist, odist=dist, device="cpu")
    jp = R.plan_many([n1, n2], howmany, idist=dist, odist=dist)
    got = _check(tp, jp, buf, n1 * n2)
    for b in range(howmany):
        blk = buf[b * dist:b * dist + n1 * n2].reshape(n1, n2)
        g = got[b * dist:b * dist + n1 * n2].reshape(n1, n2)
        assert rel_l2(g, np.fft.fft2(blk.astype(np.complex128))) \
            <= tolerance(n1 * n2)
        assert np.all(got[b * dist + n1 * n2:(b + 1) * dist] == 0)


def test_plan_many_r2c_default_dist():
    n, howmany = 32, 5
    x = np.random.default_rng(7).standard_normal((howmany, n)).astype(
        np.float32)
    tp = rt.plan_many([n], howmany, kind=Kind.R2C, device="cpu")
    jp = R.plan_many([n], howmany, kind=JKind.R2C)
    ref = np.fft.rfft(x.astype(np.float64), axis=1).reshape(-1)
    _check(tp, jp, x.reshape(-1), n, ref)


@pytest.mark.parametrize("kind", [Kind.C2C, Kind.R2C, Kind.C2R])
def test_plan_many_interleaved_fields_every_kind(kind):
    """Two fields interleaved (istride 2, idist 2 n): the chip run's
    ``plan_many`` layout, here at a Bluestein length too."""
    for n in (64, 1009):
        howmany = 3
        direction = (Direction.BACKWARD if kind == Kind.C2R
                     else Direction.FORWARD)
        h = n // 2 + 1 if kind == Kind.C2R else n
        tp = rt.plan_many([n], howmany, istride=2, idist=2 * h, kind=kind,
                          direction=direction, device="cpu")
        jp = R.plan_many([n], howmany, istride=2, idist=2 * h,
                         kind=JKind(kind.value),
                         direction=JDirection(int(direction)))
        assert tp.in_size == jp.in_size and tp.out_size == jp.out_size
        if kind == Kind.R2C:
            x = np.random.default_rng(n).standard_normal(
                howmany * 2 * h).astype(np.float32)
        else:
            x = _rand_c(howmany * 2 * h, n)
        _check(tp, jp, x, n)


def test_guru_complex32_and_complex128():
    n, b = 128, 4
    x = _rand_c(b * n, 8)
    p32 = rt.plan_guru([(n, b, b)], [(b, 1, 1)], dtype="complex32",
                       device="cpu")
    y = p32(x)
    assert isinstance(y, SplitComplex) and y.re.dtype == torch.bfloat16
    xd = x.astype(np.complex128).reshape(n, b)
    ref = np.fft.fft(xd, axis=0).reshape(-1)
    assert rel_l2(y, ref) <= tolerance(n, "complex32")
    p128 = rt.plan_guru([(n, b, b)], [(b, 1, 1)], dtype="complex128",
                        device="cpu")
    z = p128(xd.reshape(-1))
    assert z.dtype == torch.complex128
    assert rel_l2(z, ref) <= tolerance(n, "complex128")


def test_guru_rejects_overlapping_output():
    with pytest.raises(ValueError, match="overlap"):
        rt.plan_guru([guru.IODim(16, 1, 0)], device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        rt.plan_guru([guru.IODim(8, 1, 1)], [guru.IODim(2, 8, 4)],
                     device="cpu")


def test_guru_rejects_negative_and_short_buffers():
    with pytest.raises(ValueError, match="negative"):
        rt.plan_guru([guru.IODim(8, -1, 1)], device="cpu")
    p = rt.plan_guru([guru.IODim(16, 1, 1)], device="cpu")
    with pytest.raises(ValueError, match="length"):
        p(_rand_c(8))
    with pytest.raises(ValueError, match="FLAT"):
        p(_rand_c((4, 4)))
    with pytest.raises(ValueError, match="out_size"):
        rt.plan_guru([guru.IODim(16, 1, 1)], out_size=8, device="cpu")


def test_guru_describe_mentions_layout():
    tp, jp = _pair([guru.IODim(16, 2, 2)], [guru.IODim(2, 1, 1)])
    d = tp.describe()
    assert "guru-c2c" in d and "is=2" in d
    assert d.splitlines()[0] == jp.describe().splitlines()[0]


def test_guru_transposed_layout_uses_relayout_fast_path():
    n, b = 64, 32
    tp, jp = _pair([guru.IODim(n, b, b)], [guru.IODim(b, 1, 1)])
    assert tp.in_is_transpose_view and tp.out_is_transpose_view
    x = _rand_c(n * b)
    ref = np.fft.fft(x.astype(np.complex128).reshape(n, b), axis=0)
    _check(tp, jp, x, n, ref.reshape(-1))


def test_guru_nondense_layout_takes_gather_path():
    tp, jp = _pair([guru.IODim(16, 2, 2)])
    assert not tp.in_is_transpose_view and not tp.out_is_transpose_view
    x = _rand_c(32)
    y = _check(tp, jp, x, 16)
    ref = np.fft.fft(x.astype(np.complex128)[0:32:2])
    assert rel_l2(y[0:32:2], ref) <= tolerance(16)


def test_guru_zero_copy_buffer_layout():
    n, b = 64, 32
    tp, _ = _pair([guru.IODim(n, b, b)], [guru.IODim(b, 1, 1)])
    assert tp.is_zero_copy
    q, jq = _pair([guru.IODim(n, b, 1)], [guru.IODim(b, 1, n)])
    assert not q.is_zero_copy
    x = _rand_c(n * b)
    ref = np.fft.fft(x.astype(np.complex128).reshape(n, b), axis=0).T
    _check(q, jq, x, n, ref.reshape(-1))


def test_guru_r2r_names_its_roadmap_item():
    """Queue 1 #9 is done: plan_guru_r2r plans (it raised, naming the
    item, before the r2r kinds were ported)."""
    p = guru.plan_guru_r2r([(8, 1, 1)], 0, device="cpu")
    assert isinstance(p, guru.GuruR2RPlan)
    x = np.random.default_rng(0).standard_normal(8).astype(np.float32)
    h = np.fft.rfft(x.astype(np.float64))
    ref = np.concatenate([h.real[:5], h.imag[1:4][::-1]])
    assert rel_l2(p(x), ref) <= tolerance(8)


# --- guru r2r (tests/test_guru.py:148-180) ----------------------------------
def _r2r_pair(dims, kinds, howmany=(), **kw):
    """(port GuruR2RPlan on the CPU, JAX GuruR2RPlan) of one layout."""
    tp = rt.plan_guru_r2r(dims, kinds, howmany, device="cpu", **kw)
    jp = R.plan_guru_r2r(_tuples(dims), R.R2RKind(int(kinds))
                         if isinstance(kinds, int) else
                         tuple(R.R2RKind(int(k)) for k in kinds),
                         _tuples(howmany), **kw)
    assert (tp.in_size, tp.out_size) == (jp.in_size, jp.out_size)
    assert tp.describe() == jp.describe()
    return tp, jp


def test_guru_r2r_strided_dct_matches_dense():
    """The transform dim strided by b (a transposed layout), the batch dim
    stride 1, against scipy in float64 and the JAX plan (1e-4, the JAX
    suite's bound, and tolerance(n) between the packages)."""
    import scipy.fft as sfft
    n, b = 32, 8
    tp, jp = _r2r_pair([(n, b, b)], rt.R2RKind.REDFT10, [(b, 1, 1)])
    x = np.random.default_rng(5).standard_normal(n * b).astype(np.float32)
    y = tp(x)
    assert y.dtype == torch.float32 and tuple(y.shape) == (n * b,)
    ref = sfft.dct(x.reshape(n, b).astype(np.float64), type=2, axis=0)
    assert rel_l2(y.reshape(n, b), ref) < 1e-4
    assert rel_l2(y, np.asarray(jp(x))) <= tolerance(n)


def test_guru_r2r_mixed_kinds_2d():
    import scipy.fft as sfft
    n1, n2 = 8, 16
    tp, jp = _r2r_pair([(n1, n2, n2), (n2, 1, 1)],
                       (rt.R2RKind.REDFT10, rt.R2RKind.RODFT10))
    x = np.random.default_rng(5).standard_normal((n1, n2)).astype(np.float32)
    y = tp(x.ravel()).reshape(n1, n2)
    ref = sfft.dst(sfft.dct(x.astype(np.float64), type=2, axis=0),
                   type=2, axis=1)
    assert rel_l2(y, ref) < 1e-4
    assert rel_l2(y.reshape(-1), np.asarray(jp(x.ravel()))) <= tolerance(
        n1 * n2)


def test_guru_r2r_overlapping_output_rejected():
    with pytest.raises(ValueError):
        rt.plan_guru_r2r(dims=[(8, 1, 0)], kinds=rt.R2RKind.DHT, device="cpu")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 5, 7, 10])
def test_guru_r2r_interleaved_fields_match_jax(kind):
    """Field 0 of two interleaved fields (``is`` = 2), output dense with a
    padded ``out_size``; float64 input is cast to float32 as in JAX."""
    n, b = 24, 5
    tp, jp = _r2r_pair([(n, 2, 1)], kind, [(b, 2 * n, n)],
                       out_size=n * b + 3)
    x = np.random.default_rng(kind).standard_normal(2 * n * b)
    y = tp(x)
    assert y.dtype == torch.float32 and tuple(y.shape) == (n * b + 3,)
    assert np.all(y[n * b:].numpy() == 0)
    assert rel_l2(y, np.asarray(jp(x.astype(np.float32)))) <= 2e-5 * np.log2(
        2 * n + 2)


def test_guru_r2r_validation_and_kernel_route(monkeypatch):
    from regent_fft_tpu_torch.ops import bluestein, r2r as r2r_mod
    from regent_fft_tpu_torch.ops import stockham_kernels as sk
    tp = rt.plan_guru_r2r([(64, 2, 1)], rt.R2RKind.REDFT10, [(4, 128, 64)],
                          device="cpu")
    with pytest.raises(ValueError, match="FLAT"):
        tp(np.zeros((2, 256), np.float32))
    with pytest.raises(ValueError, match="span"):
        tp(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="kinds for"):
        rt.plan_guru_r2r([(8, 1, 1), (4, 8, 8)], (0, 1, 2), device="cpu")
    # as on a CUDA device: one fft_last launch for the one transform dim
    monkeypatch.setattr(bluestein, "_inner_kernel_pair",
                        lambda m, device: bluestein.kernel_pair(m))
    r2r_mod._R2R_CACHE.clear()
    calls = []
    plain = sk.fft_last_plain
    monkeypatch.setattr(sk, "fft_last_plain", lambda *a: calls.append(
        tuple(a[0].shape)) or plain(*a))
    tk = rt.plan_guru_r2r([(64, 2, 1)], rt.R2RKind.REDFT10, [(4, 128, 64)],
                          device="cpu")
    x = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    assert rel_l2(tk(x), tp(x)) <= tolerance(64)
    assert calls == [(4, 64)]
    r2r_mod._R2R_CACHE.clear()


def test_guru_plan_runs_on_the_plan_device(monkeypatch):
    """Index tensors live on the plan's device; a plan made for the default
    "cuda" without a card raises like every plan."""
    p = rt.plan_guru([guru.IODim(16, 2, 2)], device="cpu")
    assert p._plan.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.plan_guru([guru.IODim(16, 2, 2)])
