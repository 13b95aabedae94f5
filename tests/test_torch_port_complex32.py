"""complex32 (split bf16 planes, f32 compute) in the port against the JAX
package on the CPU.

Inputs are made with numpy from a seed and rounded to bf16 once, so both
packages and the float64 reference see the same values.  Every tolerance
is ``tolerance(n, "complex32")`` = 8 * 2^-8 * sqrt(log2 n), the JAX
package's bound for bf16 planes (``tests/test_complex32.py``): one bf16
rounding of the output (relative 2^-9) is 1.7e-3 in rel_l2, and the
TPU-side bodies add at most a few of those.  The port's plain versions run
the JAX tile bodies (``_direct_tile``, ``_mxu_tile_tw``, ``_stockham_tile``)
at full f32 on the CPU, as the JAX runners do in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.dtypes import Norm as JNorm
from regent_fft_tpu.dtypes import SplitComplex as JSplit
from regent_fft_tpu.ops import pallas_stockham as jps
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm, SplitComplex
from regent_fft_tpu_torch.ops import fourstep as tfs
from regent_fft_tpu_torch.ops import stockham_kernels as tsk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _bf16(x):
    """(torch bf16 planes, jax bf16 planes, the bf16-rounded complex128)."""
    tr = torch.from_numpy(np.ascontiguousarray(x.real)).to(torch.bfloat16)
    ti = torch.from_numpy(np.ascontiguousarray(x.imag)).to(torch.bfloat16)
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    jr = jnp.asarray(x.real, jnp.bfloat16)
    ji = jnp.asarray(x.imag, jnp.bfloat16)
    return SplitComplex(tr, ti), JSplit(jr, ji), xd


def _step_lines(text):
    return [ln.strip() for ln in text.splitlines() if ln.startswith("  (")]


def _ref(xd, axes, direction, scale=1.0):
    if direction == Direction.FORWARD:
        return np.fft.fftn(xd, axes=axes) * scale
    return np.fft.ifftn(xd, axes=axes, norm="forward") * scale


# --- the copied tables and gates ---------------------------------------------
def test_mxu_gates_equal_over_all_lengths():
    for n in range(1, 4200):
        assert tsk._mxu_split(n) == jps._mxu_split(n), n
        assert tsk.mxu_tile_supported(n) == jps.mxu_tile_supported(n), n


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
def test_bf16_tile_tables_bit_identical(n, sign):
    for a, b in zip(tsk._direct_tables(n, sign), jps._direct_tables(n, sign)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    for a, b in zip(tsk._mxu_tw_tables(n, sign), jps._mxu_tw_tables(n, sign)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_tile_impl_choice_equal(io, monkeypatch):
    monkeypatch.delenv("REGENT_FFT_MXU_IMPL", raising=False)
    gated = [n for n in range(2, tsk.MAX_STOCKHAM_N + 1)
             if tsk.kernel_len_ok(n, False)]
    assert len(gated) > 20
    for n in gated:
        want = jps._tile_impl(io, n)[0].__name__.lstrip("_")
        assert tsk.tile_impl(io, n) == want, (io, n)


# --- the plain bf16 runners against the JAX runners in interpret mode ---------
LAST = [(33, 256), (16, 1024), (8, 2048), (24, 32), (16, 384)]
MID = [(2, 256, 128), (1, 1024, 128)]
PAIR = [(2, 64, 256), (1, 256, 512)]


def _runner_case(shape, axes, sign, scaled, port_fn, jax_fn):
    x = _crand(shape, 17)
    tx, jx, xd = _bf16(x)
    n = int(np.prod([shape[a] for a in axes]))
    scale = 1.0 / n if scaled else 1.0
    d = Direction(sign)
    yr, yi = port_fn(tx.re, tx.im, d, scale)
    assert yr.dtype == yi.dtype == torch.bfloat16
    assert tuple(yr.shape) == shape
    jr, ji = jax_fn(jx.re, jx.im, JDirection(sign), scale)
    y = SplitComplex(yr, yi)
    tol = tolerance(n, "complex32")
    assert rel_l2(y, to_numpy_complex(JSplit(jr, ji))) <= tol
    assert rel_l2(y, _ref(xd, axes, d, scale)) <= tol


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("shape", LAST)
def test_last_axis_bf16_plain_matches_jax_runner(shape, sign, scaled):
    _runner_case(
        shape, (1,), sign, scaled,
        lambda r, i, d, s: tsk.fft_axis_stockham(r, i, -1, d, scale=s),
        lambda r, i, d, s: jps.fft_axis_stockham(r, i, -1, d, scale=s,
                                                 interpret=True))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("shape", MID)
def test_mid_axis_bf16_plain_matches_jax_runner(shape, sign, scaled):
    _runner_case(
        shape, (1,), sign, scaled,
        lambda r, i, d, s: tsk.fft_axis_stockham(r, i, 1, d, scale=s),
        lambda r, i, d, s: jps.fft_axis_stockham(r, i, 1, d, scale=s,
                                                 interpret=True))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("shape", PAIR)
def test_fused2_bf16_plain_matches_jax_runner(shape, sign, scaled):
    _runner_case(
        shape, (1, 2), sign, scaled,
        lambda r, i, d, s: tsk.fft_axes2_stockham(r, i, d, scale=s),
        lambda r, i, d, s: jps.fft_axes2_stockham(r, i, d, scale=s,
                                                  interpret=True))


def test_plain_bodies_follow_tile_impl():
    """Each bf16 body is the one the JAX tile choice names, and each is a
    DFT at f32 accuracy on f32 input (the bf16 rounding is only at the
    ends)."""
    for n, body in ((256, "direct_tile"), (1024, "mxu_tile_tw"),
                    (2048, "mxu_tile_tw"), (384, "stockham_tile"),
                    (32, "stockham_tile")):
        assert tsk.tile_impl("bf16", n) == body
        x = _crand((n, 6), n)
        xr = torch.from_numpy(np.ascontiguousarray(x.real))
        xi = torch.from_numpy(np.ascontiguousarray(x.imag))
        y = torch.complex(*tsk._TILES[body](xr, xi, n, -1))
        assert rel_l2(y, np.fft.fft(x.astype(np.complex128), axis=0)) \
            <= tolerance(n)


def test_dtype_vocabulary_matches_jax():
    from regent_fft_tpu import dtypes as jdt
    from regent_fft_tpu_torch import dtypes as tdt
    for d in ("complex32", "complex64", "complex128", "float32", "float64",
              "bfloat16", np.complex64, np.complex128, np.float32,
              np.float64):
        assert tdt.canonical_dtype(d) == jdt.canonical_dtype(d), d
    assert tdt.canonical_dtype(SplitComplex) == "complex32"
    assert tdt.canonical_dtype(torch.bfloat16) == "bfloat16"
    assert tdt.canonical_dtype(torch.complex128) == "complex128"
    with pytest.raises(ValueError):
        tdt.canonical_dtype("int8")
    assert tdt.COMPLEX_DTYPES == jdt.COMPLEX_DTYPES
    x = _crand((3, 8), 2)
    for name, pd in tdt.PLANE_DTYPES.items():
        s = tdt.as_split(x, "cpu", name)
        assert s.dtype == pd and s.re.is_contiguous()
        out = tdt.from_split(s, name)
        if name == "complex32":
            assert isinstance(out, SplitComplex) and out.dtype == pd
        else:
            assert out.dtype == {"complex64": torch.complex64,
                                 "complex128": torch.complex128}[name]
        assert rel_l2(out, x) <= tolerance(8, name)


def test_bf16_planes_reject_other_dtypes():
    x = torch.zeros(4, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        tsk.fft_last(x, x, -1)
    b = torch.zeros(2, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tfs.fft_cols_tw(b, b, -1)


# --- complex32 plans against the JAX package's complex32 plans ----------------
PLAN_CASES = [((32, 1024), (1,), "stockham"), ((8, 8, 8), (0, 1, 2), "xla"),
              ((4, 64, 256), (0, 1, 2), "stockham"),
              ((2, 4096), (1,), "stockham")]


@pytest.mark.parametrize("norm", list(Norm))
@pytest.mark.parametrize("shape,axes,backend", PLAN_CASES)
def test_complex32_plan_matches_jax(shape, axes, backend, norm):
    x = _crand(shape, 23)
    tx, jx, xd = _bf16(x)
    jp = R.make_plan(shape, axes=axes, kind=JKind.C2C,
                     direction=JDirection.FORWARD, norm=JNorm(norm.value),
                     backend=backend, dtype="complex32")
    tp = rt.make_plan(shape, axes=axes, kind=Kind.C2C,
                      direction=Direction.FORWARD, norm=norm,
                      backend=backend, dtype="complex32", device="cpu")
    assert tp.spec.precision == jp.spec.precision == "default"
    assert tp.spec.use_3m and jp.spec.use_3m
    assert tp.cdtype == torch.bfloat16
    y = tp(tx)
    jy = jp(jx)
    assert isinstance(y, SplitComplex) and isinstance(jy, JSplit)
    assert y.re.dtype == torch.bfloat16 and jy.re.dtype == jnp.bfloat16
    assert y.shape == shape
    assert _step_lines(tp.describe())[:-1] == _step_lines(jp.describe())[:-1]
    n = tp.spec.logical_n
    tol = tolerance(n, "complex32")
    assert rel_l2(y, to_numpy_complex(jy)) <= tol
    assert rel_l2(y, _ref(xd, axes, Direction.FORWARD,
                          rt.plan._norm_scale(tp.spec))) <= tol
    inv = tp.inverse()
    assert inv.spec.dtype == "complex32"
    back = inv(y)
    assert isinstance(back, SplitComplex) and back.re.dtype == torch.bfloat16
    assert rel_l2(back, xd) <= 2 * tol


def test_main_path_complex32_step_lists():
    """The shapes the chip run drives: the same kernel steps as complex64
    (fused pair + leading-axis butterfly at 512^3)."""
    def f(shape, axes):
        return _step_lines(rt.make_plan(shape, axes=axes, backend="stockham",
                                        dtype="complex32",
                                        device="cpu").describe())[:-1]
    assert f((512, 512, 512), (0, 1, 2)) == [
        "(axis 1: kernel-fused2(512, 512))",
        "(axis 0: kernel-butterfly(n=512))"]
    assert f((4096, 1024), (1,)) == ["(axis 1: kernel-butterfly(n=1024))"]
    assert f((16, 512, 512), (1, 2)) == ["(axis 1: kernel-fused2(512, 512))"]


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_complex32_real_plans_match_jax(kind):
    """Real-kind complex32 computes in f32 and rounds the output to bf16."""
    shape, axes = (4, 16, 256), (1, 2)
    rng = np.random.default_rng(31)
    xr = rng.standard_normal(shape).astype(np.float32)
    if kind == "r2c":
        jp = R.make_plan(shape, axes=axes, kind=JKind.R2C,
                         direction=JDirection.FORWARD, dtype="complex32",
                         backend="stockham")
        tp = rt.make_plan(shape, axes=axes, kind=Kind.R2C,
                          direction=Direction.FORWARD, dtype="complex32",
                          backend="stockham", device="cpu")
        y, jy = tp(xr), jp(xr)
        assert isinstance(y, SplitComplex) and y.re.dtype == torch.bfloat16
        ref = np.fft.rfftn(xr.astype(np.float64), axes=axes)
    else:
        h = np.fft.rfftn(xr.astype(np.float64), axes=axes).astype(np.complex64)
        jp = R.make_plan(shape, axes=axes, kind=JKind.C2R,
                         direction=JDirection.BACKWARD, dtype="complex32",
                         backend="stockham")
        tp = rt.make_plan(shape, axes=axes, kind=Kind.C2R,
                          direction=Direction.BACKWARD, dtype="complex32",
                          backend="stockham", device="cpu")
        y, jy = tp(h), jp(h)
        assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
        ref = xr.astype(np.float64)
    assert tp.cdtype == torch.float32
    assert _step_lines(tp.describe())[:-1] == _step_lines(jp.describe())[:-1]
    tol = tolerance(tp.spec.logical_n, "complex32")
    assert rel_l2(y, to_numpy_complex(jy)) <= tol
    assert rel_l2(y, ref) <= tol


@pytest.mark.parametrize("shape,axes,fields", [
    ((16, 256, 256), (0, 1, 2), dict(axis0_impl="dma")),
    ((64, 64, 1024), (0,), dict(axis0_impl="fourstep")),
    ((4, 64, 256), (0, 1, 2), dict(f2_impl="ring")),
])
def test_complex32_explicit_routes_raise(shape, axes, fields):
    """The explicit leading-axis routes on complex32: the plans build, print
    the step lines of the complex64 plans (those the JAX plan prints on the
    TPU), keep the SplitComplex of bf16 planes and match numpy, both ways.
    (64, 64, 1024) has r1 = 8: its four-step runs on f32 planes, as in the
    JAX package, and the plan still returns bf16."""
    p = rt.make_plan(shape, axes=axes, backend="stockham", dtype="complex32",
                     device="cpu", **fields)
    f = rt.make_plan(shape, axes=axes, backend="stockham", device="cpu",
                     **fields)
    assert _step_lines(p.describe())[:-1] == _step_lines(f.describe())[:-1]
    route = {"dma": "kernel-dma-ring", "fourstep": "kernel-fourstep-ring",
             "ring": "kernel-fused2-ring"}[next(iter(fields.values()))]
    assert route in p.describe()
    x = _crand(shape, 43)
    tx, _, xd = _bf16(x)
    y = p(tx)
    assert isinstance(y, SplitComplex) and y.re.dtype == torch.bfloat16
    tol = tolerance(p.spec.logical_n, "complex32")
    assert rel_l2(y, _ref(xd, axes, Direction.FORWARD)) <= tol
    back = p.inverse()(y)
    assert isinstance(back, SplitComplex) and back.re.dtype == torch.bfloat16
    assert rel_l2(back, xd) <= 2 * tol


def test_four_step_last_axis_bf16_matches_jax():
    x = _crand((2, 8192), 41)
    tx, jx, xd = _bf16(x)
    yr, yi = tfs.fft_last_four_step(tx.re, tx.im, Direction.BACKWARD, 0.25)
    assert yr.dtype == torch.bfloat16
    jr, ji = jps.fft_last_four_step(jx.re, jx.im, JDirection.BACKWARD, 0.25,
                                    interpret=True)
    tol = tolerance(8192, "complex32")
    y = SplitComplex(yr, yi)
    assert rel_l2(y, to_numpy_complex(JSplit(jr, ji))) <= tol
    assert rel_l2(y, _ref(xd, (1,), Direction.BACKWARD, 0.25)) <= tol


# --- the SplitComplex input: complex32 in both packages (api.py:36-37) --------
@pytest.mark.parametrize("fn", ["fft", "ifft", "fft2", "fftn", "ifftn"])
def test_split_input_is_complex32_in_both_packages(fn):
    x = _crand((4, 16, 32), 47)
    tx, jx, xd = _bf16(x)
    y = getattr(rt, fn)(tx, device="cpu")
    jy = getattr(R, fn)(jx)
    assert isinstance(y, SplitComplex) and y.re.dtype == torch.bfloat16
    assert isinstance(jy, JSplit) and jy.re.dtype == jnp.bfloat16
    n = {"fft": 32, "ifft": 32, "fft2": 16 * 32}.get(fn, x.size)
    tol = tolerance(n, "complex32")
    assert rel_l2(y, to_numpy_complex(jy)) <= tol
    ref = getattr(np.fft, fn)(xd)
    assert rel_l2(y, ref) <= tol


# --- the five cases of tests/test_complex32.py, on the port -------------------
RNG = np.random.default_rng(5)


def _split32(x):
    return _bf16(x)[0]


def test_complex32_fft_accuracy():
    n = 256
    x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(np.complex64)
    y = rt.fft(_split32(x), device="cpu")
    assert isinstance(y, SplitComplex)
    assert y.re.dtype == torch.bfloat16
    assert rel_l2(y, np.fft.fft(x)) < tolerance(n, "complex32")


def test_complex32_spec_downgrades_precision():
    spec = rt.PlanSpec(shape=(64,), axes=(0,), kind=Kind.C2C,
                       direction=Direction.FORWARD, dtype="complex32",
                       device="cpu")
    assert spec.precision == "default"
    assert spec.use_3m


def test_complex32_roundtrip():
    n = 128
    x = (RNG.standard_normal((4, n))
         + 1j * RNG.standard_normal((4, n))).astype(np.complex64)
    y = rt.ifft(rt.fft(_split32(x), device="cpu"), device="cpu")
    assert rel_l2(y, x) < tolerance(n, "complex32")


def test_complex32_3d():
    x = (RNG.standard_normal((8, 8, 8))
         + 1j * RNG.standard_normal((8, 8, 8))).astype(np.complex64)
    y = rt.fftn(_split32(x), device="cpu")
    assert rel_l2(y, np.fft.fftn(x)) < tolerance(512, "complex32")


def test_complex32_large_axis_fourstep_tile():
    """n = 1024 is past the direct tile's cap (512): bf16 blocks take the
    twiddle-folded four-step body."""
    rng = np.random.default_rng(5)
    shape = (32, 1024)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    spec = rt.PlanSpec(shape=shape, axes=(1,), kind=Kind.C2C,
                       direction=Direction.FORWARD, norm=Norm.NONE,
                       dtype="complex32", backend="stockham", device="cpu")
    plan = rt.make_plan(spec)
    assert tsk.tile_impl("bf16", 1024) == "mxu_tile_tw"
    got = plan(x)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    rel = rel_l2(got, ref)
    assert rel < tolerance(1024, "complex32"), rel
