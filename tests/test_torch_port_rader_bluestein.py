"""Rader and Bluestein in the port (``ops/rader.py``, ``ops/bluestein.py``
and their branches of ``stockham.build_c2c_1d``) against the JAX package on
the CPU, mirroring ``tests/test_rader.py``.

Inputs are made with numpy from a seed.  Tolerances: ``tolerance(n,
dtype)`` = 8 * eps * sqrt(log2 n) (eps 2^-8, 2^-23, 2^-52 for complex32,
complex64, complex128), the JAX package's own bound, against numpy in
float64 and between the packages; the tables are bit-identical copies, so
the two packages differ only in summation order.  The kernel-inner
Bluestein path runs ``fft_last_plain`` here, as a CUDA plan runs
``fft_last``; the sweep builds every length 1..4096 without the cache.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.dtypes import Norm as JNorm
from regent_fft_tpu.dtypes import SplitComplex as JSplit
from regent_fft_tpu.ops import bluestein as jblue
from regent_fft_tpu.ops import factor as jfactor
from regent_fft_tpu.ops import rader as jrader
from regent_fft_tpu.ops import stockham as jstockham
from regent_fft_tpu.ops import twiddle as jtwiddle
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm, SplitComplex
from regent_fft_tpu_torch.ops import bluestein, factor, rader, stockham
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.ops import twiddle
from regent_fft_tpu_torch.plan import Plan, PlanSpec
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

REPO = Path(__file__).resolve().parent.parent
HIGHEST = jax.lax.Precision.HIGHEST


def _crand(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _planes(x, dtype=torch.float32):
    return (torch.from_numpy(np.ascontiguousarray(x.real)).to(dtype),
            torch.from_numpy(np.ascontiguousarray(x.imag)).to(dtype))


def _ref(x, direction):
    x = np.asarray(x, np.complex128)
    if direction == Direction.FORWARD:
        return np.fft.fft(x, axis=-1)
    return np.fft.ifft(x, axis=-1, norm="forward")


def _step_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if ln.startswith("  (axis") or ln.startswith("  (real")]


@pytest.fixture
def fft_last_calls(monkeypatch):
    """Count the plain ``fft_last`` calls: on CPU planes each is what a
    launch of the kernel is on the card."""
    calls = []
    plain = sk.fft_last_plain

    def counted(xr, xi, sign, scale=1.0):
        calls.append((tuple(xr.shape), xr.dtype, sign))
        return plain(xr, xi, sign, scale)
    monkeypatch.setattr(sk, "fft_last_plain", counted)
    return calls


# --- the planner and tables ------------------------------------------------
def test_primitive_root():
    assert rader.primitive_root(2) == 1
    assert rader.primitive_root(3) == 2
    assert rader.primitive_root(7) == 3
    assert rader.primitive_root(257) == 3
    g = rader.primitive_root(509)
    seen, v = set(), 1
    for _ in range(508):
        seen.add(v)
        v = v * g % 509
    assert len(seen) == 508
    for p in (2, 3, 5, 149, 521, 1031, 2053, 4093, 12289):
        assert rader.primitive_root(p) == jrader.primitive_root(p)


def test_planner_dispatch():
    assert factor.plan_factors(509) == ("bluestein", 1024)
    assert factor.plan_factors(1009) == ("bluestein", 2048)
    assert factor.plan_factors(257) == ("rader", 256)
    assert factor.plan_factors(12289)[0] == "rader"
    assert factor.plan_factors(719)[0] == "bluestein"
    assert factor.plan_factors(127)[0] == "direct"
    assert factor.plan_factors(2 * 509)[0] == "bluestein"
    assert rader.supported(509, 128)
    assert not rader.supported(719, 128)
    assert not rader.supported(512, 128)


def test_planner_and_pads_equal_jax_over_all_lengths():
    for n in range(1, 4200):
        assert factor.plan_factors(n) == jfactor.plan_factors(n), n
        assert factor.bluestein_pad(n) == jfactor.bluestein_pad(n), n
        assert factor.prev_fast_len(n) == jfactor.prev_fast_len(n), n
        assert rader.supported(n, 128) == jrader.supported(n, 128), n
        assert (stockham.schedule_description(n)
                == jstockham.schedule_description(n)), n
    assert factor.prev_fast_len(7, 2) == jfactor.prev_fast_len(7, 2) == 4
    with pytest.raises(ValueError):
        factor.prev_fast_len(0)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_tables_bit_identical(sign, dt):
    for p in (149, 521, 2053):
        for a, b in zip(rader._rader_tables(p, sign, dt),
                        jrader._rader_tables(p, sign, dt)):
            assert np.array_equal(a, b)
    for n, m in ((59, 128), (514, 1080), (1009, 2048)):
        for a, b in zip(bluestein._bluestein_tables(n, m, sign, dt),
                        jblue._bluestein_tables(n, m, sign, dt)):
            assert a.dtype == b.dtype == dt and np.array_equal(a, b)
        for a, b in zip(twiddle.chirp(n, sign, dt),
                        jtwiddle.chirp(n, sign, dt)):
            assert np.array_equal(a, b)


def test_rader_fewer_flops_than_bluestein():
    p = 2053
    assert factor.plan_factors(p)[0] == "rader"
    L = p - 1
    m = factor.bluestein_pad(p, 128)
    rader_flops = 2 * factor.stage_flops(L, factor.factorize(L, 128)) + 6 * L
    blue_flops = (2 * factor.stage_flops(m, factor.factorize(m, 128))
                  + 18 * m)
    assert rader_flops < 0.85 * blue_flops


def test_auto_path_picks_the_jax_engine():
    assert factor.plan_factors(1009, 128) == ("bluestein", 2048)
    assert factor.plan_factors(257, 128) == ("rader", 256)
    assert factor.plan_factors(2053, 128) == ("rader", 2052)


def test_bluestein_pad_prefers_pow2_in_kernel_range():
    assert factor.bluestein_pad(1009) == 2048
    assert factor.bluestein_pad(1094) == 2187
    kind, info = factor.plan_factors(1019, 128)
    assert kind == "bluestein" and info == factor.bluestein_pad(1019)
    assert bluestein.kernel_pair(2048) is not None
    for m in (32, 1080, 4096, 2187):
        assert bluestein.kernel_pair(m) is None


def test_inner_kernel_gate_is_the_device(monkeypatch):
    """A CUDA device gives the kernel pair where fft_last takes m, and
    fetches its twiddle tables for both signs; the CPU and no device give
    the dense pipeline."""
    fetched = []
    monkeypatch.setattr(sk, "device_tables",
                        lambda n, sign, dev, stages, dtype=torch.float32:
                        fetched.append((n, sign, str(dev), stages)))
    assert bluestein._inner_kernel_pair(2048, None) is None
    assert bluestein._inner_kernel_pair(2048, "cpu") is None
    assert fetched == []
    assert bluestein._inner_kernel_pair(2048, "cuda:0") is not None
    assert fetched == [(2048, -1, "cuda:0", sk.last_stages),
                       (2048, 1, "cuda:0", sk.last_stages)]
    assert bluestein._inner_kernel_pair(1080, "cuda:0") is None
    assert bluestein._inner_kernel_pair(4096, "cuda:0") is None
    assert len(fetched) == 2


# --- the build functions against the JAX ones ------------------------------
@pytest.mark.parametrize("direction", [Direction.FORWARD, Direction.BACKWARD])
@pytest.mark.parametrize("p", [149, 521, 1031, 2053])
def test_build_rader_matches_jax(p, direction):
    x = _crand((4, p), p)
    tfn = rader.build_rader_1d(p, direction, 128, device="cpu")
    jfn = jrader.build_rader_1d(p, JDirection(int(direction)), 128, HIGHEST)
    yr, yi = tfn(*_planes(x))
    jr, ji = jfn(jnp.asarray(x.real), jnp.asarray(x.imag))
    y = torch.complex(yr, yi)
    tol = tolerance(p)
    assert y.dtype == torch.complex64 and tuple(y.shape) == (4, p)
    assert rel_l2(y, np.asarray(jr) + 1j * np.asarray(ji)) <= tol
    assert rel_l2(y, _ref(x, direction)) <= tol
    # f64 planes: float64 tables, within the complex128 bound of numpy
    x64 = _crand((4, p), p + 1, np.complex128)
    zr, zi = tfn(*_planes(x64, torch.float64))
    assert zr.dtype == torch.float64
    assert rel_l2(torch.complex(zr, zi), _ref(x64, direction)) \
        <= tolerance(p, "complex128")


@pytest.mark.parametrize("inner", ["dense", "kernel"])
@pytest.mark.parametrize("direction", [Direction.FORWARD, Direction.BACKWARD])
@pytest.mark.parametrize("n", [59, 509, 1009, 1019])
def test_build_bluestein_matches_jax(n, direction, inner, fft_last_calls):
    """Both inner paths against the JAX function (its dense inner on the
    CPU): the kernel pair runs two fft_last calls a call on f32 planes and
    none on f64 planes, which take the dense pipeline as in JAX."""
    m = factor.bluestein_pad(n)
    assert bluestein.kernel_pair(m) is not None
    pair = bluestein.kernel_pair(m) if inner == "kernel" else None
    tfn = bluestein.build_bluestein_1d(n, direction, m, 128, inner=pair,
                                       device="cpu")
    assert tfn.kernel_m == (m if pair else None)
    jfn = jblue.build_bluestein_1d(n, JDirection(int(direction)), m, 128,
                                   HIGHEST)
    x = _crand((3, n), n)
    yr, yi = tfn(*_planes(x))
    jr, ji = jfn(jnp.asarray(x.real), jnp.asarray(x.imag))
    y = torch.complex(yr, yi)
    tol = tolerance(n)
    assert rel_l2(y, np.asarray(jr) + 1j * np.asarray(ji)) <= tol
    assert rel_l2(y, _ref(x, direction)) <= tol
    want = [((3, m), torch.float32, -1), ((3, m), torch.float32, 1)]
    assert fft_last_calls == (want if pair else [])
    fft_last_calls.clear()
    x64 = _crand((3, n), n + 1, np.complex128)
    zr, zi = tfn(*_planes(x64, torch.float64))
    assert zr.dtype == torch.float64 and fft_last_calls == []
    assert rel_l2(torch.complex(zr, zi), _ref(x64, direction)) \
        <= tolerance(n, "complex128")


@pytest.mark.parametrize("p", [149, 257, 509, 1009])
def test_primes_match_numpy(p):
    x = _crand(p, p)
    got = rt.fft(x, device="cpu")
    assert rel_l2(got, np.fft.fft(x.astype(np.complex128))) < 2e-6
    fn = stockham.build_c2c_1d(p, Direction.FORWARD)
    yr, yi = fn(*_planes(x[None]))
    assert rel_l2(torch.complex(yr, yi)[0],
                  np.fft.fft(x.astype(np.complex128))) < 2e-6


@pytest.mark.parametrize("p", [509, 2053])
def test_rader_inverse_roundtrip(p):
    x = _crand(p, 1)
    y = rt.ifft(rt.fft(x, device="cpu"), device="cpu")
    assert rel_l2(y, x) < 2e-6


def test_rader_batched_2d_axis():
    """A Rader axis (521) inside a 2-D transform, with a batch."""
    x = _crand((3, 16, 521), 2)
    p = rt.make_plan(x.shape, axes=(1, 2), norm=Norm.NONE, device="cpu")
    assert "rader(521" in p.describe()
    ref = np.fft.fft2(x.astype(np.complex128), axes=(1, 2))
    assert rel_l2(p(x), ref) < 5e-6


def test_print_plan_names_rader_and_bluestein(capsys):
    rt.make_plan((2053,), norm=Norm.NONE, device="cpu").print_plan()
    assert "rader(2053" in capsys.readouterr().out
    rt.make_plan((1009,), norm=Norm.NONE, device="cpu").print_plan()
    assert "bluestein(1009" in capsys.readouterr().out


@pytest.mark.parametrize("n,radix", [(17, 16), (2053, 128), (1009, 128),
                                     (4097, 128)])
def test_flops_accounting_equals_jax(n, radix):
    p = rt.make_plan((n,), max_radix=radix, device="cpu")
    jp = R.make_plan(R.PlanSpec(shape=(n,), axes=(0,), kind=JKind.C2C,
                                direction=JDirection.FORWARD,
                                max_radix=radix))
    assert p.algorithm_flops == jp.algorithm_flops > 0
    assert p.flops == jp.flops


# --- plans at the lengths the port refused before --------------------------
C2C_LENGTHS = [514, 1009, 2053]            # Bluestein dense, kernel m; Rader
REAL_LENGTHS = [514, 1009, 2018]           # cores 257 (Rader), 1009, 1009
NORMS = list(Norm)


def _jplan(shape, axes, kind, direction, norm, dtype):
    return R.make_plan(shape, axes=axes, kind=JKind(kind.value),
                       direction=JDirection(int(direction)),
                       norm=JNorm(norm.value), dtype=dtype)


def _inputs(shape, kind, dtype, seed):
    """(port input, JAX input, float64 input) of one plan."""
    if kind == Kind.R2C:
        x = np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32)
        if dtype == "complex32":
            x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        return x, x, x.astype(np.float64)
    x = _crand(shape, seed)
    if dtype != "complex32":
        return x, x, x.astype(np.complex128)
    tr, ti = _planes(x, torch.bfloat16)
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    return (SplitComplex(tr, ti),
            JSplit(jnp.asarray(x.real, jnp.bfloat16),
                   jnp.asarray(x.imag, jnp.bfloat16)), xd)


def _np_plan_ref(xd, p):
    s = p.spec
    scale = tplan._norm_scale(s)
    if s.kind == Kind.R2C:
        return np.fft.rfft(xd, axis=-1) * scale
    if s.kind == Kind.C2R:
        return np.fft.irfft(xd, n=s.shape[-1], axis=-1) * s.logical_n * scale
    return _ref(xd, s.direction) * scale


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
@pytest.mark.parametrize("kind,n", [(Kind.C2C, n) for n in C2C_LENGTHS]
                         + [(k, n) for k in (Kind.R2C, Kind.C2R)
                            for n in REAL_LENGTHS])
def test_refused_lengths_match_jax_plan(kind, n, dtype):
    """Outputs within tolerance(n, dtype) of the JAX CPU plan and of numpy
    in float64, at all four norms (complex64 C2C in both directions), and
    the same describe() step lines."""
    directions = ([Direction.FORWARD, Direction.BACKWARD]
                  if kind == Kind.C2C and dtype == "complex64"
                  else [Direction.BACKWARD if kind == Kind.C2R
                        else Direction.FORWARD])
    tol = tolerance(n, dtype)
    for direction in directions:
        for norm in NORMS:
            shape = (3, n)
            in_shape = (3, n // 2 + 1) if kind == Kind.C2R else shape
            tx, jx, xd = _inputs(in_shape, kind, dtype, n)
            tp = rt.make_plan(shape, axes=(1,), kind=kind,
                              direction=direction, norm=norm, dtype=dtype,
                              device="cpu")
            jp = _jplan(shape, (1,), kind, direction, norm, dtype)
            assert _step_lines(tp.describe()) == _step_lines(jp.describe())
            y = tp(tx)
            yj = to_numpy_complex(jp(jx))
            if dtype == "complex32":
                assert (isinstance(y, SplitComplex) if kind != Kind.C2R
                        else y.dtype == torch.bfloat16)
            ref = _np_plan_ref(xd, tp)
            assert rel_l2(y, yj) <= tol, (direction, norm)
            assert rel_l2(y, ref) <= tol, (direction, norm)
    assert any(w in tp.describe() for w in ("conjugate-even", "rader(",
                                            "bluestein("))


@pytest.mark.parametrize("kind,n", [(Kind.C2C, 1009), (Kind.C2C, 2053),
                                    (Kind.R2C, 2018), (Kind.C2R, 1042)])
def test_refused_lengths_complex128_match_numpy(kind, n):
    direction = Direction.BACKWARD if kind == Kind.C2R else Direction.FORWARD
    for norm in NORMS:
        in_shape = (3, n // 2 + 1) if kind == Kind.C2R else (3, n)
        _, _, xd = _inputs(in_shape, kind, "complex128", n)
        p = rt.make_plan((3, n), axes=(1,), kind=kind, direction=direction,
                         norm=norm, dtype="complex128", device="cpu")
        y = p(xd)
        assert y.dtype in (torch.complex128, torch.float64)
        assert rel_l2(y, _np_plan_ref(xd, p)) <= tolerance(n, "complex128")


def test_two_general_axes_match_jax():
    """(1009, 1031), the chip run's shape: Rader on axis 1, Bluestein on
    axis 0 (a non-last axis), against the JAX plan."""
    shape = (1009, 1031)
    x = _crand(shape, 6)
    tp = rt.make_plan(shape, device="cpu")
    jp = R.make_plan(shape, kind=JKind.C2C, direction=JDirection.FORWARD)
    assert _step_lines(tp.describe()) == _step_lines(jp.describe()) == [
        "(axis 1: 1d-pipeline[rader(1031, conv=1030: mixed(1030 = 103*10): "
        "radix-103 -> radix-10)])",
        "(axis 0: 1d-pipeline[bluestein(1009, conv=2048: mixed(2048 = "
        "128*16): radix-128 -> radix-16)])"]
    y = tp(x)
    assert rel_l2(y, to_numpy_complex(jp(x))) <= tolerance(x.size)
    assert rel_l2(y, np.fft.fft2(x.astype(np.complex128))) <= tolerance(x.size)


# --- the kernel-inner route at plan level ----------------------------------
@pytest.fixture
def kernel_inner(monkeypatch):
    """Plans built here get the inner pair a CUDA plan gets."""
    monkeypatch.setattr(bluestein, "_inner_kernel_pair",
                        lambda m, device: bluestein.kernel_pair(m))


@pytest.mark.parametrize("dtype,calls", [("complex64", 2), ("complex32", 2),
                                         ("complex128", 0)])
def test_plan_bluestein_runs_fft_last_twice(dtype, calls, kernel_inner,
                                            fft_last_calls):
    """A Bluestein axis on the kernel inner: two fft_last calls a plan call
    (complex32 too: the general step runs on f32 planes), none for
    complex128; the result is the JAX plan's."""
    n, m = 1009, 2048
    tp = Plan(PlanSpec(shape=(3, n), axes=(1,), kind=Kind.C2C,
                       direction=Direction.FORWARD, dtype=dtype,
                       device="cpu"))
    (kind_, _, fn), = tp.steps
    assert kind_ == "general"
    want_m = None if dtype == "complex128" else m
    assert fn.kernel_m == want_m
    # the plan lists no table for the general step: on a card
    # build_bluestein_1d's inner pair fetches m's itself, as
    # fft_axis_stockham names them (test_inner_kernel_gate_is_the_device)
    assert tp.table_keys == []
    assert sk.axis_keys((3, m), -1, torch.float32) == [
        (m, sk.last_stages, torch.float32)]
    tx, jx, xd = _inputs((3, n), Kind.C2C, dtype, 11)
    y = tp(tx)
    assert len(fft_last_calls) == calls
    assert all(c[:2] == ((3, m), torch.float32) for c in fft_last_calls)
    ref = np.fft.fft(xd, axis=-1)
    assert rel_l2(y, ref) <= tolerance(n, dtype)
    if dtype != "complex128":
        jp = _jplan((3, n), (1,), Kind.C2C, Direction.FORWARD, Norm.BACKWARD,
                    dtype)
        assert rel_l2(y, to_numpy_complex(jp(jx))) <= tolerance(n, dtype)


def test_real_plan_half_length_bluestein_on_the_kernel(kernel_inner,
                                                       fft_last_calls):
    """R2C/C2R 2018: the half-length core is Bluestein 1009 on the kernel
    inner (two calls each); the real route lists m for the prefetch."""
    for kind, direction in ((Kind.R2C, Direction.FORWARD),
                            (Kind.C2R, Direction.BACKWARD)):
        fft_last_calls.clear()
        tp = Plan(PlanSpec(shape=(3, 2018), axes=(1,), kind=kind,
                           direction=direction, device="cpu"))
        assert tp.real.route == "einsum" and tp.real.fn.kernel_m == 2048
        assert tp.real.keys == [] and tp.table_keys == []
        in_shape = (3, 1010) if kind == Kind.C2R else (3, 2018)
        tx, _, xd = _inputs(in_shape, kind, "complex64", 3)
        y = tp(tx)
        assert len(fft_last_calls) == 2
        assert rel_l2(y, _np_plan_ref(xd, tp)) <= tolerance(2018)


def test_rader_plan_runs_no_kernel(kernel_inner, fft_last_calls):
    tp = Plan(PlanSpec(shape=(3, 2053), axes=(1,), kind=Kind.C2C,
                       direction=Direction.FORWARD, device="cpu"))
    assert getattr(tp.steps[0][2], "kernel_m", None) is None
    x = _crand((3, 2053), 4)
    assert rel_l2(tp(x), np.fft.fft(x.astype(np.complex128), axis=-1)) \
        <= tolerance(2053)
    assert fft_last_calls == []


# --- every length plans ----------------------------------------------------
# Lengths whose 1-D plan raised before (no kernel, direct or two-factor
# split): the general step's Rader or Bluestein, or the real route's core.
REFUSED_BEFORE = {Kind.C2C: 1820, Kind.R2C: 1917, Kind.C2R: 1917}


@pytest.mark.parametrize("kind", [Kind.C2C, Kind.R2C, Kind.C2R])
def test_every_length_plans(kind):
    """Plan(spec) builds for n = 1..4096 in every dtype (no cache), and the
    lengths that take Rader or Bluestein are the ones refused before."""
    direction = Direction.BACKWARD if kind == Kind.C2R else Direction.FORWARD
    for dtype in ("complex64", "complex32", "complex128"):
        refused = 0
        for n in range(1, 4097):
            p = Plan(PlanSpec(shape=(n,), axes=(0,), kind=kind,
                              direction=direction, dtype=dtype, device="cpu"))
            if kind == Kind.C2C:
                general = p.steps[0][0] == "general"
                core = n
            else:
                general = p.real.route == "einsum" and n > 1
                core = n if n % 2 else n // 2
            refused += general and factor.plan_factors(core)[0] in (
                "rader", "bluestein")
        assert refused == REFUSED_BEFORE[kind], dtype
    assert rt.cached_plans() == [] or all(
        q.spec.shape != (4096,) for q in rt.cached_plans())


# --- gradients -------------------------------------------------------------
@pytest.mark.parametrize("n", [521, 1009])
def test_grad_through_build_c2c_1d(n):
    """torch.autograd through the Rader (521) and Bluestein (1009) pipelines:
    by Parseval d/dx sum |X|^2 = 2 n x (tests/test_autodiff.py:13), here
    within tolerance(n) in rel_l2."""
    fn = stockham.build_c2c_1d(n, Direction.FORWARD)
    rng = np.random.default_rng(0)
    xr = torch.tensor(rng.standard_normal((2, n)), dtype=torch.float32,
                      requires_grad=True)
    xi = torch.tensor(rng.standard_normal((2, n)), dtype=torch.float32,
                      requires_grad=True)
    yr, yi = fn(xr, xi)
    (yr ** 2 + yi ** 2).sum().backward()
    tol = tolerance(n)
    assert rel_l2(xr.grad, 2 * n * xr.detach()) <= tol
    assert rel_l2(xi.grad, 2 * n * xi.detach()) <= tol


# --- complex128 against the JAX package with x64 ---------------------------
_SCRIPT = r"""
import os, json
os.environ["JAX_ENABLE_X64"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
import regent_fft_tpu as R
from regent_fft_tpu.ops import bluestein as jb, rader as jr
import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.ops import bluestein as tb, rader as tr
from regent_fft_tpu_torch.utils.verify import rel_l2

def lines(p):
    return [l.strip() for l in p.describe().splitlines()
            if l.startswith("  (axis") or l.startswith("  (real")]

rng = np.random.default_rng(0)
out = {}
x = rng.standard_normal((3, 1009)) + 1j * rng.standard_normal((3, 1009))
for d in (-1,):
    t = tb.build_bluestein_1d(1009, rt.Direction(d), 2048, 128,
                              inner=tb.kernel_pair(2048))
    j = jb.build_bluestein_1d(1009, R.Direction(d), 2048, 128,
                              jax.lax.Precision.HIGHEST)
    y = torch.complex(*t(torch.from_numpy(x.real.copy()),
                         torch.from_numpy(x.imag.copy())))
    jy = j(jnp.asarray(x.real), jnp.asarray(x.imag))
    out[f"bluestein{d}"] = [rel_l2(y, np.asarray(jy[0]) + 1j * np.asarray(jy[1])), True]
    x2 = rng.standard_normal((3, 2053)) + 1j * rng.standard_normal((3, 2053))
    t = tr.build_rader_1d(2053, rt.Direction(d), 128)
    j = jr.build_rader_1d(2053, R.Direction(d), 128, jax.lax.Precision.HIGHEST)
    y = torch.complex(*t(torch.from_numpy(x2.real.copy()),
                         torch.from_numpy(x2.imag.copy())))
    jy = j(jnp.asarray(x2.real), jnp.asarray(x2.imag))
    out[f"rader{d}"] = [rel_l2(y, np.asarray(jy[0]) + 1j * np.asarray(jy[1])), True]
for kind, n in (("c2c", 1009), ("c2c", 2053), ("r2c", 2018), ("c2r", 1042)):
    d = 1 if kind == "c2r" else -1
    shape = (3, n)
    if kind == "r2c":
        xin = rng.standard_normal(shape)
    elif kind == "c2r":
        xin = np.fft.rfft(rng.standard_normal(shape), axis=1)
    else:
        xin = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    jp = R.make_plan(shape, axes=(1,), kind=R.Kind(kind), direction=R.Direction(d),
                     dtype="complex128")
    tp = rt.make_plan(shape, axes=(1,), kind=rt.Kind(kind),
                      direction=rt.Direction(d), dtype="complex128", device="cpu")
    out[f"{kind}{n}"] = [rel_l2(tp(xin), np.asarray(jp(xin))), lines(tp) == lines(jp)]
print(json.dumps(out))
"""


def test_complex128_matches_jax_x64():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(res) == 6
    for key, (err, same_lines) in res.items():
        assert err <= tolerance(2053, "complex128"), (key, err)
        assert same_lines, key
