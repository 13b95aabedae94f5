"""The matmul-form kernels (``backend="pallas"``) in the port against the
JAX package on the CPU: the schedules, the plain versions against the JAX
runners in interpret mode, ``build_c2c_1d_pallas``, the plans in every
dtype and kind, and a numpy emulation of the CUDA kernels' index scheme.

Tolerance: ``tolerance(n, dtype)`` = 8 * eps * sqrt(log2 n) (eps 2^-23 for
f32 planes, 2^-8 for bf16, 2^-52 for f64).  The plain versions and the JAX
runners compute the same products at full f32 from bit-identical tables,
so they differ by summation order only.
"""
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
from regent_fft_tpu.ops import factor as jfactor
from regent_fft_tpu.ops import pallas_fft as jpf
from regent_fft_tpu.ops import twiddle as jtw
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm, SplitComplex
from regent_fft_tpu_torch.ops import factor as tfactor
from regent_fft_tpu_torch.ops import pallas_fft as tpf
from regent_fft_tpu_torch.ops import stockham_kernels as tsk
from regent_fft_tpu_torch.ops import twiddle as ttw
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _step_lines(text):
    return [ln.strip() for ln in text.splitlines() if ln.startswith("  (")]


def _ref(x, axes, direction, scale=1.0):
    x = x.astype(np.complex128)
    if direction == Direction.FORWARD:
        return np.fft.fftn(x, axes=axes) * scale
    return np.fft.ifftn(x, axes=axes, norm="forward") * scale


# --- schedules and tables ------------------------------------------------------
def test_schedules_equal_jax_over_all_lengths():
    assert tfactor.MIN_PALLAS_RADIX == jfactor.MIN_PALLAS_RADIX
    for n in range(2, 20001):
        assert tfactor.pallas_schedule(n) == jfactor.pallas_schedule(n), n
        assert tpf.two_stage_split(n) == jpf.two_stage_split(n), n
        assert tpf._plan_kind(n) == jpf._plan_kind(n), n


def test_plan_kind_examples():
    assert tpf._plan_kind(640) == ("two", (32, 20))
    assert tpf._plan_kind(128) == ("direct",)
    for n in (2053, 1009, 130, 1):
        assert tpf._plan_kind(n) is None
        assert tpf.build_c2c_1d_pallas(n, Direction.FORWARD) is None
    # _plan_kind ignores max_radix, as in the JAX package: a plan with
    # max_radix 16 still takes fft_mm1 at n = 100
    p = rt.make_plan((3, 100), axes=(1,), backend="pallas", max_radix=16,
                     device="cpu")
    assert p.steps[0][2].__qualname__.startswith("build_c2c_1d_pallas")


@pytest.mark.parametrize("sign", [-1, 1])
def test_tables_bit_identical(sign):
    """dft_matrix and twiddle_outer equal the JAX copies bit for bit at
    every n1, n2 in 16..128 (uncached calls, so the caches stay small)."""
    for n1 in range(16, 129):
        a, b = ttw.dft_matrix(n1, sign), jtw.dft_matrix(n1, sign)
        assert all(np.array_equal(p, q) for p, q in zip(a, b)), n1
        for n2 in range(16, 129):
            a = ttw.twiddle_outer.__wrapped__(n1, n2, n1 * n2, sign)
            b = jtw.twiddle_outer.__wrapped__(n1, n2, n1 * n2, sign)
            assert all(np.array_equal(p, q) for p, q in zip(a, b)), (n1, n2)
    for n1, n2 in [(16, 16), (32, 20), (80, 50), (128, 128), (127, 113)]:
        a = ttw.twiddle_outer(n1, n2, n1 * n2, sign)
        # the kernels' root tables hold the same values bit for bit
        roots = tpf._device_roots((n1, n2, n1 * n2), sign,
                                  torch.device("cpu")).numpy()
        w1, w2, wn = roots[:n1], roots[n1:n1 + n2], roots[n1 + n2:]
        d1 = np.stack(ttw.dft_matrix(n1, sign), -1)
        k = np.arange(n1)
        assert np.array_equal(d1, w1[np.outer(k, k) % n1])
        d2 = np.stack(ttw.dft_matrix(n2, sign), -1)
        k = np.arange(n2)
        assert np.array_equal(d2, w2[np.outer(k, k) % n2])
        tw = np.stack(a, -1)
        assert np.array_equal(
            tw, wn[np.outer(np.arange(n1), np.arange(n2))])


# --- plain versions against the JAX runners (interpret mode) ------------------
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [2, 16, 64, 100, 128])
def test_mm1_plain_matches_jax_runner(n, sign):
    x = _crand((9, n), n)
    run = jpf._runner_1stage(n, sign, 1, "HIGHEST", interpret=True)
    jr, ji = run(jnp.asarray(x.real), jnp.asarray(x.imag))
    yr, yi = tpf.fft_mm1_plain(_t(x.real), _t(x.imag), n, sign)
    assert yr.dtype == torch.float32 and yr.shape == (9, n)
    tol = tolerance(n)
    assert rel_l2(torch.complex(yr, yi),
                  np.asarray(jr) + 1j * np.asarray(ji)) <= tol
    ref = _ref(x, (1,), Direction(sign))
    assert rel_l2(torch.complex(yr, yi), ref) <= tol


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n1,n2", [(16, 16), (24, 16), (32, 20), (32, 32),
                                   (64, 64)])
def test_mm2_plain_matches_jax_runner(n1, n2, sign):
    n = n1 * n2
    x = _crand((4, n), n)
    run = jpf._runner_2stage(n1, n2, sign, 4, "HIGHEST", interpret=True)
    jr, ji = run(jnp.asarray(x.real.reshape(4, n1, n2)),
                 jnp.asarray(x.imag.reshape(4, n1, n2)))
    jy = (np.asarray(jr) + 1j * np.asarray(ji)).reshape(4, n)
    yr, yi = tpf.fft_mm2_plain(_t(x.real), _t(x.imag), n1, n2, sign)
    assert yr.shape == (4, n) and yr.is_contiguous()
    tol = tolerance(n)
    assert rel_l2(torch.complex(yr, yi), jy) <= tol
    assert rel_l2(torch.complex(yr, yi), _ref(x, (1,), Direction(sign))) \
        <= tol


@pytest.mark.parametrize("batch", [6, 37])
@pytest.mark.parametrize("n", [64, 128, 256, 1024, 4096])
def test_build_c2c_1d_pallas_matches_jax(n, batch):
    x = _crand((batch, n), batch)
    jfn = jpf.build_c2c_1d_pallas(n, JDirection.FORWARD, 128,
                                  jax.lax.Precision.HIGHEST, interpret=True)
    tfn = tpf.build_c2c_1d_pallas(n, Direction.FORWARD)
    jr, ji = jfn(jnp.asarray(x.real), jnp.asarray(x.imag))
    yr, yi = tfn(_t(x.real), _t(x.imag))
    tol = tolerance(n)
    y = torch.complex(yr, yi)
    assert rel_l2(y, np.asarray(jr) + 1j * np.asarray(ji)) <= tol
    assert rel_l2(y, np.fft.fft(x.astype(np.complex128))) <= tol


def test_wrappers_take_f32_planes_and_launch_nothing_on_cpu():
    x = torch.zeros(3, 64)
    before = dict(tsk.LAUNCHES)
    tpf.fft_mm1(x, x, 64, -1)
    tpf.fft_mm2(torch.zeros(3, 256), torch.zeros(3, 256), 16, 16, 1)
    assert tsk.LAUNCHES == before           # CPU planes launch nothing
    for dt in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="fft_mm1"):
            tpf.fft_mm1(x.to(dt), x.to(dt), 64, -1)
        with pytest.raises(ValueError, match="fft_mm2"):
            tpf.fft_mm2(x.to(dt), x.to(dt), 8, 8, -1)


# --- the CUDA kernels' index scheme, emulated in numpy -------------------------
# csrc/matmul.cu: 512 threads; thread t of a contraction over `ncols`
# columns takes column t % ncols and outputs k = t // ncols + G * i
# (G = 512 // ncols, i < ot), carrying the root exponents mod L by
# additions; rows per block R as the C entries choose them.
THREADS = 512


def _opt(ncols, length):
    g = THREADS // ncols
    return -(-length // g)


def _mm1_rows(n):
    r = min(THREADS, 4096 // n)
    while r > 1 and _opt(r, n) > 8:
        r -= 1
    return r


def _mm2_rows(n1, n2):
    n = n1 * n2
    r = 4096 // n if n < 4096 else 1

    def most(r):
        return max(_opt(r * n2, n1), _opt(r * n1, n2))
    while r > 1 and (r * n1 > THREADS or r * n2 > THREADS or most(r) > 8):
        r -= 1
    return r, most(r)


def _dft_column(s, ncols, length, w, base, js, ok):
    """All threads' dft_column: (column, k, value) of every output of the
    threads whose column is `ok`."""
    t = np.arange(THREADS)
    g = THREADS // ncols
    c, k0 = t % ncols, t // ncols
    ot = np.where((k0 < g) & (k0 < length), (length - 1 - k0) // g + 1, 0)
    k0 = np.where(ot > 0, k0, 0)
    maxo = int(ot.max())
    acc = np.zeros((THREADS, maxo), np.complex128)
    e0 = np.zeros(THREADS, np.int64)
    d = 0
    for j in range(length):
        x = s[base[c] + j * js]
        e = e0.copy()
        for i in range(maxo):
            acc[:, i] += x * w[e]
            e = e + d
            e = np.where(e >= length, e - length, e)
        e0 = e0 + k0
        e0 = np.where(e0 >= length, e0 - length, e0)
        d += g % length
        d = d - length if d >= length else d
    outs = []
    for th in np.nonzero((ot > 0) & ok[c])[0]:
        for i in range(ot[th]):
            outs.append((c[th], k0[th] + g * i, acc[th, i]))
    return outs


def _roots(m, sign):
    return np.exp(2j * np.pi * sign * np.arange(m) / m)


def _emulate_mm1(x, n, sign):
    b = x.shape[0]
    r_blk = _mm1_rows(n)
    pitch = n | 1
    y = np.zeros_like(x, np.complex128)
    for row0 in range(0, b, r_blk):
        rows = min(r_blk, b - row0)
        s = np.zeros(r_blk * pitch, np.complex128)
        for r in range(rows):
            s[r * pitch:r * pitch + n] = x[row0 + r]
        outs = _dft_column(s, r_blk, n, _roots(n, sign),
                           np.arange(r_blk) * pitch, 1,
                           np.arange(r_blk) < rows)
        seen = set()
        for c, k, v in outs:
            assert (c, k) not in seen
            seen.add((c, k))
            s[c * pitch + k] = v
        assert len(seen) == rows * n          # every output exactly once
        for r in range(rows):
            y[row0 + r] = s[r * pitch:r * pitch + n]
    return y


def _emulate_mm2(x, n1, n2, sign):
    b, n = x.shape
    r_blk, ot = _mm2_rows(n1, n2)
    assert ot <= 32
    p2 = n2 | 1
    rs = n1 * p2
    tw = _roots(n, sign)
    y = np.zeros_like(x, np.complex128)
    for row0 in range(0, b, r_blk):
        rows = min(r_blk, b - row0)
        s = np.zeros(r_blk * rs, np.complex128)
        for r in range(rows):
            s[r * rs:(r + 1) * rs].reshape(n1, p2)[:, :n2] = \
                x[row0 + r].reshape(n1, n2)
        cols = np.arange(r_blk * n2)
        base1 = (cols // n2) * rs + cols % n2
        outs = _dft_column(s, r_blk * n2, n1, _roots(n1, sign), base1, p2,
                           cols // n2 < rows)
        assert len(outs) == rows * n
        for c, k1, v in outs:
            s[base1[c] + k1 * p2] = v * tw[(c % n2) * k1]
        cols = np.arange(r_blk * n1)
        base2 = (cols // n1) * rs + (cols % n1) * p2
        outs = _dft_column(s, r_blk * n1, n2, _roots(n2, sign), base2, 1,
                           cols // n1 < rows)
        assert len(outs) == rows * n
        for c, k2, v in outs:
            s[(c // n1) * rs + c % n1 + n1 * k2] = v
        for r in range(rows):
            y[row0 + r] = s[r * rs:r * rs + n]
    return y


@pytest.mark.parametrize("n,b", [(1, 3), (3, 5), (100, 41), (128, 37)])
def test_mm1_kernel_scheme_emulation(n, b):
    x = _crand((b, n), n)
    for sign in (-1, 1):
        y = _emulate_mm1(x.astype(np.complex128), n, sign)
        assert rel_l2(y, _ref(x, (1,), Direction(sign))) <= 1e-12


@pytest.mark.parametrize("n1,n2,b", [(16, 16, 17), (32, 20, 7), (32, 32, 5),
                                     (80, 50, 2), (128, 2, 3), (128, 128, 1)])
def test_mm2_kernel_scheme_emulation(n1, n2, b):
    x = _crand((b, n1 * n2), n1)
    for sign in (-1, 1):
        y = _emulate_mm2(x.astype(np.complex128), n1, n2, sign)
        assert rel_l2(y, _ref(x, (1,), Direction(sign))) <= 1e-12


def test_kernel_rows_per_block():
    """Rows per block and outputs per thread at the main path's lengths."""
    assert _mm1_rows(128) == 32 and _opt(32, 128) == 8
    assert _mm2_rows(32, 32) == (4, 8)          # n = 1024: 4 rows a block
    assert _mm2_rows(128, 128) == (1, 32)       # n = 16384: one row
    assert _mm2_rows(32, 16)[0] == 8 and _mm2_rows(16, 16)[0] == 16
    worst = max(_mm2_rows(*tpf.two_stage_split(n))[1]
                for n in range(256, 16385) if tpf.two_stage_split(n))
    assert worst == 32


# --- backend="pallas" plans against the JAX package's --------------------------
PLAN_CASES = [((6, 1024), (1,)), ((4, 640), (1,)), ((2, 32, 48, 16), (1, 2, 3)),
              ((3, 130), (1,))]


def _plans(shape, axes, direction, norm, dtype="complex64"):
    jp = R.make_plan(shape, axes=axes, kind=JKind.C2C,
                     direction=JDirection(int(direction)),
                     norm=JNorm(norm.value), backend="pallas", dtype=dtype)
    tp = rt.make_plan(shape, axes=axes, kind=Kind.C2C, direction=direction,
                      norm=norm, backend="pallas", dtype=dtype, device="cpu")
    return jp, tp


@pytest.mark.parametrize("norm", list(Norm))
@pytest.mark.parametrize("shape,axes", PLAN_CASES)
def test_pallas_plan_matches_jax(shape, axes, norm):
    x = _crand(shape, 11)
    for direction in (Direction.FORWARD, Direction.BACKWARD):
        jp, tp = _plans(shape, axes, direction, norm)
        assert _step_lines(tp.describe()) == _step_lines(jp.describe())
        assert all(k == "general" for k, _, _ in tp.steps)
        y = tp(x)
        assert y.dtype == torch.complex64 and tuple(y.shape) == shape
        tol = tolerance(tp.spec.logical_n)
        assert rel_l2(y, to_numpy_complex(jp(x))) <= tol
        assert rel_l2(y, _ref(x, axes, direction,
                              rt.plan._norm_scale(tp.spec))) <= tol
        assert rel_l2(tp.inverse()(y), x) <= tol


def test_pallas_plan_steps_pick_the_kernels():
    """Which kernel each general step takes: mm1 up to 128, mm2 for a
    two-factor split, the dense pipeline otherwise (130 has none)."""
    def fns(shape, axes, dtype="complex64"):
        p = rt.make_plan(shape, axes=axes, backend="pallas", dtype=dtype,
                         device="cpu")
        return [arg.__qualname__.split(".")[0] for _, _, arg in p.steps]
    assert fns((6, 1024), (1,)) == ["build_c2c_1d_pallas"]
    assert fns((3, 130), (1,)) == ["build_c2c_1d"]
    assert fns((6, 1024), (1,), "complex128") == ["build_c2c_1d"]
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        rt.make_plan((2053,), backend="pallas", device="cpu")


@pytest.mark.parametrize("shape,axes", PLAN_CASES[:3])
def test_pallas_plan_complex32_matches_jax(shape, axes):
    x = _crand(shape, 13)
    tr = _t(x.real).to(torch.bfloat16)
    ti = _t(x.imag).to(torch.bfloat16)
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    jx = JSplit(jnp.asarray(x.real, jnp.bfloat16),
                jnp.asarray(x.imag, jnp.bfloat16))
    jp, tp = _plans(shape, axes, Direction.FORWARD, Norm.BACKWARD,
                    "complex32")
    assert tp.cdtype == torch.bfloat16
    assert _step_lines(tp.describe()) == _step_lines(jp.describe())
    y = tp(SplitComplex(tr, ti))
    assert isinstance(y, SplitComplex) and y.re.dtype == torch.bfloat16
    tol = tolerance(tp.spec.logical_n, "complex32")
    assert rel_l2(y, to_numpy_complex(jp(jx))) <= tol
    assert rel_l2(y, np.fft.fftn(xd, axes=axes)) <= tol
    back = tp.inverse()(y)
    assert isinstance(back, SplitComplex)
    assert rel_l2(back, xd) <= 2 * tol


@pytest.mark.parametrize("shape,axes", PLAN_CASES)
def test_pallas_plan_complex128_matches_numpy(shape, axes):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    p = rt.make_plan(shape, axes=axes, backend="pallas", dtype="complex128",
                     device="cpu")
    assert p.cdtype == torch.float64
    y = p(x)
    tol = tolerance(p.spec.logical_n, "complex128")
    assert y.dtype == torch.complex128
    assert rel_l2(y, np.fft.fftn(x, axes=axes)) <= tol
    assert rel_l2(p.inverse()(y), x) <= tol


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_pallas_real_plans_match_jax(kind):
    """Real plans under "pallas": the other axes on the matmul kernels, the
    real axis on the dense conjugate-even reduction (plan.py:640-665)."""
    shape, axes = (4, 64, 64, 64), (1, 2, 3)
    rng = np.random.default_rng(17)
    xr = rng.standard_normal(shape).astype(np.float32)
    if kind == "r2c":
        jp = R.make_plan(shape, axes=axes, kind=JKind.R2C,
                         direction=JDirection.FORWARD, backend="pallas")
        tp = rt.make_plan(shape, axes=axes, kind=Kind.R2C,
                          direction=Direction.FORWARD, backend="pallas",
                          device="cpu")
        x, ref = xr, np.fft.rfftn(xr.astype(np.float64), axes=axes)
    else:
        x = np.fft.rfftn(xr.astype(np.float64), axes=axes).astype(np.complex64)
        jp = R.make_plan(shape, axes=axes, kind=JKind.C2R,
                         direction=JDirection.BACKWARD, backend="pallas")
        tp = rt.make_plan(shape, axes=axes, kind=Kind.C2R,
                          direction=Direction.BACKWARD, backend="pallas",
                          device="cpu")
        ref = xr.astype(np.float64)
    assert tp.real.route == "einsum"
    assert [k for k, _, _ in tp.steps] == ["general", "general"]
    assert _step_lines(tp.describe()) == _step_lines(jp.describe())
    y = tp(x)
    tol = tolerance(tp.spec.logical_n)
    assert rel_l2(y, to_numpy_complex(jp(x))) <= tol
    assert rel_l2(y, ref) <= tol
    assert rel_l2(tp.inverse()(y), x) <= tol
