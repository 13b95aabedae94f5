"""The matmul-form kernels (``backend="pallas"``) in the port against the
JAX package on the CPU: the schedules, the plain versions against the JAX
runners in interpret mode, ``build_c2c_1d_pallas``, the plans in every
dtype and kind, and a numpy emulation of the CUDA kernel's 3xTF32 scheme
(held against numpy float64 within ``tolerance(n, "complex64")``).

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


# --- the CUDA kernel's 3xTF32 scheme, emulated in numpy -----------------------
# csrc/matmul.cu (fft_mm_kernel): tiles of R rows as mm_geometry picks them;
# each stage the L-point DFT of every column, after one radix-2 step where
# mm_halves(L); D = W_L^{(k*j) mod L} from the f32 root table, K padded to
# 8 with zeros; every f32 operand split into tf32 hi and lo
# (cvt.rna.tf32.f32), each real product lo*hi' + hi*lo' + hi*hi'; the
# products of one K step (8 deep, both real products of a complex part)
# summed into a zeroed fragment, rounded to f32 and added to the f32
# accumulator; the twiddle by fmaf as the kernel writes it.
def tf32_rna(a):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits; the low 13 bits cleared."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    sign = u & np.uint32(0x80000000)
    mag = (u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)
    return ((mag & np.uint32(0x7FFFE000)) | sign).view(np.float32)


def _split(a):
    hi = tf32_rna(a)
    return hi, tf32_rna((a - hi).astype(np.float32))


def _prod3(a, b):
    """(cols, K) data by (K, M) matrix as the split's three terms, each
    product exact in float64."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    f = np.float64
    return (al.astype(f) @ bh.astype(f) + ah.astype(f) @ bl.astype(f)
            + ah.astype(f) @ bh.astype(f))


def _emulate_stage(xr, xi, length, w):
    """The kernel's contraction of (cols, L) f32 planes with the L roots
    `w` (complex64): (cols, L) f32 planes, output k at column k."""
    f32 = np.float32
    if tpf.mm_halves(length):
        h = length // 2
        parts = [((xr[:, :h] + xr[:, h:]).astype(f32),
                  (xi[:, :h] + xi[:, h:]).astype(f32), 0),
                 ((xr[:, :h] - xr[:, h:]).astype(f32),
                  (xi[:, :h] - xi[:, h:]).astype(f32), 1)]
        step = 2
    else:
        h, parts, step = length, [(xr, xi, 0)], 1
    yr = np.zeros(xr.shape, f32)
    yi = np.zeros(xi.shape, f32)
    kp = -(-h // 8) * 8
    for ur, ui, par in parts:
        k = step * np.arange(h) + par
        d = np.zeros((kp, h), np.complex64)            # K padded with zeros
        d[:h] = w[np.outer(np.arange(h), k) % length]
        dr, di = d.real.astype(f32), d.imag.astype(f32)
        pad = ((0, 0), (0, kp - h))
        ur, ui = np.pad(ur, pad), np.pad(ui, pad)
        ar = np.zeros((xr.shape[0], h), f32)
        ai = np.zeros((xr.shape[0], h), f32)
        for j in range(0, kp, 8):
            s = slice(j, j + 8)
            pr = (_prod3(ur[:, s], dr[s]) + _prod3(-ui[:, s], di[s])
                  ).astype(f32)
            pi = (_prod3(ui[:, s], dr[s]) + _prod3(ur[:, s], di[s])
                  ).astype(f32)
            ar = (ar + pr).astype(f32)
            ai = (ai + pi).astype(f32)
        yr[:, k], yi[:, k] = ar, ai
    return yr, yi


def _emulate_mm(x, n1, n2, sign):
    """fft_mm1 (n1 = 1) or fft_mm2 on (b, n1*n2) complex64 rows, tile by
    tile as mm_geometry cuts the batch."""
    b, n = x.shape
    geo = tpf.mm_geometry(n1, n2, b)
    f32 = np.float32
    if n1 > 1:
        tab = tpf._device_roots((n1, n2, n), sign, torch.device("cpu")).numpy()
        w1 = tab[:n1, 0] + 1j * tab[:n1, 1]
        w2 = tab[n1:n1 + n2, 0] + 1j * tab[n1:n1 + n2, 1]
        twr, twi = tab[n1 + n2:, 0], tab[n1 + n2:, 1]
    else:
        tab = tpf._device_roots((n,), sign, torch.device("cpu")).numpy()
        w2 = tab[:, 0] + 1j * tab[:, 1]
    y = np.zeros((b, n), np.complex128)
    for row0 in range(0, b, geo.rows):
        t = x[row0:row0 + geo.rows]
        r = t.shape[0]
        xr = t.real.astype(f32).reshape(r, n1, n2)
        xi = t.imag.astype(f32).reshape(r, n1, n2)
        if n1 > 1:    # columns (r, nu2) over nu1, then the twiddle
            cr = xr.transpose(0, 2, 1).reshape(r * n2, n1)
            ci = xi.transpose(0, 2, 1).reshape(r * n2, n1)
            ar, ai = _emulate_stage(cr, ci, n1, w1)       # (r*n2, k1)
            e = np.outer(np.arange(n2), np.arange(n1))    # nu2 * k1
            tr = np.tile(twr[e], (r, 1)).astype(np.float64)
            ti = np.tile(twi[e], (r, 1)).astype(np.float64)
            vr = (ar * tr + (-(ai * ti).astype(f32))).astype(f32)
            vi = (ar * ti + (ai * tr).astype(f32)).astype(f32)
            xr = vr.reshape(r, n2, n1).transpose(0, 2, 1)   # A[k1][nu2]
            xi = vi.reshape(r, n2, n1).transpose(0, 2, 1)
        cr, ci = _emulate_stage(xr.reshape(r * n1, n2),
                                xi.reshape(r * n1, n2), n2, w2)  # (r*n1, k2)
        out = (cr + 1j * ci.astype(np.float64)).reshape(r, n1, n2)
        y[row0:row0 + r] = out.transpose(0, 2, 1).reshape(r, n)  # k1 + n1 k2
    return y


def test_tf32_rounding_bit_patterns():
    f = np.float32
    bits = np.array([0x3F801000,    # 1 + 2^-11: a tie, away from zero
                     0xBF801000,    # its negative
                     0x3F800FFF,    # just below the tie: down
                     0x3FFFF000,    # a tie that carries into the exponent
                     0x3F801001,    # just above the tie: up
                     0x00000000], np.uint32).view(f)
    want = np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x40000000,
                     0x3F802000, 0x00000000], np.uint32)
    assert np.array_equal(tf32_rna(bits).view(np.uint32), want)
    hi, lo = _split(np.array([1 / 3], f))
    assert hi.view(np.uint32)[0] & 0x1FFF == 0
    assert lo.view(np.uint32)[0] & 0x1FFF == 0
    assert abs(float(hi[0]) + float(lo[0]) - float(f(1 / 3))) <= 2.0 ** -23


def _hold_emulation(n1, n2, b, seed):
    n = n1 * n2
    x = _crand((b, n), seed)
    for sign in (-1, 1):
        y = _emulate_mm(x, n1, n2, sign)
        assert rel_l2(y, _ref(x, (1,), Direction(sign))) <= \
            tolerance(max(n, 2)), (n1, n2, sign)


@pytest.mark.parametrize("n,b", [(1, 3), (3, 5), (100, 41), (128, 37)])
def test_mm1_kernel_emulation(n, b):
    _hold_emulation(1, n, b, n)


@pytest.mark.parametrize("n1,n2,b", [(16, 16, 17), (32, 20, 7), (32, 32, 5),
                                     (80, 50, 2), (128, 2, 3), (128, 128, 1)])
def test_mm2_kernel_emulation(n1, n2, b):
    _hold_emulation(n1, n2, b, n1)


@pytest.mark.parametrize("n", range(1, 129))
def test_mm1_kernel_emulation_sweep(n):
    _hold_emulation(1, n, 3, 1000 + n)


def test_kernel_geometry_fits_every_length():
    """Every length the kernels take gets a tile within the 232,448 bytes a
    block may use, at least one row, and two buffers at the main path's
    shapes; the last stage stores from registers only where its units
    outnumber the warps, and a column group never does."""
    for n1, n2 in ([(1, n) for n in range(1, 129)]
                   + [tpf.two_stage_split(n) for n in range(2, 16385)
                      if tpf.two_stage_split(n)]):
        for batch in (1, 262144):
            g = tpf.mm_geometry(n1, n2, batch)
            assert 1 <= g.rows and g.buffers in (1, 2), (n1, n2)
            assert g.smem == tpf.mm_smem(n1, n2, g.rows, g.buffers)
            assert g.smem <= tpf.SMEM_PER_CTA == 232448, (n1, n2)
            assert 1 <= g.ctas <= 132
            assert g.ctas <= -(-batch // g.rows)
            assert g.direct == (tpf.mm_units(n2, g.rows * n1) > tpf.MM_WARPS)
            assert max(tpf.mm_group(n1), tpf.mm_group(n2)) <= tpf.MM_WARPS
    for n1, n2 in [(1, 128), (32, 32), (32, 20), (16, 16), (32, 16)]:
        g = tpf.mm_geometry(n1, n2, 262144)
        assert g.buffers == 2 and not g.direct, (n1, n2, g)


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
    two-factor split, the dense pipeline otherwise (130 has none; the
    prime 2053 takes its Rader branch)."""
    def fns(shape, axes, dtype="complex64"):
        p = rt.make_plan(shape, axes=axes, backend="pallas", dtype=dtype,
                         device="cpu")
        return [arg.__qualname__.split(".")[0] for _, _, arg in p.steps]
    assert fns((6, 1024), (1,)) == ["build_c2c_1d_pallas"]
    assert fns((3, 130), (1,)) == ["build_c2c_1d"]
    assert fns((6, 1024), (1,), "complex128") == ["build_c2c_1d"]
    # no schedule for the matmul kernels: the dense pipeline's Rader branch
    assert fns((2053,), (0,)) == ["build_rader_1d"]


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
