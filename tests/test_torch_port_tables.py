"""The PyTorch port's numpy tables and schedule gates are exact copies of
the JAX package's: compared with np.array_equal / ==, tolerance 0."""
import numpy as np
import pytest

from regent_fft_tpu.ops import factor as jfactor
from regent_fft_tpu.ops import pallas_stockham as jps
from regent_fft_tpu.ops import stockham as jstockham
from regent_fft_tpu.ops import twiddle as jtwiddle
from regent_fft_tpu.utils import verify as jverify

from regent_fft_tpu_torch.ops import factor as tfactor
from regent_fft_tpu_torch.ops import stockham as tstockham
from regent_fft_tpu_torch.ops import stockham_kernels as tsk
from regent_fft_tpu_torch.ops import twiddle as ttwiddle
from regent_fft_tpu_torch.utils import verify as tverify

LENGTHS = [2 ** k for k in range(1, 12)] + [24, 96, 160, 384, 640, 768, 1536]


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_dft_matrix_and_packed_tables_equal(n, sign):
    for a, b in zip(ttwiddle.dft_matrix(n, sign), jtwiddle.dft_matrix(n, sign)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    twr, twi, toffs = tsk._packed_tables(n, sign)
    jwr, jwi, joffs = jps._packed_tables(n, sign)
    assert np.array_equal(twr, jwr) and np.array_equal(twi, jwi)
    assert twr.dtype == jwr.dtype == np.float32
    assert toffs == joffs


@pytest.mark.parametrize("n", LENGTHS)
def test_schedule_helpers_equal(n):
    assert tsk._plan_stages(n) == jps._plan_stages(n)
    assert tsk._tail_mt(n) == jps._tail_mt(n)
    assert tsk._stage_radices(n) == tuple(jps._stage_radices(n))
    for last in (False, True):
        assert tsk.kernel_len_ok(n, last) == jps.kernel_len_ok(n, last)
    assert tsk.four_step_supported(n) == jps.four_step_supported(n)
    assert tverify.tolerance(n) == jverify.tolerance(n)


def test_kernel_gates_equal_over_all_lengths():
    for n in range(1, 2 * tsk.MAX_LAST_N + 2):
        for last in (False, True):
            assert tsk.kernel_len_ok(n, last) == jps.kernel_len_ok(n, last), n
    assert tsk.TAIL_MT == jps.TAIL_MT
    assert (tsk.MAX_LAST_N, tsk.MAX_STOCKHAM_N, tsk.MAX_FUSED2_ELEMS) == (
        jps.MAX_LAST_N, jps.MAX_STOCKHAM_N, jps.MAX_FUSED2_ELEMS)


@pytest.mark.parametrize("n1", LENGTHS + [8, 12, 4096])
def test_fused2_supported_equal(n1):
    for n2 in LENGTHS + [4096]:
        assert tsk.fused2_supported(n1, n2) == jps.fused2_supported(n1, n2)


def test_factorizers_equal():
    for n in range(1, 3000):
        assert tfactor.factorize(n) == jfactor.factorize(n), n
        assert tfactor.next_fast_len(n) == jfactor.next_fast_len(n), n
        assert tstockham.best_two_factor(n) == jstockham.best_two_factor(n), n
        assert tfactor.plan_factors(n) == jfactor.plan_factors(n), n
        assert (tfactor.fft_flops_convention(n)
                == jfactor.fft_flops_convention(n)), n
    for mr in (2, 3, 5, 16):
        for n in (7, 100, 1001, 4097):
            assert tfactor.factorize(n, mr) == jfactor.factorize(n, mr)
            assert tfactor.next_fast_len(n, mr) == jfactor.next_fast_len(n, mr)
    assert tfactor.DEFAULT_MAX_RADIX == jfactor.DEFAULT_MAX_RADIX


@pytest.mark.parametrize("n", [2, 5, 7, 48, 1000, 2 ** 20, 3 ** 12])
def test_tolerance_and_twiddle_outer_equal(n):
    for dtype in ("complex32", "complex64", "complex128"):
        assert tverify.tolerance(n, dtype) == jverify.tolerance(n, dtype)
    if n <= 1000:
        n1 = next(f for f in range(2, n + 1) if n % f == 0)
        for sign in (-1, 1):
            for a, b in zip(ttwiddle.twiddle_outer(n1, n // n1, n, sign),
                            jtwiddle.twiddle_outer(n1, n // n1, n, sign)):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [2, 8, 30, 64, 256, 1024, 2048, 4096])
def test_halfcomplex_untangle_equal(n):
    for dtype in (np.float32, np.float64):
        for a, b in zip(ttwiddle.halfcomplex_untangle(n, dtype),
                        jtwiddle.halfcomplex_untangle(n, dtype)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_real_gates_equal_over_all_lengths():
    assert tsk.MAX_REAL_N == jps.MAX_REAL_N
    for n in range(0, 2 * tsk.MAX_LAST_N + 3):
        assert tsk.r2c_last_supported(n) == jps.r2c_last_supported(n), n
        assert tsk.r2c_half_supported(n) == jps.r2c_half_supported(n), n
        assert tsk.r2c_packed_supported(n) == jps.r2c_packed_supported(n), n


@pytest.mark.parametrize("n", [7, 31, 48, 100, 128, 2053, 4097, 32768])
def test_schedule_description_equal(n):
    for mr in (16, 128):
        assert (tstockham.schedule_description(n, mr)
                == jstockham.schedule_description(n, mr))


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096])
def test_four_step_stage_tables_equal(n, sign):
    from regent_fft_tpu_torch.ops import fourstep as tfs
    r1, r2 = tsk._a0fs_split(n)
    for a, b in zip(tfs._a0fs_tw_mats(n, sign), jps._a0fs_tw_mats(n, sign)):
        assert a.shape == (r2, r1, r1)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    for r in (r1, r2):
        for a, b in zip(tfs._dft_mat(r, sign), jps._dft_mat(r, sign)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
