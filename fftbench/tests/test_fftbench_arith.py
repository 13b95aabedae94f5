"""The yardstick and the metric readers on hand-made records."""
import math

import pytest

from fftbench import devtrace, kernel_class as kc, run, yardstick

H100 = yardstick.peaks("NVIDIA H100 80GB HBM3")


def test_peaks_only_for_the_sxm_card():
    assert H100 == {"name": "h100-sxm", "hbm_gbps": 3350.0,
                    "f32_tflops": 67.0}
    assert yardstick.peaks("NVIDIA H100 PCIe") is None
    assert yardstick.peaks("NVIDIA H100 NVL") is None
    assert yardstick.peaks("cpu") is None


def test_work_and_bytes_of_the_cells():
    n = 512 ** 3
    assert yardstick.transform_flops((512,) * 3, (0, 1, 2), False) == \
        5.0 * n * 27
    assert yardstick.transform_flops((512,) * 3, (0, 1, 2), True) == \
        2.5 * n * 27
    assert math.isclose(
        yardstick.transform_flops((512,) * 3, (0, 1, 2), False), 1.812e10,
        rel_tol=1e-3)
    assert yardstick.transform_flops((4, 1024), (1,), False) == \
        4 * 5.0 * 1024 * 10
    assert yardstick.transform_bytes((512,) * 3, (0, 1, 2), "c2c",
                                     "complex64") == 2 * 2 ** 30
    half = 512 * 512 * 257 * 8
    for kind in ("r2c", "c2r"):
        assert yardstick.transform_bytes((512,) * 3, (0, 1, 2), kind,
                                         "complex64") == 2 ** 29 + half
    # 2 GiB at 3.35 TB/s bounds a 512^3 C2C: 0.641 ms
    t = yardstick.least_time_s(1.812e10, 2 * 2 ** 30, H100)
    assert math.isclose(t, 2 * 2 ** 30 / 3.35e12)
    assert math.isclose(t * 1e3, 0.641, rel_tol=1e-3)
    # flops bound where bytes are few
    assert yardstick.least_time_s(67e12, 1, H100) == pytest.approx(1.0)


def test_percentile_is_nearest_rank():
    assert yardstick.percentile(list(range(1, 101)), 95) == 95
    assert yardstick.percentile(list(range(20, 0, -1)), 95) == 19
    assert yardstick.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_union_and_gaps_of_intervals():
    iv = [(10, 30), (20, 40), (60, 70), (65, 66)]
    assert yardstick.union_length(iv) == 40
    assert yardstick.gaps(iv, 0, 100) == [(0, 10), (40, 60), (70, 100)]
    assert yardstick.gaps(iv, 15, 35) == []
    assert yardstick.gaps([], 0, 5) == [(0, 5)]


@pytest.mark.parametrize("name,cat,cls", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, ...)", "kernel",
     kc.ATEN),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
     "unsigned int, 4, 64, 64>(...)", "kernel", kc.ATEN),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "kernel",
     kc.NCCL),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", kc.MEMCPY),
    ("Memset (Device)", "gpu_memset", kc.MEMSET),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", "kernel",
     kc.CUBLAS),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>"
     "(...)", "kernel", kc.CUBLAS),
    ("void fft_fused2_kernel<float, false>(float const*, float const*)",
     "kernel", kc.PORT),
    ("void fft_cols_kernel<float, ColsGeo<512>, 8, 8, 8>(...)", "kernel",
     kc.PORT),
    ("triton_red_fused_new_kernel_0", "kernel", kc.PORT),
])
def test_kernel_classes(name, cat, cls):
    assert kc.classify(name, cat) == cls


def test_short_names_are_stable():
    assert kc.short_name("void fft_fused2_kernel<float, false>(float*)") == \
        "fft_fused2_kernel"
    assert kc.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float,"
        " unsigned int, 4, 64, 64>(int)") == "at::native::CatArrayBatchedCopy"
    assert kc.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert kc.short_name("ncclDevKernel_SendRecv(x)") == \
        "ncclDevKernel_SendRecv"


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
           "ts": 1000.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "name": "enqueue.fwd",
           "ts": 1000.0, "dur": 15.0},
          {"ph": "X", "cat": "user_annotation", "name": "wait",
           "ts": 1050.0, "dur": 20.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1001.0,
           "dur": 3.0},
          {"ph": "X", "cat": "kernel", "name": "void fft_cols_kernel<f>(x)",
           "ts": 1010.0, "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "void at::native::k<f>(x)",
           "ts": 1020.0, "dur": 20.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (D -> D)",
           "ts": 1080.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_SendRecv(x)",
           "ts": 1090.0, "dur": 5.0},
          {"ph": "X", "cat": "kernel", "name": "void early<f>(x)",
           "ts": 900.0, "dur": 5.0},
          {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1010.0}]
    return ev


def _rec(trace, steps=2, chips=1):
    return {"steps": steps, "chips": chips, "trace": trace, "peak": H100,
            "flops_per_step": 2 * 1.812e10, "bytes_per_step": 4 * 2 ** 30,
            "enqueue_s": 0.004, "launches": {"fft_cols": 8},
            "step_ms": [1.0, 2.0], "window_s": 0.5, "setup_s": 12.0,
            "peak_bytes": 3 * 2 ** 30}


def test_trace_reduction_and_device_readers():
    tr = devtrace.reduce_events(_events())
    assert tr["window"] == [1000.0, 1100.0]
    assert [o[0] for o in tr["ops"]] == [
        "fft_cols_kernel", "at::native::k", "Memcpy DtoD",
        "ncclDevKernel_SendRecv"]
    assert [o[1] for o in tr["ops"]] == [kc.PORT, kc.ATEN, kc.MEMCPY,
                                         kc.NCCL]
    assert devtrace.busy_us(tr) == 30 + 15
    recs = [_rec(tr)]
    # device ms per step: 2 steps
    assert run.read_metric("kernel_ms", recs) == pytest.approx(0.010)
    assert run.read_metric("glue_ms", recs) == pytest.approx(0.015)
    assert run.read_metric("nccl_ms", recs) == pytest.approx(0.0025)
    assert run.read_metric("idle_pct", recs) == pytest.approx(55.0)
    least_ms = 2 * 2 * 2 ** 30 / 3.35e12 * 1e3
    assert run.read_metric("kernel_roofline", recs) == pytest.approx(
        100.0 * least_ms / 0.010)
    assert run.read_metric("host_ms", recs) == pytest.approx(2.0)
    assert run.read_metric("launches_per_step", recs) == pytest.approx(4.0)
    bd = devtrace.breakdown(tr)
    assert bd["device_ops"][0] == ["fft_cols_kernel", pytest.approx(2e-5)]
    # idle: 1000-1010 (enqueue.fwd), 1040-1080 (wait at 1060), 1095-1100
    assert bd["idle_gaps"] == [["wait", pytest.approx(40e-6)],
                               ["enqueue.fwd", pytest.approx(10e-6)],
                               ["loop", pytest.approx(5e-6)]]


def test_readers_find_nothing_without_a_device_trace():
    host = {"window": [0.0, 10.0], "ops": [], "spans": []}
    for trace in (None, host):
        recs = [_rec(trace)]
        for m in ("kernel_ms", "glue_ms", "nccl_ms", "idle_pct",
                  "kernel_roofline"):
            assert run.read_metric(m, recs) is None, m
    rec = _rec(devtrace.reduce_events(_events()))
    rec["peak"] = None       # a card with no data-sheet entry
    assert run.read_metric("kernel_roofline", [rec]) is None
    rec["launches"] = {}
    assert run.read_metric("launches_per_step", [rec]) is None


def test_end_to_end_readers_over_ranks():
    a, b = _rec(None), _rec(None)
    b["step_ms"] = [3.0, 1.0]
    b["window_s"] = 0.6
    b["setup_s"] = 14.0
    b["peak_bytes"] = 5 * 2 ** 30
    recs = [a, b]
    # the slowest rank's window, the global work of every step
    assert run.read_metric("gflops", recs) == pytest.approx(
        2 * 2 * 1.812e10 / 0.6 / 1e9)
    # a step lasts as long as its slowest rank: spans [3, 2]
    assert run.read_metric("step_ms_p95", recs) == 3.0
    assert run.read_metric("setup_s", recs) == 14.0
    assert run.read_metric("peak_mem_gib", recs) == 5.0
