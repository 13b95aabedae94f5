"""The port's calibration (``utils/calibrate.py``), roofline model
(``utils/flopcount.py``), timer (``utils/timing.py``) and
``Plan.benchmark`` against the JAX package's: the same derived cost
parameters, the same wisdom round trip, probes that run on the CPU, a
datasheet with no TPU figure, and the benchmark's keys (the mirrored cases
of tests/test_calibrate.py and test_autodiff.py's benchmark cases)."""
import json
from pathlib import Path

import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.utils import calibrate as Rcal
from regent_fft_tpu.utils import flopcount as Rfc
from regent_fft_tpu.utils import timing as Rtiming

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.native import planner as native
from regent_fft_tpu_torch.utils import calibrate as cal
from regent_fft_tpu_torch.utils import flopcount as fc
from regent_fft_tpu_torch.utils import timing

DICTS = [dict(device="test", mxu_tflops=40.0, vpu_gflops=2000.0,
              hbm_gbps=600.0, stage_overhead_s=5e-6),
         dict(device="NVIDIA H100 80GB HBM3", mxu_tflops=51.3,
              vpu_gflops=780.0, hbm_gbps=3010.0, stage_overhead_s=7.5e-5),
         dict(device="cpu", mxu_tflops=0.5, vpu_gflops=25.0, hbm_gbps=50.0,
              stage_overhead_s=0.0, mxu_edge=64.0),
         dict(device="zero", mxu_tflops=0.0, vpu_gflops=0.0, hbm_gbps=0.0,
              stage_overhead_s=1e-5)]


@pytest.fixture(autouse=True)
def _clean():
    # before as well as after: a JAX test file earlier in the same
    # worker may have left plans and winners in the JAX tables
    rt.cleanup()
    R.cleanup()
    yield
    rt.cleanup()
    R.cleanup()


@pytest.mark.parametrize("d", DICTS)
def test_derived_parameters_equal_jax(d):
    ours, theirs = cal.Calibration(**d), Rcal.Calibration(**d)
    assert ours.vpu_rate == theirs.vpu_rate
    assert ours.bw_unit == theirs.bw_unit
    for n, b in ((1024, 1024), (256, 64), (4096, 8)):
        assert ours.stage_overhead_units(n, b) == \
            theirs.stage_overhead_units(n, b)
    assert ours.to_dict() == theirs.to_dict()
    assert cal.Calibration.from_dict(theirs.to_dict()) == ours


def test_calibration_derived_params():
    """Counterpart: test_calibrate.py."""
    c = cal.Calibration(**DICTS[0])
    assert c.vpu_rate == pytest.approx(2000e9 / 40e12)
    assert c.stage_overhead_units(n=1024, batch=1024) == pytest.approx(
        5e-6 * 40e12 / (0.25 * 1024 * 1024))


def test_install_overlays_the_roofline_and_the_planner():
    c = cal.Calibration(**DICTS[1])
    base = fc.detect_hardware("cuda:0") if torch.cuda.is_available() else None
    default_cost = native.schedule_cost(1024)
    cal.install_calibration(c)
    assert native.schedule_cost(1024) != default_cost
    hw = fc.detect_hardware()
    assert hw.f32_tflops == pytest.approx(51.3)
    assert hw.hbm_gbps == pytest.approx(3010.0)
    assert hw.name == "h100-sxm (measured)" and hw.bf16_tflops == 989.0
    assert cal.current() == c
    assert fc.detect_hardware("cpu") is None      # measured on another device
    cal.reset_calibration()
    assert native.schedule_cost(1024) == default_cost
    assert cal.current() is None
    assert fc.detect_hardware("cpu") is None
    assert base is None or "measured" not in base.name


def test_datasheet_holds_the_h100_only():
    h = fc._detect_datasheet("NVIDIA H100 80GB HBM3")
    assert (h.hbm_gbps, h.f32_tflops) == (3350.0, 67.0)
    for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "tpu v5 lite",
                 "TPU v5e", "NVIDIA A100-SXM4-80GB", "cpu", ""):
        assert fc._detect_datasheet(name) is None, name
    assert fc.detect_hardware("cpu") is None
    assert fc.roofline_fraction(1 << 20, 1e6, 1e-3, None) is None
    assert fc.roofline_fraction(2 * 3350 * 10 ** 6, 0.0, 2e-3, h) == \
        pytest.approx(1.0)
    assert [v for v in vars(fc).values()
            if isinstance(v, fc.HardwareModel)] == [fc.H100]
    text = Path(fc.__file__).read_text().lower()
    assert not any(t in text for t in ("v5e", "v5 lite", "819", "197"))
    # the libbench2 convention, as in the JAX package
    for n, t, real in ((1024, 1e-3, False), (1 << 20, 2.5e-3, True),
                       (1, 1.0, False)):
        assert fc.mflops_convention(n, t, real) == \
            Rfc.mflops_convention(n, t, real)
        assert fc.gflops_convention(n, t, real) == \
            Rfc.gflops_convention(n, t, real)


def test_calibration_wisdom_roundtrip():
    c = cal.Calibration(**DICTS[0])
    cal.install_calibration(c)
    blob = rt.export_wisdom_to_string()
    assert json.loads(blob)["calibration"]["mxu_tflops"] == 40.0
    rt.forget_wisdom()
    assert cal.current() is None
    rt.import_wisdom_from_string(blob, build=False)
    assert cal.current() == c
    cal.reset_calibration()
    assert "calibration" not in json.loads(rt.export_wisdom_to_string())


def test_calibrate_runs_on_cpu():
    """Counterpart: test_calibrate.py (quick mode on the CPU)."""
    c = rt.calibrate(install=True, quick=True, device="cpu")
    assert c.device == "cpu"
    assert c.mxu_tflops > 0 and c.vpu_gflops > 0 and c.hbm_gbps > 0
    assert c.stage_overhead_s >= 0.0
    assert cal.current() == c
    assert 0 < c.vpu_rate < 10.0 and c.stage_overhead_units() >= 0.0
    hw = fc.detect_hardware("cpu")
    assert hw.name == "cpu (measured)" and hw.hbm_gbps == c.hbm_gbps


def test_timer_on_the_cpu():
    calls = []
    assert timing.time_ms(lambda: calls.append(1), reps=5, device="cpu") >= 0
    assert len(calls) == 6                              # one warm-up
    assert timing.time_ms(lambda: None, 3) >= 0
    assert timing.methodology("cpu") == "host-clock"
    assert timing.methodology("cuda") == "cuda-events"
    assert timing.FLUSH_BYTES >= 4 * 50 << 20     # past the H100's 50 MB L2
    assert timing.measured_copy_gbps(1 << 20, reps=2, min_bytes=1 << 20,
                                     device="cpu") > 0
    a = torch.randn(64, 64)
    total, rows = timing.trace(lambda: a @ a, "cpu")
    assert total > 0 and rows and rows == sorted(rows, key=lambda r: -r[1])


@pytest.mark.parametrize("kind", ["c2c", "r2c", "c2r"])
def test_time_plan_runs_the_core(kind):
    k = {"c2c": rt.Kind.C2C, "r2c": rt.Kind.R2C, "c2r": rt.Kind.C2R}[kind]
    d = rt.BACKWARD if kind == "c2r" else rt.FORWARD
    p = rt.make_plan((4, 64), axes=(1,), kind=k, direction=d, device="cpu")
    args = timing.plan_inputs(p)
    assert len(args) == (1 if kind == "r2c" else 2)
    assert all(a.dtype == p.cdtype and a.device.type == "cpu" for a in args)
    assert 0 < timing.time_plan(p, reps=2) < 1
    assert 0 < timing.time_plan_latency(p, iters=2) < 1


def test_plan_benchmark_keys_match_jax(monkeypatch, tmp_path):
    """Counterpart: test_autodiff.py's benchmark cases (the JAX timer
    injected)."""
    monkeypatch.setattr(Rtiming, "time_plan", lambda plan, **kw: 1e-3)
    monkeypatch.setattr(Rtiming, "time_plan_latency",
                        lambda plan, **kw: 1e-3)
    jp = R.make_plan((4, 64), axes=(1,), kind=R.Kind.C2C, direction=R.FORWARD)
    p = rt.make_plan((4, 64), axes=(1,), device="cpu")
    for latency in (False, True):
        ours = p.benchmark(iters=2, latency=latency)
        theirs = jp.benchmark(iters=1, latency=latency)
        assert set(ours) == set(theirs)
        assert ours["time_s"] > 0 and ours["gflops_convention"] > 0
        assert ours["roofline_fraction"] is None and ours["hardware"] is None
        assert ours["methodology"] == ("latency" if latency
                                       else "host-clock")
    res = p.benchmark(iters=1, profile_dir=str(tmp_path))
    assert res["time_s"] > 0
    assert (tmp_path / "trace.json").exists()
    assert res["trace"]["ms"] > 0 and res["trace"]["by_kernel"]
    # a calibration of the CPU gives the cost model rates, not a roofline
    c = cal.Calibration(**DICTS[2])
    cal.install_calibration(c)
    assert fc.detect_hardware("cpu").name == "cpu (measured)"
    res = p.benchmark(iters=1)
    assert res["roofline_fraction"] is None and res["hardware"] is None


def test_benchmark_roofline_is_the_functions_bound(monkeypatch):
    """The roofline prices the plan's bytes and its 5 N log2 N flops on
    the H100's datasheet, never the dense schedule's algorithm_flops
    (which would put a 512^3 plan above its roofline), and never the
    lower rates a calibration of the card measured."""
    monkeypatch.setattr(timing, "time_plan", lambda plan, **kw: 2e-3)
    monkeypatch.setattr(fc, "_device_kind",
                        lambda device=None: "nvidia h100 80gb hbm3")
    p = rt.make_plan((512, 512, 512), device="cpu")
    res = p.benchmark()
    bound = max(p.bytes_ideal / 3350e9, p.flops / 67e12)
    assert res["roofline_fraction"] == pytest.approx(bound / 2e-3)
    assert p.bytes_ideal / 3350e9 > p.flops / 67e12
    assert p.algorithm_flops / 67e12 > 2e-3       # the dense schedule's
    assert res["hardware"] == "h100-sxm"
    assert res["gflops_convention"] == pytest.approx(p.flops / 2e-3 / 1e9)
    cal.install_calibration(cal.Calibration(**DICTS[1]))
    assert fc.detect_hardware().hbm_gbps == 3010.0
    assert p.benchmark() == res
