"""The port's wisdom (``utils/wisdom.py``) and ``cleanup`` against the JAX
package's: the export carries the JAX export's keys, an export, forget and
import reproduces every table, another library's wisdom raises, the
autoload reads the port's default file (or ``REGENT_FFT_WISDOM``) and
nothing under ``REGENT_FFT_NO_WISDOM``; the mirrored cases of
tests/test_measure.py, test_patient.py, test_exhaustive.py and
test_calibrate.py that touch wisdom.  Races run on the injected timings of
tests/test_torch_port_measure.py."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import regent_fft_tpu as R
from regent_fft_tpu.utils import calibrate as Rcal

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.ops import factor
from regent_fft_tpu_torch.utils import calibrate as cal
from regent_fft_tpu_torch.utils import wisdom
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

from test_torch_port_measure import install_fake_timers

CAL = dict(device="test", mxu_tflops=40.0, vpu_gflops=2000.0,
           hbm_gbps=600.0, stage_overhead_s=2e-6)


@pytest.fixture(autouse=True)
def _clean():
    # before as well as after: a JAX test file earlier in the same
    # worker may have left plans and winners in the JAX tables
    rt.cleanup()
    R.cleanup()
    yield
    rt.cleanup()
    R.cleanup()


def _fill(monkeypatch):
    """Winners in every table of both packages from the same races."""
    install_fake_timers(monkeypatch)
    for mod in (rt, R):
        kw = {"device": "cpu"} if mod is rt else {}
        for planner in ("measure", "patient", "exhaustive"):
            mod.make_plan((4, 16, 16), axes=(0, 1, 2), kind=mod.Kind.C2C,
                          direction=mod.FORWARD, planner=planner, **kw)
        mod.make_plan((2, 32, 32), axes=(0, 1, 2), kind=mod.Kind.C2C,
                      direction=mod.FORWARD, planner="patient",
                      backend="stockham", **kw)
        mod.make_plan((8, 64), axes=(0, 1), kind=mod.Kind.R2C,
                      direction=mod.FORWARD, planner="measure", **kw)
    factor.set_schedule_override(1000, (125, 8))
    R.ops.factor.set_schedule_override(1000, (125, 8))
    cal.install_calibration(cal.Calibration(**CAL))
    Rcal.install_calibration(Rcal.Calibration(**CAL))


def _tables():
    return {"schedules": dict(factor._SCHEDULE_OVERRIDES),
            "backends": dict(tplan._BACKEND_WISDOM),
            "patient": dict(tplan._PATIENT_WISDOM),
            "exhaustive": dict(tplan._EXHAUSTIVE_WISDOM),
            "calibration": cal.current()}


def test_export_has_the_jax_keys(monkeypatch):
    _fill(monkeypatch)
    ours = json.loads(rt.export_wisdom_to_string())
    theirs = json.loads(R.export_wisdom_to_string())
    assert set(ours) == set(theirs)
    assert ours["version"] == theirs["version"] == wisdom.WISDOM_VERSION
    assert ours["library"] == "regent_fft_tpu_torch"
    assert theirs["library"] == "regent_fft_tpu"
    assert ours["distrib"] == []
    assert ours["calibration"] == theirs["calibration"]
    # the port's entries carry the device type they were measured on
    assert [{k: v for k, v in o.items() if k != "device"}
            for o in ours["schedules"]] == theirs["schedules"]
    assert [o["device"] for o in ours["schedules"]][-1] == "cuda"
    assert {o["device"] for o in ours["schedules"][:-1]} == {"cpu"}
    for key in ("backends", "patient", "exhaustive"):
        assert len(ours[key]) == len(theirs[key]) > 0, key
        for o, t in zip(ours[key], theirs[key]):
            assert o["winner"] == t["winner"]
            assert set(o["spec"]) == set(t["spec"]) | {"device"}
            assert o["spec"]["device"] == "cpu"
            assert {k: v for k, v in o["spec"].items() if k != "device"} \
                == t["spec"]
    assert len(ours["plans"]) == len(theirs["plans"])


def test_roundtrip_reproduces_every_table(monkeypatch, tmp_path):
    _fill(monkeypatch)
    saved = _tables()
    path = str(tmp_path / "w.json")
    rt.export_wisdom_to_filename(path)
    n_plans = len(rt.cached_plans())
    rt.forget_wisdom()
    assert _tables() == {"schedules": {}, "backends": {}, "patient": {},
                         "exhaustive": {}, "calibration": None}
    assert rt.cached_plans() == []
    n = rt.import_wisdom_from_filename(path, build=False)
    assert _tables() == saved
    assert rt.cached_plans() == []
    assert n == (1 + len(saved["schedules"]) + len(saved["backends"])
                 + len(saved["patient"]) + len(saved["exhaustive"]) + n_plans)
    # build=True makes the plans again, and they take the cached winners
    rt.forget_wisdom()
    rt.import_wisdom_from_filename(path)
    assert len(rt.cached_plans()) == n_plans
    p = rt.make_plan((4, 16, 16), device="cpu", planner="patient")
    assert p.measurements["patient"]["timings"] == "cached-wisdom"


def test_foreign_wisdom_raises_and_autoload_skips_it(monkeypatch, tmp_path):
    R.ops.factor.set_schedule_override(60, (10, 6))
    foreign = R.export_wisdom_to_string()
    with pytest.raises(ValueError, match="regent_fft_tpu"):
        rt.import_wisdom_from_string(foreign)
    assert factor._SCHEDULE_OVERRIDES == {}
    bad_version = json.dumps({"version": 99, "library": wisdom.LIBRARY})
    with pytest.raises(ValueError, match="version"):
        rt.import_wisdom_from_string(bad_version)
    path = tmp_path / "foreign.json"
    path.write_text(foreign)
    monkeypatch.setenv("REGENT_FFT_WISDOM", str(path))
    monkeypatch.delenv("REGENT_FFT_NO_WISDOM", raising=False)
    assert wisdom.autoload_system_wisdom() == 0
    assert factor._SCHEDULE_OVERRIDES == {}


def test_autoload_reads_the_default_path(monkeypatch, tmp_path):
    factor.set_schedule_override(60, (10, 6))
    cal.install_calibration(cal.Calibration(**CAL))
    blob = rt.export_wisdom_to_string()
    rt.forget_wisdom()
    monkeypatch.delenv("REGENT_FFT_WISDOM", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert wisdom.default_wisdom_path() == str(
        tmp_path / ".regent_fft_tpu_torch.wisdom.json")
    (tmp_path / ".regent_fft_tpu_torch.wisdom.json").write_text(blob)
    monkeypatch.setenv("REGENT_FFT_NO_WISDOM", "1")
    assert wisdom.autoload_system_wisdom() == 0
    assert factor._SCHEDULE_OVERRIDES == {} and cal.current() is None
    monkeypatch.delenv("REGENT_FFT_NO_WISDOM")
    assert wisdom.autoload_system_wisdom() == 2
    assert factor._SCHEDULE_OVERRIDES == {("cuda", 60, 128): (10, 6)}
    assert cal.current() == cal.Calibration(**CAL)
    other = tmp_path / "elsewhere.json"
    other.write_text(blob.replace('"factors": [\n        10,\n        6\n',
                                  '"factors": [\n        6,\n        10\n'))
    monkeypatch.setenv("REGENT_FFT_WISDOM", str(other))
    assert wisdom.default_wisdom_path() == str(other)
    wisdom.autoload_system_wisdom()
    assert factor._SCHEDULE_OVERRIDES == {("cuda", 60, 128): (6, 10)}
    (tmp_path / "corrupt.json").write_text("{not json")
    monkeypatch.setenv("REGENT_FFT_WISDOM", str(tmp_path / "corrupt.json"))
    assert wisdom.autoload_system_wisdom() == 0


def test_autoload_runs_at_import(tmp_path):
    """Counterpart: test_measure.py's system-wisdom case, in fresh
    processes."""
    factor.set_schedule_override(60, (10, 6))
    cal.install_calibration(cal.Calibration(**CAL))
    path = tmp_path / "wisdom.json"
    rt.export_wisdom_to_filename(str(path))
    code = ("import regent_fft_tpu_torch as rt\n"
            "from regent_fft_tpu_torch.ops import factor as f\n"
            "from regent_fft_tpu_torch.utils import calibrate as c\n"
            "print(f.schedule_override(60), "
            "c.current() and c.current().hbm_gbps)\n")
    env = dict(os.environ, REGENT_FFT_WISDOM=str(path))
    env.pop("REGENT_FFT_NO_WISDOM", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.stdout.split() == ["(10,", "6)", "600.0"], out.stderr
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(env, REGENT_FFT_NO_WISDOM="1"),
                         capture_output=True, text=True, timeout=240)
    assert out.stdout.split() == ["None", "None"], out.stderr


def test_cleanup_empties_every_table_and_held_plans_run(monkeypatch):
    """Counterpart: plan.py:1174 (fftw_cleanup)."""
    _fill(monkeypatch)
    held = rt.make_plan((4, 16, 16), device="cpu", planner="patient")
    assert all(_tables()[k] for k in ("schedules", "backends", "patient",
                                      "exhaustive"))
    rt.cleanup()
    assert _tables() == {"schedules": {}, "backends": {}, "patient": {},
                         "exhaustive": {}, "calibration": None}
    assert rt.cached_plans() == []
    x = (np.random.default_rng(0).standard_normal((4, 16, 16))
         + 1j).astype(np.complex64)
    assert rel_l2(held(x), np.fft.fftn(x.astype(np.complex128))) \
        <= tolerance(x.size)


def test_exports_hold_the_jax_names():
    """Every name the JAX package exports from its measure, wisdom and
    calibrate modules, and cleanup."""
    mods = {"regent_fft_tpu.utils.measure", "regent_fft_tpu.utils.wisdom",
            "regent_fft_tpu.utils.calibrate"}
    names = {n for n in dir(R) if not n.startswith("_")
             and getattr(getattr(R, n), "__module__", None) in mods}
    names |= {"cleanup", "NO_TIMELIMIT", "wisdom"}
    assert names >= {"set_timelimit", "get_timelimit", "calibrate",
                     "Calibration", "export_wisdom_to_string",
                     "import_wisdom_from_filename", "forget_wisdom"}
    missing = sorted(n for n in names if not hasattr(rt, n))
    assert missing == []
    assert rt.NO_TIMELIMIT == R.NO_TIMELIMIT
    for n in ("install_calibration", "reset_calibration"):
        assert callable(getattr(rt, n))
