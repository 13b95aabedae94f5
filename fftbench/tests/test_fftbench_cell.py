"""A tiny test-only cell end to end on the host, and the check it makes:
sound runs pass, the control and every planted fault fail it."""
import json

import pytest

from fftbench import run
from fftbench.tests import cells, faults

SEED = 2 ** 33 + 12345      # larger than 32 bits hold


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("kind,interface", [
    ("c2c", "complex"), ("c2c", "planes"), ("r2c", "complex"),
    ("r2c", "planes")])
def test_tiny_cell_prints_one_valid_line(capsys, kind, interface, trace):
    wl = cells.workload(interface)
    rc = run.run_and_print(cells.bench(), wl, cells.config(kind), SEED, 0.2,
                           bool(trace), "cpu", "cpu")
    line = last_line(capsys)
    assert rc == 0
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2 * 32
    assert line["device"]["count"] == 1
    want = {m["name"] for m in run.cell_metrics(
        cells.bench(), wl["name"], "per_layer" if trace else "end_to_end")}
    got = set(line["metrics"])
    assert got <= want
    if trace:
        # a host run reads no device metric
        assert got == {"host_ms"}
        assert "busy_s" not in line["device"]
    else:
        assert got == {"gflops", "step_ms_p95", "setup_s"}
    for k, v in line["checks"].items():
        assert v["value"] < v["limit"], k


def _judge(recs):
    out, _ = run.result(cells.bench(), cells.workload(), recs, False, "cpu")
    return out


@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_the_control_fails_the_check(kind):
    """The program's own complex32 path in place of the complex64 one."""
    recs = run.run_cell(cells.workload(), cells.config(kind), [SEED, SEED + 1],
                        0.05, False, "cpu", control=True)
    for r in recs:
        out = _judge(r)
        assert out["correct"] is False
        assert out["checks"]["fwd_rel_l2"]["value"] > 1e-3


@pytest.mark.parametrize("fault", sorted(faults.STEP_FAULTS))
@pytest.mark.parametrize("kind,interface", [("c2c", "complex"),
                                            ("c2c", "planes"),
                                            ("r2c", "complex")])
def test_planted_faults_fail_the_check(monkeypatch, fault, kind, interface):
    from regent_fft_tpu_torch import plan
    monkeypatch.setattr(plan, "run_steps",
                        faults._wrap_steps(faults.STEP_FAULTS[fault]))
    plan.clear_plan_cache()
    recs = run.run_cell(cells.workload(interface), cells.config(kind), [SEED],
                        0.05, False, "cpu")[0]
    out = _judge(recs)
    assert out["correct"] is False
    assert out["failed"] >= 1


def _slab(patch=None):
    wl = cells.workload("planes", "c2c3d_1024_c64_slab4.planes", chips=2)
    return run.run_cell(wl, cells.config("c2c", "slab", (8, 8, 16)), [SEED],
                        0.05, False, "cpu", patch=patch)[0]


def test_slab_cell_on_two_gloo_ranks():
    recs = _slab()
    assert len(recs) == 2
    out = _judge(recs)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 2


def test_slab_without_the_exchange_fails_the_check():
    out = _judge(_slab("fftbench.tests.faults:skip_exchange"))
    assert out["correct"] is False
