"""The port's FFTW-grammar CLI (``regent_fft_tpu_torch/bench_cli.py``)
against the JAX package's: the same problem grammar and suites, rows with
the JAX rows' keys that verify on the CPU (the mirrored cases of
tests/test_bench_cli.py).  Both packages' timers are injected for the row
comparisons."""
import json

import pytest

from regent_fft_tpu import bench_cli as Rbench
from regent_fft_tpu.utils import timing as Rtiming

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import bench_cli
from regent_fft_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def _clean():
    yield
    rt.cleanup()


@pytest.mark.parametrize("s", ["ocf1024", "irb512x512", "orf8x8",
                               "icb3x2x2", " ocf64 ", "ocb1x1"])
def test_parse_problem_matches_jax(s):
    p, q = bench_cli.parse_problem(s), Rbench.parse_problem(s)
    assert (p.in_place, p.real, p.forward, p.sizes, p.n, str(p)) == \
        (q.in_place, q.real, q.forward, q.sizes, q.n, str(q))


@pytest.mark.parametrize("bad", ["xcf12", "oc1024", "ocf", "ocf12y3", ""])
def test_parse_rejects(bad):
    with pytest.raises(ValueError):
        bench_cli.parse_problem(bad)
    with pytest.raises(ValueError):
        Rbench.parse_problem(bad)


def test_suites_match_jax():
    assert bench_cli.SUITES == Rbench.SUITES


@pytest.mark.parametrize("prob,batch", [("ocf64", 1), ("orf8x8", 1),
                                        ("ocb64", 1), ("orb64", 1),
                                        ("ocf8x8", 3)])
def test_run_problem_rows_match_jax(monkeypatch, prob, batch):
    monkeypatch.setattr(Rtiming, "time_plan", lambda plan, **kw: 1e-3)
    monkeypatch.setattr(timing, "time_plan", lambda plan, **kw: 1e-3)
    theirs = Rbench.run_problem(Rbench.parse_problem(prob), batch=batch,
                                iters=2, verify=True)
    ours = bench_cli.run_problem(bench_cli.parse_problem(prob), batch=batch,
                                 iters=2, verify=True, device="cpu")
    assert set(ours) == set(theirs)
    assert set(ours["verify"]) == set(theirs["verify"])
    assert ours["verify"]["status"] == theirs["verify"]["status"] == "PASS"
    assert ours["problem"] == theirs["problem"] and ours["batch"] == batch
    assert ours["mflops"] == pytest.approx(theirs["mflops"])
    assert ours["methodology"] == "host-clock"
    assert ours["setup"].startswith(theirs["setup"].split(" backend")[0])
    for check in ("impulse", "linearity", "shift"):
        if check in ours["verify"]:
            assert ours["verify"][check] <= ours["verify"]["tol"]


def test_run_problem_times_on_the_cpu():
    res = bench_cli.run_problem(bench_cli.parse_problem("ocf64"), iters=2,
                                device="cpu")
    assert res["time_us"] > 0 and res["mflops"] > 0
    res = bench_cli.run_problem(bench_cli.parse_problem("orf64"), iters=2,
                                latency=True, device="cpu")
    assert res["methodology"] == "latency" and res["time_us"] > 0


def test_cli_main_smoke(capsys):
    rc = bench_cli.main(["ocf16", "--iters", "1", "--verify",
                         "--device", "cpu"])
    assert rc == 0
    assert "PASS" in capsys.readouterr().out


def test_cli_suite_smoke(capsys):
    rc = bench_cli.main(["--suite", "smoke", "--iters", "1", "--verify",
                         "--json", "--device", "cpu", "--planner", "measure"])
    assert rc == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["problem"] for r in rows] == bench_cli.SUITES["smoke"]
    assert all(r["verify"]["status"] == "PASS" for r in rows)
