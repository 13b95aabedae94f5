"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, cells, and each metric's ``moves`` against the cells it lists."""
import json
import re

import pytest

from fftbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}

B = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in B["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "fftbench/run.py"]
    assert B["paths"] == ["fftbench"]
    assert all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"fftbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((run.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        assert data["axes"] == list(range(len(data["shape"])))


def test_cells():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(CELLS)
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    configs = {c["name"]: c for c in B["configs"]}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        data = json.loads(
            (run.ROOT / "fftbench" / "workloads" / f"{w['name']}.json")
            .read_text())
        assert data["name"] == w["name"]
        assert data["config"] == w["config"]
        assert data["interface"] == w["traffic"]
        assert data["chips"] == w["chips"]
        cfg = json.loads((run.ROOT / configs[w["config"]]["file"])
                         .read_text())
        assert cfg["chips"] == w["chips"]
        assert set(data["limits"]) == {"fwd_rel_l2", "fwd_max_gap",
                                       "bwd_rel_l2", "bwd_max_gap"}


def _metrics():
    return [(m, "end_to_end") for m in B["end_to_end"]] + \
        [(m, "per_layer") for m in B["per_layer"]]


@pytest.mark.parametrize("m,section", _metrics(),
                         ids=lambda v: v["name"] if isinstance(v, dict) else v)
def test_metric_entry(m, section):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (run.HERE / "metrics" / f"{m['name']}.py").exists()
    if section == "end_to_end":
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        e2e = {e["name"]: e for e in B["end_to_end"]}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_names_are_unique_and_every_cell_reports_enough():
    names = [m["name"] for m, _ in _metrics()]
    assert len(names) == len(set(names))
    assert len(B["end_to_end"]) <= 16 and len(B["per_layer"]) <= 128
    setup = [m for m in B["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for cell in CELLS:
        e2e = run.cell_metrics(B, cell, "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert run.cell_metrics(B, cell, "per_layer")


def test_layers_are_named_alike():
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"plan interface and layout glue",
                           "host dispatch", "kernels", "exchange", "device"}


def test_every_file_under_paths_is_named_from_name_characters():
    for p in (run.ROOT / "fftbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(run.ROOT).as_posix()
        assert PATH.match(rel), rel
