"""Tiny test-only cells: the shapes of the real cells' kinds and
interfaces, cut to run on the host through the port's plain versions
(``backend="stockham"``)."""
import copy
import json

from fftbench import run

LIMITS = {"fwd_rel_l2": 1e-4, "fwd_max_gap": 1e-3,
          "bwd_rel_l2": 1e-4, "bwd_max_gap": 1e-3}


def bench() -> dict:
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


def config(kind="c2c", decomposition="none", shape=(8, 16, 32)) -> dict:
    return {"name": f"tiny_{kind}", "shape": list(shape), "axes": [0, 1, 2],
            "kind": kind, "dtype": "complex64", "norm": "backward",
            "planner": "estimate", "backend": "stockham",
            "chips": 2 if decomposition == "slab" else 1,
            "decomposition": decomposition, "reduced": []}


def workload(interface="complex", name="c2c3d_512_c64.complex",
             chips=1) -> dict:
    """A workload under a real cell's name, so it reports that cell's
    metrics."""
    return {"name": name, "config": "tiny", "interface": interface,
            "loop": "closed", "callers": 1, "inflight": 2, "fields": 2,
            "chips": chips, "limits": copy.deepcopy(LIMITS)}
