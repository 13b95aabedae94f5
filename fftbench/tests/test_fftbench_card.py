"""The control at the cells' own sizes, on the card: the program's own
complex32 path fails the check on three seeds, and the complex64 path
passes it.  Run on a machine with the cells' cards:

    python3 -m pytest fftbench/tests/test_fftbench_card.py -m card
"""
import json

import pytest

from fftbench import readings, run

ONE_CHIP = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]
    if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_the_control_fails_at_the_cells_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, wl, cfg = run.load_cell(cell)
    run.fix_environment(wl.get("env", {}))
    prog = readings.readings(wl, cfg, [101], 0.5, False)
    ctrl = readings.readings(wl, cfg, [201, 202, 203], 0.5, True)
    limits = wl["limits"]
    assert all(v <= limits[k] for k, v in prog[101].items())
    for nums in ctrl.values():
        assert any(v > limits[k] for k, v in nums.items())
