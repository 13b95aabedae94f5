"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole), and a reference that loads nothing of the program."""
import json
import os
import subprocess
import sys

from fftbench import cell, run

FORBIDDEN = {"jax", "jaxlib", "flax", "regent_fft_tpu"}

RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
from fftbench import run
from fftbench.tests import cells
run.fix_environment({{}})
rc = run.run_and_print(cells.bench(), cells.workload(), cells.config(),
                       7, 0.1, True, "cpu", "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from fftbench import reference, traffic
cfg = {{"shape": [4, 8, 16], "kind": "c2c"}}
block = lambda b: traffic.field_block(cfg, 3, 0, b, 2, "cpu")
ref = reference.forward_reference(block, 2, "c2c", slice(0, 8))
x = torch.complex(*[torch.cat(p).double() for p in zip(block(0), block(1))])
want = torch.fft.fftn(x)[..., 0:8]
assert torch.allclose(ref, want, rtol=1e-12, atol=1e-9)
got = reference.compare(want.to(torch.complex64), ref)
assert got["rel_l2"] < 1e-6 and got["max_gap"] < 1e-5
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    env = dict(os.environ, REGENT_FFT_NO_WISDOM="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(run.ROOT))],
                         capture_output=True, text=True, env=env,
                         timeout=240, cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_the_port_and_no_jax():
    mods = _modules(RUN_TINY)
    assert "regent_fft_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE_ONLY)
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"regent_fft_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "regent_fft_tpu_torch_extra", sys)
    assert "regent_fft_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "regent_fft_tpu.plan", sys)
    assert cell.forbidden_modules() == ["regent_fft_tpu"]


def test_a_forbidden_module_withholds_the_result(monkeypatch, capsys):
    from fftbench.tests import cells
    monkeypatch.setitem(sys.modules, "jax", sys)
    rc = run.run_and_print(cells.bench(), cells.workload(), cells.config(),
                           5, 0.05, False, "cpu", "cpu")
    captured = capsys.readouterr()
    assert rc != 0 and captured.out.strip() == ""
    assert "jax" in captured.err.splitlines()[-1]


def test_the_environment_is_fixed(tmp_path):
    env = {"REGENT_FFT_GAP_FUSED": "1", "REGENT_FFT_WISDOM": "/x.json",
           "REGENT_FFT_LOG": "2", "HOME": "/home/u"}
    run.fix_environment({"REGENT_FFT_F2_IMPL": "ring"}, tmp_path, env)
    assert env == {
        "REGENT_FFT_F2_IMPL": "ring", "REGENT_FFT_NO_WISDOM": "1",
        "HOME": "/home/u",
        "TORCH_EXTENSIONS_DIR": str(tmp_path / "build" / "fftbench" /
                                    "torch_extensions"),
        "TRITON_CACHE_DIR": str(tmp_path / "build" / "fftbench" / "triton")}


def test_no_card_means_no_result(capsys):
    """The look for cards: on a host without one, exit 2 and no line."""
    import torch
    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "c2c3d_512_c64.complex", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""
