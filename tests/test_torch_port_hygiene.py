"""The port stands alone: neither it nor ``chip_smoke.py`` imports JAX or
the JAX package, and it never runs quietly on the host when the card is
missing."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import regent_fft_tpu_torch as rt

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import regent_fft_tpu_torch
import regent_fft_tpu_torch.api, regent_fft_tpu_torch.plan
import regent_fft_tpu_torch.ops._build, regent_fft_tpu_torch.ops.stockham_kernels
import regent_fft_tpu_torch.ops.nd, regent_fft_tpu_torch.utils.verify
import regent_fft_tpu_torch.ops.real, regent_fft_tpu_torch.ops.stockham
import regent_fft_tpu_torch.ops.fourstep, regent_fft_tpu_torch.ops.pallas_fft
import regent_fft_tpu_torch.utils.plog, regent_fft_tpu_torch.guru
import regent_fft_tpu_torch.ops.bluestein, regent_fft_tpu_torch.ops.rader
import regent_fft_tpu_torch.ops.r2r, regent_fft_tpu_torch._czt
import regent_fft_tpu_torch.ops.fftlog, regent_fft_tpu_torch.ops.nufft
import regent_fft_tpu_torch.native.planner, regent_fft_tpu_torch.bench_cli
import regent_fft_tpu_torch.utils.flopcount, regent_fft_tpu_torch.utils.timing
import regent_fft_tpu_torch.utils.calibrate, regent_fft_tpu_torch.utils.measure
import regent_fft_tpu_torch.utils.wisdom, regent_fft_tpu_torch.utils.trace
import regent_fft_tpu_torch.signal, regent_fft_tpu_torch.spectral
import regent_fft_tpu_torch.torch_fft, regent_fft_tpu_torch.scipy_backend
import regent_fft_tpu_torch.parallel.mesh
import regent_fft_tpu_torch.parallel.distributed
import regent_fft_tpu_torch.parallel.transpose
import regent_fft_tpu_torch.parallel.distributed_r2r
import chip_smoke
sys.path.insert(0, "tests")
import torch_dist_pool
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "regent_fft_tpu" or m.startswith("regent_fft_tpu.")]
print(",".join(bad))
"""


def test_import_pulls_in_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


# Every module of the port; a new module must be added here and to _PROBE.
PORT_MODULES = {
    "__init__.py", "_czt.py", "api.py", "dtypes.py", "guru.py", "plan.py",
    "ops/__init__.py", "ops/_build.py", "ops/bluestein.py", "ops/factor.py",
    "ops/fftlog.py", "ops/fourstep.py", "ops/nd.py", "ops/nufft.py",
    "ops/pallas_fft.py", "ops/r2r.py", "ops/rader.py",
    "ops/real.py", "ops/stockham.py", "ops/stockham_kernels.py",
    "ops/twiddle.py", "utils/__init__.py", "utils/plog.py", "utils/verify.py",
    "bench_cli.py", "native/__init__.py", "native/planner.py",
    "utils/calibrate.py", "utils/flopcount.py", "utils/measure.py",
    "utils/timing.py", "utils/wisdom.py", "signal.py", "spectral.py",
    "torch_fft.py", "scipy_backend.py", "parallel/__init__.py",
    "parallel/mesh.py", "parallel/distributed.py", "parallel/transpose.py",
    "parallel/distributed_r2r.py", "utils/trace.py"}
# The port's CPU test files, one or more per slice.
PORT_TESTS = {
    "test_torch_port_hygiene.py", "test_torch_port_tables.py",
    "test_torch_port_kernels.py", "test_torch_port_plan.py",
    "test_torch_port_real.py", "test_torch_port_real_plan.py",
    "test_torch_port_fourstep.py", "test_torch_port_complex32.py",
    "test_torch_port_complex128.py", "test_torch_port_complex32_routes.py",
    "test_torch_port_gap.py", "test_torch_port_pallas_fft.py",
    "test_torch_port_precision.py", "test_torch_port_fused2_cluster.py",
    "test_torch_port_last_rows.py", "test_torch_port_gap_cluster.py",
    "test_torch_port_cols_regs.py", "test_torch_port_real_rows.py",
    "test_torch_port_ring_tma.py", "test_torch_port_fourstep_regs.py",
    "test_torch_port_rader_bluestein.py", "test_torch_port_guru.py",
    "test_torch_port_iface.py", "test_torch_port_r2r.py",
    "test_torch_port_czt.py", "test_torch_port_fftlog.py",
    "test_torch_port_nufft.py", "test_torch_port_planner.py",
    "test_torch_port_measure.py", "test_torch_port_wisdom.py",
    "test_torch_port_calibrate.py", "test_torch_port_bench_cli.py",
    "test_torch_port_signal.py", "test_torch_port_spectral.py",
    "test_torch_port_torch_fft.py", "test_torch_port_scipy_backend.py",
    "test_torch_port_distributed.py", "test_torch_port_distributed_uneven.py",
    "test_torch_port_distributed_p8.py",
    "test_torch_port_distributed_real.py",
    "test_torch_port_distributed_r2r.py", "test_torch_port_switches.py",
    "test_torch_port_trace.py", "test_torch_port_npb_ft.py",
    "test_torch_port_f64_bodies.py", "test_torch_port_complex128_route.py",
    "test_torch_port_interleaved.py"}
# The rank pool of the distributed tests: every rank imports it, so it
# stands alone like the port.
POOL = "tests/torch_dist_pool.py"


def test_file_lists_cover_the_port():
    pkg = REPO / "regent_fft_tpu_torch"
    assert {str(p.relative_to(pkg)) for p in pkg.rglob("*.py")} == PORT_MODULES
    assert {p.name for p in (REPO / "tests").glob("test_torch_port_*.py")} \
        == PORT_TESTS
    for name in PORT_TESTS - {"test_torch_port_hygiene.py"}:
        text = (REPO / "tests" / name).read_text()
        assert "regent_fft_tpu_torch" in text, name


def test_no_source_file_names_jax():
    """Nor do the port's chip scripts (scripts/torch_*.py) and the rank
    pool of the distributed tests."""
    files = list((REPO / "regent_fft_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    files.append(REPO / POOL)
    assert REPO / "scripts" / "torch_ring_compare.py" in files
    for p in files + [REPO / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("import regent_fft_tpu ")
                        or s.startswith("from regent_fft_tpu ")
                        or s.startswith("from regent_fft_tpu.")
                        or s.startswith("import regent_fft_tpu.")), (p, s)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt.clear_plan_cache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.make_plan((8, 1024))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.fft(torch.zeros(8, 1024, dtype=torch.complex64))
    assert rt.cached_plans() == []
    x = torch.zeros(8, 64)
    for call in (lambda: rt.dct(x), lambda: rt.czt(x),
                 lambda: rt.fht(x, 0.1, 0.5),
                 lambda: rt.nufft1d1(x[0], x[0], 16),
                 lambda: rt.plan_r2r((8, 64), rt.R2RKind.REDFT10),
                 lambda: rt.plan_guru_r2r([(64, 1, 1)], rt.R2RKind.DHT)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_is_opt_in_and_output_is_complex64_on_device():
    p = rt.make_plan((8, 1024), device="cpu")
    assert p.spec.device == "cpu" and p.backend == "xla"
    y = p(torch.zeros(8, 1024, dtype=torch.complex128))
    assert y.dtype == torch.complex64 and y.device.type == "cpu"
