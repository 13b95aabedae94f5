"""NPB FT in double precision through the port, and the contraction steps'
device-resident operands, spans and counter.

The port's FT iteration (``examples/npb_ft.py``: complex128 plans on f64
planes through ``execute_split``, the evolve as a planes multiply) is held
against the plain ``torch.fft`` iteration of ``fftbench/npb_ft.py`` at a
small grid: the checksums to 1e-12 relative, the last field per element.
A complex64 computation of the cell's transform pair fails every limit of
``npb_ft_c_c128.planes``; the complex128 one passes them.  The ``direct``
and ``mixed2`` steps upload nothing once their plan is made and return
the planes a per-call build of their tables gives, bit for bit; the
products are counted in ``LAUNCHES["contract_gemm"]``.  The four metric
readers of the cell are held on hand-built records.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.ops import stockham as st
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.ops import twiddle as tw
from regent_fft_tpu_torch.utils import trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from fftbench import kernel_class as kc  # noqa: E402
from fftbench import npb_ft, run  # noqa: E402

CELL = "npb_ft_c_c128.planes"
SHAPE = (32, 16, 16)
H100 = {"name": "h100-sxm", "hbm_gbps": 3350.0, "f32_tflops": 67.0}


def _example():
    spec = importlib.util.spec_from_file_location(
        "npb_ft_example", os.path.join(ROOT, "examples", "npb_ft.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _field(shape, seed=5):
    u0 = npb_ft.initial_field(shape, seed)
    return u0, u0.real.contiguous(), u0.imag.contiguous()


# ---------------------------------------------------------------------------
# the deployment against its plain reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,iters", [(SHAPE, 6), ((16, 8, 32), 3)])
def test_port_ft_iteration_matches_the_plain_reference(shape, iters):
    u0, xr, xi = _field(shape)
    sums, (ur, ui) = _example().ft(xr, xi, iters)
    ref_sums, ref = npb_ft.iterate(u0, iters)
    assert len(sums) == len(ref_sums) == iters
    for a, b in zip(sums, ref_sums):
        assert abs(a - b) <= 1e-12 * abs(b)
    rms = float((ref.abs() ** 2).mean().sqrt())
    gap = float((torch.complex(ur, ui) - ref).abs().max())
    assert gap <= 1e-13 * rms


def test_evolve_factor_and_samples_follow_npb():
    f = npb_ft.evolve_factor((4, 4, 8), alpha=0.01)
    # kbar = 0, 1, -2, -1 on a 4-point axis; -3 at index 5 of 8
    k2 = 1 + 4 + 9
    want = np.exp(-4 * 0.01 * np.pi ** 2 * k2)
    assert float(f[1, 2, 5]) == pytest.approx(want, rel=1e-15)
    assert float(f[0, 0, 0]) == 1.0
    ex = _example().evolve_planes((4, 4, 8), 0.01, "cpu")
    assert torch.equal(ex, f)
    i0, i1, i2 = npb_ft.sample_index((4, 4, 8))
    assert len(i0) == npb_ft.SAMPLES
    assert (int(i0[0]), int(i1[0]), int(i2[0])) == (1, 3, 5)
    assert (int(i0[-1]), int(i1[-1]), int(i2[-1])) == (
        1024 % 4, 3072 % 4, 5120 % 8)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, {root!r}); "
            "from fftbench import npb_ft; "
            "npb_ft.iterate(npb_ft.initial_field((4, 4, 4), 1), 2); "
            "print(json.dumps(sorted({{m.split('.')[0] "
            "for m in sys.modules}})))").format(root=ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "regent_fft_tpu",
                       "regent_fft_tpu_torch"}


# ---------------------------------------------------------------------------
# the cell's limits: complex128 passes, complex64 fails every one
# ---------------------------------------------------------------------------
def _readings(dtype):
    _, wl, cfg = run.load_cell(CELL)
    cfg = dict(cfg, shape=list(SHAPE), dtype=dtype)
    recs = run.run_cell(wl, cfg, [2 ** 31 + 77], 0.05, False, "cpu")[0]
    return recs[0]["readings"], wl["limits"]


def test_complex128_passes_the_cells_limits():
    got, limits = _readings("complex128")
    assert set(got) == set(limits)
    assert all(got[k] <= lim / 100 for k, lim in limits.items()), got


def test_complex64_fails_every_limit_of_the_cell():
    got, limits = _readings("complex64")
    assert set(got) == set(limits)
    assert all(got[k] > lim for k, lim in limits.items()), got


# ---------------------------------------------------------------------------
# device-resident operands: fetched when the plan is made, nothing after
# ---------------------------------------------------------------------------
def _uncached_direct_axis(xr, xi, axis, n, sign):
    """The contraction with its tables made on the call, as before they
    were kept: [xr | xi] @ [[dr, di], [-di, dr]] along ``axis``."""
    npd = np.float64 if xr.dtype == torch.float64 else np.float32
    dr, di = (torch.from_numpy(a).to(xr.device, xr.dtype)
              for a in tw.dft_matrix(n, sign, npd))
    m = torch.cat([torch.cat([dr, di], 1), torch.cat([-di, dr], 1)], 0)
    y = torch.cat([xr.movedim(axis, -1), xi.movedim(axis, -1)], -1) @ m
    return (y[..., :n].movedim(-1, axis).contiguous(),
            y[..., n:].movedim(-1, axis).contiguous())


def _uncached_mixed2_axis(xr, xi, axis, n, n1, sign):
    npd = np.float64 if xr.dtype == torch.float64 else np.float32
    n2 = n // n1

    def t(a):
        return torch.from_numpy(a).to(xr.device, xr.dtype)
    d1r, d1i = map(t, tw.dft_matrix(n1, sign, npd))
    twr, twi = map(t, tw.twiddle_outer(n1, n2, n, sign, npd))
    xr, xi = xr.movedim(axis, -1), xi.movedim(axis, -1)
    lead = xr.shape[:-1]
    xr, xi = xr.reshape(*lead, n1, n2), xi.reshape(*lead, n1, n2)
    ar, ai = d1r @ xr - d1i @ xi, d1r @ xi + d1i @ xr
    ar, ai = ar * twr - ai * twi, ar * twi + ai * twr
    cr, ci = _uncached_direct_axis(ar, ai, -1, n2, sign)
    cr = cr.transpose(-1, -2).reshape(*lead, n)
    ci = ci.transpose(-1, -2).reshape(*lead, n)
    return (cr.movedim(-1, axis).contiguous(),
            ci.movedim(-1, axis).contiguous())


@pytest.fixture
def count_uploads(monkeypatch):
    """Counts every table the contraction operands make."""
    calls = []
    real = st._table

    def counted(a, dtype, device):
        calls.append(a.shape)
        return real(a, dtype, device)
    monkeypatch.setattr(st, "_table", counted)
    return calls


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
@pytest.mark.parametrize("shape,kinds", [(SHAPE, {"direct"}),
                                         ((600, 4, 6), {"mixed2", "direct"})])
def test_steps_upload_nothing_after_the_plan_is_made(count_uploads, dtype,
                                                     shape, kinds):
    rt.clear_plan_cache()
    fwd = rt.make_plan(shape, dtype=dtype, backend="xla", device="cpu")
    bwd = fwd.inverse()
    assert {k for k, _, _ in fwd.steps} == kinds
    assert count_uploads and fwd.tables and bwd.tables
    count_uploads.clear()
    u0, xr, xi = _field(shape)
    if dtype == "complex64":
        xr, xi = xr.float(), xi.float()
    for _ in range(3):
        y = fwd.execute_split(xr, xi)
        bwd.execute_split(*y)
    assert count_uploads == []
    # each step against the per-call build of its tables, bit for bit
    sign = int(fwd.spec.direction)
    for kind, a, arg in fwd.steps:
        if kind == "direct":
            got = st.direct_dft_axis(xr, xi, a, arg, sign)
            want = _uncached_direct_axis(xr, xi, a, arg, sign)
        else:
            got = st.mixed_radix_fft_axis(xr, xi, a, *arg, sign)
            want = _uncached_mixed2_axis(xr, xi, a, *arg, sign)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert count_uploads == []


def test_destroy_and_clear_drop_the_tables():
    rt.clear_plan_cache()
    p = rt.make_plan(SHAPE, dtype="complex128", device="cpu")
    key = ("h4", 16, -1, torch.float64, torch.device("cpu"))
    assert key in st._CONTRACT_TABLES
    assert any(t is st._CONTRACT_TABLES[key] for t in p.tables)
    rt.destroy_plan(p)
    assert p.tables == []
    q = rt.make_plan(SHAPE, dtype="complex128", device="cpu")
    rt.clear_plan_cache()
    assert st._CONTRACT_TABLES == {}
    # a plan a caller still holds makes its operands again on its call
    u0, xr, xi = _field(SHAPE)
    y = q.execute_split(xr, xi)
    assert key in st._CONTRACT_TABLES
    assert torch.allclose(torch.complex(*y), torch.fft.fftn(u0), rtol=0,
                          atol=1e-12)


# ---------------------------------------------------------------------------
# the counter and the spans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_3m,per_axis", [(False, 1), (True, 3)])
def test_contract_gemm_counts_each_product(use_3m, per_axis):
    rt.clear_plan_cache()
    fwd = rt.make_plan(SHAPE, dtype="complex128", device="cpu",
                       use_3m=use_3m)
    bwd = fwd.inverse()
    u0, xr, xi = _field(SHAPE)
    sk.reset_launches()
    bwd.execute_split(*fwd.execute_split(xr, xi))
    assert sk.LAUNCHES["contract_gemm"] == 6 * per_axis
    assert {k for k, v in sk.LAUNCHES.items() if v} == {"contract_gemm"}
    if not use_3m:
        # [xr | xi] (N/n, 2n) @ h4 (2n, 2n) -> (N/n, 2n), 8 B an element
        n_el = int(np.prod(SHAPE))
        want = sum(8 * (2 * n_el + 4 * n * n + 2 * n_el) for n in SHAPE)
        assert sk.LAUNCH_BYTES["contract_gemm"] == 2 * want
    sk.reset_launches()


def test_kernel_routes_count_no_contraction():
    rt.clear_plan_cache()
    p = rt.make_plan((4, 8, 256), device="cpu", backend="stockham")
    sk.reset_launches()
    p(torch.ones((4, 8, 256), dtype=torch.complex64))
    assert not any(sk.LAUNCHES.values())
    assert p.tables == []


def _tree(prof):
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.name.startswith(trace.PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for s, t, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, t, name))
    return out


@pytest.mark.parametrize("shape,kind,want", [
    (SHAPE, "direct", ["rft.contract.pack", "rft.contract.gemm",
                       "rft.contract.unpack"]),
    ((600, 4), "mixed2", ["rft.contract.pack", "rft.contract.gemm",
                          "rft.contract.twiddle", "rft.contract.pack",
                          "rft.contract.gemm", "rft.contract.unpack"])])
def test_contraction_spans_nest_in_their_step(shape, kind, want):
    rt.clear_plan_cache()
    axes = (0,) if kind == "mixed2" else None
    kw = {"axes": axes} if axes else {}
    p = rt.make_plan(shape, dtype="complex128", device="cpu", backend="xla",
                     **kw)
    assert [k for k, _, _ in p.steps][0] == kind
    u0, xr, xi = _field(shape) if len(shape) == 3 else (
        None, torch.randn(shape, dtype=torch.float64),
        torch.randn(shape, dtype=torch.float64))
    trace.set_tracing(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            p.execute_split(xr, xi)
    finally:
        trace.set_tracing(False)
    tree = _tree(prof)
    inner = [(n, up) for n, up in tree if n.startswith("rft.contract.")]
    step = f"rft.step.{kind}"
    assert all(up == step for _, up in inner)
    per_step = len(inner) // len(p.steps)
    assert [n for n, _ in inner[:per_step]] == want
    assert "rft.build" not in [n for n, _ in tree]


# ---------------------------------------------------------------------------
# the cell's four readers on hand-built records
# ---------------------------------------------------------------------------
def _ops():
    return [["sm90_xmma_gemm_f64f64_f64f64_f64_nn_n", kc.CUBLAS, 1000.0,
             1040.0],
            ["at::native::CatArrayBatchedCopy", kc.ATEN, 1040.0, 1050.0],
            ["at::native::elementwise_kernel", kc.ATEN, 1050.0, 1060.0],
            ["Memcpy DtoD", kc.MEMCPY, 1060.0, 1064.0],
            ["Memset", kc.MEMSET, 1064.0, 1065.0],
            ["fft_cols_kernel", kc.PORT, 1070.0, 1080.0]]


def _rec(trace_=True, launches=None, peak=H100, steps=2):
    tr = ({"window": [1000.0, 1100.0], "ops": _ops(), "spans": []}
          if trace_ else None)
    return {"steps": steps, "chips": 1, "trace": tr, "peak": peak,
            "flops_per_step": 2 * 1.812e10, "bytes_per_step": 8 * 2 ** 30,
            "launches": {"contract_gemm": 12} if launches is None
            else launches}


def test_readers_on_a_traced_record():
    recs = [_rec()]
    assert run.read_metric("gemm_ms", recs) == pytest.approx(0.020)
    assert run.read_metric("relayout_ms", recs) == pytest.approx(0.0125)
    assert run.read_metric("gemms_per_step", recs) == pytest.approx(6.0)
    least_ms = 8 * 2 ** 30 / 3.35e12 * 1e3
    # busy: 1000-1065 and 1070-1080, 75 us over 2 steps
    assert run.read_metric("c128_roofline", recs) == pytest.approx(
        100.0 * least_ms / 0.0375)
    two = [_rec(), _rec(launches={"contract_gemm": 8})]
    assert run.read_metric("gemms_per_step", two) == pytest.approx(5.0)


@pytest.mark.parametrize("name", ["gemm_ms", "relayout_ms", "c128_roofline"])
def test_device_readers_find_nothing_without_a_trace(name):
    assert run.read_metric(name, [_rec(trace_=False)]) is None
    host = _rec()
    host["trace"] = {"window": [0.0, 10.0], "ops": [], "spans": []}
    assert run.read_metric(name, [host]) is None


def test_readers_without_a_counter_or_a_data_sheet():
    # a program with no contraction counter (or none run) reports nothing
    assert run.read_metric("gemms_per_step", [_rec(launches={})]) is None
    assert run.read_metric("gemms_per_step",
                           [_rec(launches={"fft_cols": 4})]) is None
    assert run.read_metric("c128_roofline", [_rec(peak=None)]) is None
    rec = _rec()
    rec["trace"]["ops"] = [o for o in _ops() if o[1] != kc.CUBLAS]
    assert run.read_metric("gemm_ms", [rec]) is None
