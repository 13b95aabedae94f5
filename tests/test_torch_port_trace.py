"""The port's spans and counters (``regent_fft_tpu_torch/utils/trace.py``).

With tracing on, a CPU plan call under ``torch.profiler`` leaves its
``rft.`` annotations nested as the layers nest (split and combine, each
step and the Nyquist glue inside ``rft.plan``); with tracing off and the
profiler running it leaves none, so the off path never enters
``record_function``.  ``LAUNCH_BYTES`` counts the planes every kernel
wrapper reads and writes, each launch name called directly with the CUDA
launch stubbed (CPU planes launch nothing).  On two gloo ranks the slab
pair's exchanges count (p-1)/p of each send buffer in
``exchange_bytes`` and open their pack, a2a and unpack spans in order,
and level 0 of the log formats no collective.  The attribution of device
time to spans is held on a hand-built Chrome trace.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.ops import _build
from regent_fft_tpu_torch.ops import fourstep as fs
from regent_fft_tpu_torch.ops import pallas_fft as pf
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils import timing, trace
from torch_dist_pool import RankPool

SHAPE = (4, 8, 256)          # the real plans take the Nyquist-packed route


@pytest.fixture
def spans_on():
    trace.set_tracing(True)
    try:
        yield
    finally:
        trace.set_tracing(False)


def _plans():
    rt.clear_plan_cache()
    kw = dict(device="cpu", backend="stockham")
    c2c = rt.make_plan(SHAPE, **kw)
    r2c = rt.make_plan(SHAPE, kind=rt.Kind.R2C, **kw)
    return c2c, r2c, r2c.inverse()


def _calls():
    c2c, r2c, c2r = _plans()
    g = torch.Generator().manual_seed(0)
    x = torch.complex(torch.randn(SHAPE, generator=g),
                      torch.randn(SHAPE, generator=g))
    h = r2c(x.real.contiguous())
    return {"c2c": (c2c, x), "r2c": (r2c, x.real.contiguous()),
            "c2r": (c2r, h)}


def _annotations(prof):
    """(start, end, name) of the profiler's ``rft.`` annotations."""
    out = []
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            out.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(out, key=lambda s: (s[0], -s[1]))


def _tree(spans):
    """Each span's name with the names of the spans that hold it."""
    out, stack = [], []
    for s, t, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, tuple(n for _, _, n in stack)))
        stack.append((s, t, name))
    return out


@pytest.mark.parametrize("call", ["c2c", "r2c", "c2r"])
def test_plan_call_spans_nest_as_the_layers(spans_on, call):
    plan, x = _calls()[call]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan(x)
    tree = _tree(_annotations(prof))
    top = ("rft.plan",)
    assert tree[0] == ("rft.plan", ())
    assert ("rft.layout.split", top) in tree
    assert ("rft.layout.combine", top) in tree
    steps = [(n, up) for n, up in tree if n.startswith("rft.step.")]
    real_axis = {"c2c": [], "r2c": ["rft.step.r2c"], "c2r": ["rft.step.c2r"]}
    want = [f"rft.step.{k}" for k, _, _ in plan.steps]
    want = (real_axis[call] + want if call == "r2c"
            else want + real_axis[call])
    assert [n for n, _ in steps] == want
    assert all(up == top for _, up in steps)
    nyq = [up for n, up in tree if n == "rft.layout.nyquist"]
    assert nyq == ([] if call == "c2c" else [top])
    assert {n for n, _ in tree} <= {"rft.plan", "rft.layout.split",
                                    "rft.layout.combine",
                                    "rft.layout.nyquist", *want}


@pytest.mark.parametrize("call", ["c2c", "r2c", "c2r"])
def test_split_entries_open_one_plan_span(spans_on, call):
    """execute_split/execute_real open ``rft.plan`` themselves; called
    from ``__call__`` they open none of their own."""
    plan, x = _calls()[call]
    if call == "r2c":
        run = (lambda: plan.execute_real(x))
    else:
        sx = rt.as_split(x, "cpu", torch.float32)
        run = (lambda: plan.execute_split(sx.re, sx.im))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = [n for n, _ in _tree(_annotations(prof))]
    assert names.count("rft.plan") == 1 and names[0] == "rft.plan"
    assert "rft.layout.split" not in names


def test_spans_off_leave_no_annotation():
    calls = _calls()
    assert not trace.tracing()
    assert trace.span("rft.plan") is trace.span("rft.scale")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for plan, x in calls.values():
            plan(x)
    assert _annotations(prof) == []
    assert any(e.name.startswith("aten::") for e in prof.events())


def test_scale_and_build_spans(spans_on):
    """An unfused norm scale is a pass of its own (``rft.scale``); a plan
    made on a cache miss is ``rft.build``, a hit opens nothing."""
    rt.clear_plan_cache()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan = rt.make_plan((64,), norm=rt.Norm.ORTHO, device="cpu",
                            backend="xla")
        rt.make_plan((64,), norm=rt.Norm.ORTHO, device="cpu", backend="xla")
        plan(torch.ones(64, dtype=torch.complex64))
    names = [n for n, _ in _tree(_annotations(prof))]
    assert names.count("rft.build") == 1
    assert not plan.fused and names.count("rft.scale") == 2


def test_switch_reads_the_environment(monkeypatch):
    for value, on in (("1", True), ("0", False), ("yes", False)):
        monkeypatch.setenv("REGENT_FFT_TRACE", value)
        trace._init()
        assert trace.tracing() is on
    monkeypatch.delenv("REGENT_FFT_TRACE")
    trace._init()
    assert not trace.tracing()


def test_timing_trace_rows_leave_the_spans_out(spans_on):
    plan, x = _calls()["c2c"]
    total, rows = timing.trace(lambda: plan(x), "cpu")
    assert rows and not any(k.startswith(trace.PREFIX) for k, _ in rows)


# ---------------------------------------------------------------------------
# LAUNCH_BYTES, each launch name with the CUDA launch stubbed
# ---------------------------------------------------------------------------
def _nbytes(*shapes_dtypes):
    return sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
               for s, d in shapes_dtypes)


F32, BF16 = torch.float32, torch.bfloat16


def _c2c(shape, dtype):
    """Two planes in, two of the same shape out."""
    return _nbytes(*[(shape, dtype)] * 4)


# (launch name, wrapper call on planes of ``dtype``, expected bytes)
CASES = [
    ("fft_last", lambda p: sk.fft_last(*p((8, 64)), -1), (8, 64)),
    ("fft_cols", lambda p: sk.fft_cols(*p((2, 64, 8)), -1), (2, 64, 8)),
    ("fft_fused2", lambda p: sk.fft_fused2(*p((2, 16, 128)), -1),
     (2, 16, 128)),
    ("fft_gap", lambda p: sk.fft_axes_gap(*p((2, 16, 3, 128)), -1),
     (2, 16, 3, 128)),
    ("a0fs_a", lambda p: fs.a0fs_stage("a", *p((2, 64, 8)), -1), (2, 64, 8)),
    ("a0fs_b", lambda p: fs.a0fs_stage("b", *p((2, 64, 8)), -1, 0.5),
     (2, 64, 8)),
    ("fft_axis_ring", lambda p: fs.fft_axis_ring(*p((2, 64, 8)), -1),
     (2, 64, 8)),
    ("fft_axes2_ring",
     lambda p: fs.fft_axis_ring(*p((2, 16, 128)), -1, 1.0, True),
     (2, 16, 128)),
]
F32_ONLY = [
    ("fft_axis0", lambda p: sk.fft_axis0(*p((64, 8)), -1), (64, 8)),
    ("fft_cols_tw", lambda p: fs.fft_cols_tw(*p((2, 16, 32)), -1),
     (2, 16, 32)),
    ("fft_mm1", lambda p: pf.fft_mm1(*p((8, 32)), 32, -1), (8, 32)),
    ("fft_mm2", lambda p: pf.fft_mm2(*p((8, 512)), 16, 32, -1), (8, 512)),
]


@pytest.fixture
def stubbed_launch(monkeypatch):
    """The wrappers' CUDA side stubbed: planes count as the card's, every
    C entry returns 0, tables come from the host; ``_launch`` itself runs
    and counts."""
    monkeypatch.setattr(sk, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(sk, "_sm_count", lambda dev: 132)

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0
    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(sk, "device_tables",
                        lambda n, sign, device, stages=None:
                        (torch.zeros((1, 2)), None, 1))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    sk.reset_launches()
    yield
    sk.reset_launches()


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _planes(dtype):
    return lambda shape: (torch.zeros(shape, dtype=dtype),
                          torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("name,call,shape", CASES + F32_ONLY,
                         ids=[c[0] for c in CASES + F32_ONLY])
def test_launch_bytes_f32(stubbed_launch, name, call, shape):
    call(_planes(F32))
    call(_planes(F32))
    assert sk.LAUNCHES[name] == 2
    assert sk.LAUNCH_BYTES[name] == 2 * _c2c(shape, F32)
    assert sum(sk.LAUNCH_BYTES.values()) == sk.LAUNCH_BYTES[name]
    sk.reset_launches()
    assert not any(sk.LAUNCH_BYTES.values()) and not any(
        sk.LAUNCHES.values())


@pytest.mark.parametrize("name,call,shape", CASES, ids=[c[0] for c in CASES])
def test_launch_bytes_bf16(stubbed_launch, name, call, shape):
    call(_planes(BF16))
    assert sk.LAUNCHES[name + "_bf16"] == 1
    assert sk.LAUNCH_BYTES[name + "_bf16"] == _c2c(shape, BF16)
    assert sum(sk.LAUNCH_BYTES.values()) == _c2c(shape, BF16)


@pytest.mark.parametrize("packed", [False, True])
def test_launch_bytes_real_rows(stubbed_launch, packed):
    """One real (B, n) plane and two (B, w) half-spectrum planes, w = n/2
    (packed) or n/2 + 1, each way."""
    b, n = 8, 64
    w = n // 2 if packed else n // 2 + 1
    sk.fft_last_r2c(torch.zeros(b, n), packed)
    sk.ifft_last_c2r(torch.zeros(b, w), torch.zeros(b, w), n, packed)
    want = _nbytes(((b, n), F32), ((b, w), F32), ((b, w), F32))
    assert sk.LAUNCH_BYTES["fft_last_r2c"] == want
    assert sk.LAUNCH_BYTES["ifft_last_c2r"] == want
    assert sum(sk.LAUNCHES.values()) == 2


def test_launch_bytes_keys_follow_launches():
    assert set(sk.LAUNCH_BYTES) == set(sk.LAUNCHES)


def test_cpu_planes_launch_and_count_nothing():
    sk.reset_launches()
    plan, x = _calls()["c2c"]
    plan(x)
    assert not any(sk.LAUNCHES.values())
    assert not any(sk.LAUNCH_BYTES.values())


# ---------------------------------------------------------------------------
# exchange_bytes and the exchange spans on two gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pool2():
    p = RankPool(2)
    try:
        yield p
    finally:
        p.close()


def test_exchange_bytes_and_spans_on_two_ranks(pool2):
    res = pool2.run("exchange_trace", (8, 8, 16))
    for r in res:
        sent = r["sent"]
        assert len(sent) == 2                  # one all-to-all each way
        assert r["counts"] == [sent[0] // 2, (sent[0] + sent[1]) // 2]
        assert sent[0] == 2 * 4 * 8 * 16 * 4   # two f32 planes of the slab
        ex = [n for n in r["spans"] if n.startswith("rft.exchange.")]
        assert ex == ["rft.exchange.pack", "rft.exchange.a2a",
                      "rft.exchange.unpack"] * 2
        assert r["spans"][0] == "rft.plan"
        assert "rft.scale" in r["spans"]       # the backward's 1/N
        assert r["quiet"] == []                # level 0 formats nothing
        assert r["loud"] and all(n.startswith("all_to_all")
                                 for n in r["loud"])
        assert r["perm"] == [3 * 5 * 4, 0]     # a self-copy counts 0
        assert r["round_trip"] < 1e-5


# ---------------------------------------------------------------------------
# device time by span on a hand-built Chrome trace
# ---------------------------------------------------------------------------
def _x(cat, name, ts, dur, pid=1, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "rft.plan", 0, 100),
    _x("user_annotation", "rft.layout.split", 5, 10),
    _x("user_annotation", "rft.step.stockham", 20, 30),
    _x("user_annotation", "rft.plan", 20, 10),        # a nested plan call
    _x("user_annotation", "enqueue.fwd", 0, 200),     # not the port's
    _x("cuda_runtime", "cudaLaunchKernel", 7, 1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=2),
    _x("cuda_driver", "cuLaunchKernelEx", 35, 1, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 60, 1, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=5),   # no span
    _x("user_annotation", "rft.exchange.a2a", 30, 40, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 40, 1, tid=2, corr=6),
    _x("kernel", "fft_cols", 200, 10, pid=0, tid=7, corr=1),
    _x("kernel", "fft_fused2", 210, 20, pid=0, tid=7, corr=2),
    _x("kernel", "fft_last", 230, 30, pid=0, tid=7, corr=3),
    _x("gpu_memcpy", "Memcpy DtoD", 260, 5, pid=0, tid=7, corr=4),
    _x("kernel", "elementwise", 265, 4, pid=0, tid=7, corr=5),
    _x("gpu_memset", "Memset", 270, 3, pid=0, tid=7, corr=99),
    _x("kernel", "ncclSendRecv", 280, 50, pid=0, tid=8, corr=6),
    _x("kernel", "late", 900, 9, pid=0, tid=7, corr=2),
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 7, "id": 1},
]


def test_device_time_goes_under_the_innermost_span():
    got = trace.device_us_by_span(EVENTS, window=[0.0, 500.0])
    assert got == {"rft.layout.split": 10.0, "rft.plan": 20.0 + 5.0,
                   "rft.step.stockham": 30.0, "rft.exchange.a2a": 50.0,
                   trace.UNATTRIBUTED: 4.0 + 3.0}
    whole = trace.device_us_by_span(EVENTS)
    assert whole["rft.plan"] == 25.0 + 9.0
    assert sum(whole.values()) == sum(got.values()) + 9.0


def test_device_time_reads_an_exported_trace(tmp_path, spans_on):
    """On the host the exported trace has the spans and no device
    operation: nothing is attributed, and a CPU profile reads empty."""
    plan, x = _calls()["c2c"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan(x)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "rft.plan" for e in events)
    assert trace.device_us_by_span(events) == {}
