#!/usr/bin/env python3
"""Drive the PyTorch port (``regent_fft_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off for every float32 product;
2. build: the CUDA kernels from ``regent_fft_tpu_torch/csrc`` with nvcc,
   one process per source, started together;
3. kernels: every length the C2C kernel gates admit (ragged batches and
   column counts, both signs) against torch.fft in float64, and every
   length the real-kernel gate admits (2..1024, an odd and an even batch,
   narrow and Nyquist-packed layouts) against torch.fft.rfft / irfft * n
   in float64; then each kernel at the main path's shapes, held against
   its plain PyTorch version on the card (rel_l2 <= tolerance(n)) and
   timed (median of CUDA-event runs with the L2 flushed before each)
   beside its bound, its plain version and one torch.fft call over the
   same rows or axes (a yardstick the port never calls);
4. main path, C2C: the complex64 plans a user makes -- 3-D 512^3, 1-D
   4096 x 1024 and 2-D 16 x 512^2 -- with the default device and backend.
   The kernel launch counts are zeroed just before the three plans run
   once and read just after: each kernel step must have launched its
   kernel exactly once.  Results are held against torch.fft (and a small
   input against numpy in float64), the inverse plan must round-trip,
   then each plan is timed;
5. main path, real: the R2C and C2R plans of 4096 x 1024 (axis 1) and
   4 x 256^3 (axes 1-3), with the default device and backend.  Their step
   lines must be the expected ones; the counts are zeroed just before the
   four plans run once and must equal what their steps and real routes
   launch (fft_last_r2c 2, ifft_last_c2r 1, fft_cols 4, fft_last 1).
   Results are held against torch.fft.rfftn / irfftn within
   tolerance(logical_n), must come back through ``plan.inverse()``, and a
   small input is held against numpy in float64; then each plan is timed
   beside its bytes bound and the torch.fft call, and one more call of
   each is traced with torch.profiler for its device time by kernel.

Prints one ``{"plans": [...]}`` line (seven plans), one
``{"kernels": [...]}`` line (five kernels; ``launches`` sums both main-path
runs, ``launches_by_path`` splits them), the nvidia-smi line, and last the
device line.  Exits non-zero, with no result, when no CUDA device is
present.
"""
import json
import math
import subprocess
import sys
import time

# Datasheet peaks (dense, no sparsity): device-memory bytes/s and FP32
# (non-tensor-core) flop/s, matched on the nvidia-smi card name.
PEAKS = [("H100 PCIe", 2.0e12, 51.2e12), ("H100 NVL", 3.9e12, 60.0e12),
         ("H100", 3.35e12, 67.0e12), ("H200", 4.8e12, 67.0e12)]

PS = "regent_fft_tpu/ops/pallas_stockham.py"
STOCKHAM_CU = "regent_fft_tpu_torch/csrc/stockham.cu"
REAL_CU = "regent_fft_tpu_torch/csrc/real.cu"
KERNELS = {   # name: (replaces, source)
    "fft_last": (f"{PS}:1267 (_runner_last)", STOCKHAM_CU),
    "fft_cols": (f"{PS}:787 (_runner_cols)", STOCKHAM_CU),
    "fft_fused2": (f"{PS}:875 (_runner_fused2)", STOCKHAM_CU),
    "fft_last_r2c": (f"{PS}:2395 (_runner_last_r2c)", REAL_CU),
    "ifft_last_c2r": (f"{PS}:2521 (_runner_last_c2r)", REAL_CU),
}
MAIN_PLANS = [((512, 512, 512), (0, 1, 2)), ((4096, 1024), (1,)),
              ((16, 512, 512), (1, 2))]
REAL_PLANS = [((4096, 1024), (1,), "r2c"), ((4096, 1024), (1,), "c2r"),
              ((4, 256, 256, 256), (1, 2, 3), "r2c"),
              ((4, 256, 256, 256), (1, 2, 3), "c2r")]
REAL_STEPS = {   # describe() step lines of REAL_PLANS, in order
    0: ["(real axis 1: n=1024 shared-head row-pair kernel r2c)"],
    1: ["(real axis 1: n=1024 half-length conjugate-even kernel c2r)"],
    2: ["(real axis 3: n=256 shared-head row-pair kernel r2c "
        "[nyquist-packed mids])", "(axis 2: kernel-butterfly(n=256))",
        "(axis 1: kernel-butterfly(n=256))"],
    3: ["(axis 2: kernel-butterfly(n=256))",
        "(axis 1: kernel-butterfly(n=256))",
        "(real axis 3: n=256 fused kernel c2r [nyquist-packed mids])"],
}
REAL_LAUNCHES = {"fft_last": 1, "fft_cols": 4, "fft_fused2": 0,
                 "fft_last_r2c": 2, "ifft_last_c2r": 1}


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import numpy as np
    import regent_fft_tpu_torch as rt
    from regent_fft_tpu_torch.ops import _build
    from regent_fft_tpu_torch.ops import stockham_kernels as sk
    from regent_fft_tpu_torch.plan import _half_shape
    from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

    # 1. environment
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    peak = next((p for p in PEAKS if p[0] in smi or p[0] in name), None)
    if peak is None:
        raise RuntimeError(f"no datasheet peaks for card {smi!r}")
    _, bw, fp32 = peak
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_seconds} s) -> {_build.library_path().name}")
    ptxas = [ln for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print("ptxas: " + " | ".join(ln.strip() for ln in ptxas))

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MiB

    def randn(shape):
        return torch.randn(shape, device=dev, generator=gen)

    def planes(shape):
        return randn(shape), randn(shape)

    def timed(fn, reps=10):
        """Median ms of `reps` runs, each after an L2 flush."""
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out))

    src = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = timed(lambda: dst.copy_(src))
    copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
    print(f"copy_: 1 GiB read + 1 GiB written in {copy_ms:.4f} ms = "
          f"{copy_bw / 1e12:.3f} TB/s (datasheet {bw / 1e12} TB/s)")
    del src, dst

    def bound(nbytes, nflops):
        """Least ms for the work: bytes over the memory rate or flops over
        the FP32 rate, whichever is larger."""
        t_bytes, t_ops = nbytes / bw, nflops / fp32
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                          else "operations")

    # 3a. every length the gates admit, ragged batches and column counts,
    # both signs, against torch.fft in float64
    def check(kname, fn, shape, dims, sign, scale=0.5):
        xr, xi = planes(shape)
        yr, yi = fn(xr, xi, sign, scale)
        x = torch.complex(xr.double(), xi.double())
        ref = (torch.fft.fftn(x, dim=dims) if sign < 0
               else torch.fft.ifftn(x, dim=dims, norm="forward")) * scale
        n = int(np.prod([shape[d] for d in dims]))
        err = rel_l2(torch.complex(yr, yi), ref)
        if not err <= tolerance(n):
            raise AssertionError(f"{kname}{shape} sign {sign}: rel_l2 {err} "
                                 f"> {tolerance(n)}")
        return err

    lengths = [2 ** k for k in range(1, 12)] + [
        n for n in range(16, 2049, 8) if n & (n - 1) and n >= 128
        and sk.kernel_len_ok(n, False)]
    worst = 0.0
    for n in lengths:
        for sign in (-1, 1):
            if sk.kernel_len_ok(n, True):
                worst = max(worst, check("fft_last", sk.fft_last, (37, n),
                                         (1,), sign))
            worst = max(worst, check("fft_cols", sk.fft_cols, (3, n, 45),
                                     (1,), sign))
    pairs = [(16, 128), (128, 256), (16, 2048), (2048, 128), (384, 640),
             (256, 1024), (512, 512), (640, 384)]
    for n1, n2 in pairs:
        if not sk.fused2_supported(n1, n2):
            raise AssertionError(f"sweep pair {(n1, n2)} not supported")
        for sign in (-1, 1):
            worst = max(worst, check("fft_fused2", sk.fft_fused2,
                                     (3, n1, n2), (1, 2), sign))
    print(f"sweep: {len(lengths)} lengths (last/cols), {len(pairs)} fused2 "
          f"pairs, both signs: worst rel_l2 vs torch.fft {worst:.3e}")

    def packed_half(h, n):
        """(B, n/2+1) complex -> the packed (B, n/2) planes."""
        m = n // 2
        pr, pi = h.real[:, :m].contiguous(), h.imag[:, :m].clone()
        pi[:, 0] = h.real[:, m]
        return pr, pi.contiguous()

    real_lengths = [n for n in range(2, sk.MAX_REAL_N + 1)
                    if sk.r2c_last_supported(n)]
    worst = 0.0
    for n in real_lengths:
        m = n // 2
        for b in (37, 38):
            x = randn((b, n))
            ref = torch.fft.rfft(x.double()) * 0.5
            h = torch.complex(randn((b, m + 1)), randn((b, m + 1)))
            hz = h.to(torch.complex128)          # numpy/irfft convention:
            hz.imag[:, 0] = 0.0                  # the endpoint bins' imaginary
            hz.imag[:, m] = 0.0                  # parts are ignored
            ref_c = torch.fft.irfft(hz, n=n) * n * 2.0
            for packed in (False, True):
                yr, yi = sk.fft_last_r2c(x, packed=packed, scale=0.5)
                want = ref
                if packed:
                    want = torch.complex(*packed_half(ref, n))
                err = rel_l2(torch.complex(yr, yi), want)
                hr, hi = (packed_half(h, n) if packed
                          else (h.real.contiguous(), h.imag.contiguous()))
                y = sk.ifft_last_c2r(hr, hi, n, packed=packed, scale=2.0)
                err_c = rel_l2(y, ref_c)
                if not max(err, err_c) <= tolerance(n):
                    raise AssertionError(
                        f"real n={n} b={b} packed={packed}: r2c rel_l2 "
                        f"{err}, c2r {err_c} > {tolerance(n)}")
                worst = max(worst, err, err_c)
    print(f"sweep: {len(real_lengths)} real lengths, batches 37/38, narrow "
          f"and packed: worst rel_l2 vs torch.fft.rfft/irfft {worst:.3e}")

    # 3b. kernels at the main path's shapes against their plain versions
    def kernel_case(shape, n, pairs, kern, plain, lib, nbytes, nflops):
        """`pairs`: (kernel thunk, plain thunk) pairs, each returning one
        tensor, compared within tolerance(n); `kern`, `plain`, `lib`:
        thunks timed."""
        max_abs = max_rel = 0.0
        for k_fn, p_fn in pairs:
            k, p = k_fn(), p_fn()
            torch.cuda.synchronize()
            rel = rel_l2(k, p)
            if not rel <= tolerance(n):
                raise AssertionError(f"{shape}: kernel vs plain rel_l2 {rel} "
                                     f"> {tolerance(n)}")
            max_rel = max(max_rel, rel)
            max_abs = max(max_abs, float(torch.max(torch.abs(k - p))))
            del k, p
        b_ms, b_by = bound(nbytes, nflops)
        return {"shape": list(shape), "n": n, "max_abs_err": max_abs,
                "max_rel_err": max_rel, "tolerance": tolerance(n),
                "ms": timed(kern), "plain_ms": timed(plain), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": timed(lib)}

    def c2c_case(kname, shape, dims):
        kern = getattr(sk, kname)
        plain = getattr(sk, kname + "_plain")
        n = int(np.prod([shape[d] for d in dims]))
        xr, xi = planes(shape)
        scale = 1.0 / math.sqrt(n)
        pairs = [(lambda s=s: torch.complex(*kern(xr, xi, s, scale)),
                  lambda s=s: torch.complex(*plain(xr, xi, s, scale)))
                 for s in (-1, 1)]
        xc = torch.complex(xr, xi)
        case = kernel_case(shape, n, pairs, lambda: kern(xr, xi, -1, 1.0),
                           lambda: plain(xr, xi, -1, 1.0),
                           lambda: torch.fft.fftn(xc, dim=dims),
                           16 * xr.numel(),
                           5 * xr.numel() * math.log2(n))
        del xr, xi, xc
        return case

    def r2c_case(shape, packed):
        b, n = shape
        x = randn(shape)
        scale = 1.0 / math.sqrt(n)
        w = n // 2 if packed else n // 2 + 1
        pairs = [(lambda: torch.complex(*sk.fft_last_r2c(x, packed, scale)),
                  lambda: torch.complex(*sk.fft_last_r2c_plain(x, packed,
                                                               scale)))]
        case = kernel_case(shape, n, pairs,
                           lambda: sk.fft_last_r2c(x, packed),
                           lambda: sk.fft_last_r2c_plain(x, packed),
                           lambda: torch.fft.rfft(x),
                           4 * b * n + 8 * b * w, 2.5 * b * n * math.log2(n))
        case["layout"] = "packed" if packed else "narrow"
        del x
        return case

    def c2r_case(shape, packed):
        b, n = shape
        m = n // 2
        h = torch.complex(randn((b, m + 1)), randn((b, m + 1)))
        hr, hi = (packed_half(h, n) if packed
                  else (h.real.contiguous(), h.imag.contiguous()))
        w = hr.shape[1]
        scale = 1.0 / math.sqrt(n)
        pairs = [(lambda: sk.ifft_last_c2r(hr, hi, n, packed, scale),
                  lambda: sk.ifft_last_c2r_plain(hr, hi, n, packed, scale))]
        case = kernel_case(shape, n, pairs,
                           lambda: sk.ifft_last_c2r(hr, hi, n, packed),
                           lambda: sk.ifft_last_c2r_plain(hr, hi, n, packed),
                           lambda: torch.fft.irfft(h, n=n),
                           8 * b * w + 4 * b * n, 2.5 * b * n * math.log2(n))
        case["layout"] = "packed" if packed else "narrow"
        del h, hr, hi
        return case

    cases = {
        "fft_last": [lambda: c2c_case("fft_last", (4096, 1024), (1,)),
                     lambda: c2c_case("fft_last", (4096, 640), (1,))],
        "fft_cols": [lambda: c2c_case("fft_cols", (1, 512, 262144), (1,))],
        "fft_fused2": [lambda: c2c_case("fft_fused2", (512, 512, 512),
                                        (1, 2))],
        "fft_last_r2c": [lambda: r2c_case((4096, 1024), False),
                         lambda: r2c_case((262144, 256), True)],
        "ifft_last_c2r": [lambda: c2r_case((262144, 256), True)],
    }
    rows = {}
    for kname, makers in cases.items():
        replaces, source = KERNELS[kname]
        done = []
        for make in makers:
            done.append(make())
            torch.cuda.empty_cache()
        first = done[0]
        rows[kname] = {"name": kname, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": 0,
                       "launches_by_path": {},
                       "max_abs_err": max(c["max_abs_err"] for c in done),
                       "max_rel_err": max(c["max_rel_err"] for c in done),
                       "ms": first["ms"], "time_ms": first["ms"],
                       "plain_ms": first["plain_ms"],
                       "bound_ms": first["bound_ms"],
                       "bound_by": first["bound_by"],
                       "library_ms": first["library_ms"], "cases": done}

    def expected_launches(plans):
        exp = {k: 0 for k in sk.LAUNCHES}
        for p in plans:
            for kind_, a, _ in p.steps:
                if kind_ == "stockham2":
                    exp["fft_fused2"] += 1
                elif kind_ == "stockham":
                    is_last = a == len(p.spec.shape) - 1
                    exp["fft_last" if is_last else "fft_cols"] += 1
            if p.real is not None and p.real.route == "half":
                exp["fft_last"] += 1
            elif p.real is not None and p.real.route == "kernel":
                exp["fft_last_r2c" if p.spec.kind == rt.Kind.R2C
                    else "ifft_last_c2r"] += 1
        return exp

    def run_counted(label, plans, inputs):
        """Zero the counts, run each plan once, read the counts."""
        expected = expected_launches(plans)
        sk.reset_launches()
        outs = [p(x) for p, x in zip(plans, inputs)]
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
        print(f"main-path launches ({label}) {launches} expected {expected}")
        if launches != expected:
            raise AssertionError(f"{label} launch counts {launches} != "
                                 f"{expected}")
        return outs, launches

    # 4. the main path, C2C: three plans with default device and backend
    plans = [rt.make_plan(shape, axes=axes) for shape, axes in MAIN_PLANS]
    for p in plans:
        print(p.describe())
    steps3 = [ln.strip() for ln in plans[0].describe().splitlines()[1:-1]]
    if steps3 != ["(axis 1: kernel-fused2(512, 512))",
                  "(axis 0: kernel-butterfly(n=512))"]:
        raise AssertionError(f"512^3 plan steps: {steps3}")
    inputs = []
    for (shape, _), seed in zip(MAIN_PLANS, (1, 2, 3)):
        g = torch.Generator(device=dev).manual_seed(seed)
        inputs.append(torch.complex(torch.randn(shape, device=dev, generator=g),
                                    torch.randn(shape, device=dev, generator=g)))
    outs, launches = run_counted("c2c", plans, inputs)
    c2c_names = ("fft_last", "fft_cols", "fft_fused2")
    if min(launches[k] for k in c2c_names) < 1:
        raise AssertionError(f"a C2C kernel did not launch: {launches}")
    for kname, row in rows.items():
        row["launches_by_path"]["c2c"] = launches[kname]
        row["launches"] += launches[kname]

    plan_rows = []
    for p, x, y in zip(plans, inputs, outs):
        s = p.spec
        if y.dtype != torch.complex64 or tuple(y.shape) != s.shape:
            raise AssertionError(f"{s.shape}: output {y.dtype} {tuple(y.shape)}")
        if not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{s.shape}: non-finite output")
        tol = tolerance(s.logical_n)
        err = rel_l2(y, torch.fft.fftn(x, dim=s.axes))
        back = rel_l2(p.inverse()(y), x)
        if not (err <= tol and back <= tol):
            raise AssertionError(f"{s.shape}: rel_l2 {err}, roundtrip {back}, "
                                 f"tolerance {tol}")
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        ms = timed(lambda: p(x))
        steps_ms = timed(lambda: p.execute_split(xr, xi))
        split_ms = timed(lambda: (x.real.contiguous(), x.imag.contiguous()))
        combine_ms = timed(lambda: torch.complex(xr, xi))
        lib_ms = timed(lambda: torch.fft.fftn(x, dim=s.axes))
        b_ms = 1e3 * p.bytes_ideal / bw
        plan_rows.append({
            "kind": "c2c", "shape": list(s.shape), "axes": list(s.axes),
            "steps": [ln.strip() for ln in p.describe().splitlines()[1:-1]],
            "rel_err_vs_torch_fft": err, "roundtrip_err": back,
            "tolerance": tol, "ms": ms, "steps_ms": steps_ms,
            "split_ms": split_ms, "combine_ms": combine_ms,
            "gflops": p.flops / (ms * 1e-3) / 1e9,
            "hbm_bound_ms": b_ms, "bound_fraction": b_ms / ms,
            "library_ms": lib_ms})
        del xr, xi
    del inputs, outs

    # a small input against the float64 numpy DFT
    rng = np.random.default_rng(0)
    small = (rng.standard_normal((4, 128, 256))
             + 1j * rng.standard_normal((4, 128, 256))).astype(np.complex64)
    ys = rt.fftn(small)
    err_small = rel_l2(ys, np.fft.fftn(small.astype(np.complex128)))
    if ys.device.type != "cuda" or not err_small <= tolerance(small.size):
        raise AssertionError(f"small input: rel_l2 {err_small} on {ys.device}")
    print(f"small (4,128,256) vs numpy float64: rel_l2 {err_small}")

    # 5. the main path, real: R2C and C2R plans, default device and backend
    kinds = {"r2c": (rt.Kind.R2C, rt.FORWARD), "c2r": (rt.Kind.C2R, rt.BACKWARD)}
    plans = [rt.make_plan(shape, axes=axes, kind=kinds[k][0],
                          direction=kinds[k][1])
             for shape, axes, k in REAL_PLANS]
    for i, p in enumerate(plans):
        print(p.describe())
        got = [ln.strip() for ln in p.describe().splitlines()[1:-1]]
        if got != REAL_STEPS[i]:
            raise AssertionError(f"{REAL_PLANS[i]} steps: {got}")
    inputs = []
    for (shape, axes, k), seed in zip(REAL_PLANS, (4, 5, 6, 7)):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(shape, device=dev, generator=g)
        # a C2R plan gets a Hermitian half spectrum: the rfftn of a real x
        inputs.append(x if k == "r2c" else torch.fft.rfftn(x, dim=axes))
    outs, launches = run_counted("real", plans, inputs)
    if launches != REAL_LAUNCHES:
        raise AssertionError(f"real launch counts {launches} != "
                             f"{REAL_LAUNCHES}")
    for kname, row in rows.items():
        row["launches_by_path"]["real"] = launches[kname]
        row["launches"] += launches[kname]

    for p, x, y in zip(plans, inputs, outs):
        s = p.spec
        r2c = s.kind == rt.Kind.R2C
        want_shape = _half_shape(s) if r2c else s.shape
        want_dtype = torch.complex64 if r2c else torch.float32
        if y.dtype != want_dtype or tuple(y.shape) != want_shape:
            raise AssertionError(f"{s.kind} {s.shape}: output {y.dtype} "
                                 f"{tuple(y.shape)}")
        yv = torch.view_as_real(y) if r2c else y
        if not bool(torch.isfinite(yv).all()):
            raise AssertionError(f"{s.kind} {s.shape}: non-finite output")
        tol = tolerance(s.logical_n)
        if r2c:
            ref = torch.fft.rfftn(x, dim=s.axes)
            lib = lambda: torch.fft.rfftn(x, dim=s.axes)
            steps = lambda: p.execute_real(x)
        else:
            ref = torch.fft.irfftn(x, s=[s.shape[a] for a in s.axes],
                                   dim=s.axes)
            lib = lambda: torch.fft.irfftn(x, s=[s.shape[a] for a in s.axes],
                                           dim=s.axes)
            hr, hi = x.real.contiguous(), x.imag.contiguous()
            steps = lambda: p.execute_split(hr, hi)
        err = rel_l2(y, ref)
        back = rel_l2(p.inverse()(y), x)
        del ref
        if not (err <= tol and back <= tol):
            raise AssertionError(f"{s.kind} {s.shape}: rel_l2 {err}, "
                                 f"roundtrip {back}, tolerance {tol}")
        ms = timed(lambda: p(x))
        steps_ms = timed(steps)
        lib_ms = timed(lib)
        b_ms = 1e3 * p.bytes_ideal / bw
        plan_rows.append({
            "kind": s.kind.value, "shape": list(s.shape),
            "axes": list(s.axes),
            "steps": [ln.strip() for ln in p.describe().splitlines()[1:-1]],
            "rel_err_vs_torch_fft": err, "roundtrip_err": back,
            "tolerance": tol, "ms": ms, "steps_ms": steps_ms,
            "gflops": p.flops / (ms * 1e-3) / 1e9,
            "hbm_bound_ms": b_ms, "bound_fraction": b_ms / ms,
            "library_ms": lib_ms})
        print(f"{s.kind.value} {s.shape}: {ms:.4f} ms (steps {steps_ms:.4f}, "
              f"bound {b_ms:.4f}, torch.fft {lib_ms:.4f}), rel_l2 {err:.3e}, "
              f"roundtrip {back:.3e}")
    # device time of one call of each real plan, by kernel (torch.profiler,
    # CUDA activity only, so nothing is counted twice)
    from torch.profiler import ProfilerActivity, profile
    for row, p, x in zip(plan_rows[len(MAIN_PLANS):], plans, inputs):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            p(x)
            torch.cuda.synchronize()
        by = sorted(((e.key, e.self_device_time_total / 1e3)
                     for e in prof.key_averages()
                     if e.self_device_time_total > 0), key=lambda t: -t[1])
        row["device_ms_by_kernel"] = {k[:80]: ms for k, ms in by}
        print(f"profile {row['kind']} {tuple(row['shape'])}: device "
              f"{sum(ms for _, ms in by):.4f} ms in {len(by)} kernels: "
              + ", ".join(f"{k[:60]} {ms:.4f}" for k, ms in by[:8]))
    del inputs, outs

    # a small real input against the float64 numpy transforms
    small_r = rng.standard_normal((4, 128, 256)).astype(np.float32)
    ys = rt.rfftn(small_r)
    ref = np.fft.rfftn(small_r.astype(np.float64))
    err_r = rel_l2(ys, ref)
    zs = rt.irfftn(ref.astype(np.complex64), s=small_r.shape)
    err_c = rel_l2(zs, np.fft.irfftn(ref, s=small_r.shape, axes=(0, 1, 2)))
    if (ys.device.type != "cuda" or zs.device.type != "cuda"
            or not max(err_r, err_c) <= tolerance(small_r.size)):
        raise AssertionError(f"small real input: rfftn {err_r}, irfftn "
                             f"{err_c} on {ys.device}")
    print(f"small real (4,128,256) vs numpy float64: rfftn rel_l2 {err_r}, "
          f"irfftn {err_c}")

    print(json.dumps({"plans": plan_rows}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
