#!/usr/bin/env python3
"""Drive the PyTorch port (``regent_fft_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off for every float32 product;
2. build: the CUDA kernels from ``regent_fft_tpu_torch/csrc`` with nvcc;
3. kernels: every length the kernel gates admit (ragged batches and
   column counts, both signs) against torch.fft in float64; then each
   kernel at the main path's shapes, forward and backward
   with a scale, held against its plain PyTorch version on the card
   (rel_l2 <= tolerance(n)) and timed (median of CUDA-event runs with the
   L2 flushed before each) beside its bound, its plain version and one
   torch.fft call over the same axes (a yardstick the port never calls);
4. main path: the complex64 C2C plans a user makes -- 3-D 512^3, 1-D
   4096 x 1024 and 2-D 16 x 512^2 -- with the default device and backend.
   The kernel launch counts are zeroed just before the three plans run
   once and read just after: each kernel step must have launched its
   kernel exactly once.  Results are held against torch.fft (and a small
   input against numpy in float64), the inverse plan must round-trip,
   then each plan is timed.

Prints one ``{"kernels": [...]}`` line, one ``{"plans": [...]}`` line,
the nvidia-smi line, and last the device line.  Exits non-zero, with no
result, when no CUDA device is present.
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

KERNELS = {
    "fft_last": ("regent_fft_tpu/ops/pallas_stockham.py:1267 (_runner_last)",
                 [(4096, 1024), (4096, 640)], (-1,)),
    "fft_cols": ("regent_fft_tpu/ops/pallas_stockham.py:787 (_runner_cols)",
                 [(1, 512, 262144)], (1,)),
    "fft_fused2": ("regent_fft_tpu/ops/pallas_stockham.py:875 (_runner_fused2)",
                   [(512, 512, 512)], (1, 2)),
}
SOURCE = "regent_fft_tpu_torch/csrc/stockham.cu"
MAIN_PLANS = [((512, 512, 512), (0, 1, 2)), ((4096, 1024), (1,)),
              ((16, 512, 512), (1, 2))]


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

    def planes(shape):
        return (torch.randn(shape, device=dev, generator=gen),
                torch.randn(shape, device=dev, generator=gen))

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

    def bound(elems, ffts_n, batch):
        t_bytes = 16 * elems / bw
        t_ops = batch * 5 * ffts_n * math.log2(ffts_n) / fp32
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

    # 3b. kernels at the main path's shapes against their plain versions
    wrappers = {"fft_last": (sk.fft_last, sk.fft_last_plain),
                "fft_cols": (sk.fft_cols, sk.fft_cols_plain),
                "fft_fused2": (sk.fft_fused2, sk.fft_fused2_plain)}
    rows = {}
    for kname, (replaces, shapes, dims) in KERNELS.items():
        kern, plain = wrappers[kname]
        cases = []
        for shape in shapes:
            n = int(np.prod([shape[d] for d in dims]))
            xr, xi = planes(shape)
            max_abs = max_rel = 0.0
            for sign in (-1, 1):
                scale = 1.0 / math.sqrt(n)
                kr, ki = kern(xr, xi, sign, scale)
                pr, pi = plain(xr, xi, sign, scale)
                torch.cuda.synchronize()
                rel = rel_l2(torch.complex(kr, ki), torch.complex(pr, pi))
                if not rel <= tolerance(n):
                    raise AssertionError(f"{kname}{shape} sign {sign}: kernel vs "
                                         f"plain rel_l2 {rel} > {tolerance(n)}")
                max_rel = max(max_rel, rel)
                max_abs = max(max_abs, float(torch.max(torch.abs(
                    torch.complex(kr - pr, ki - pi)))))
                del kr, ki, pr, pi
            ms = timed(lambda: kern(xr, xi, -1, 1.0))
            plain_ms = timed(lambda: plain(xr, xi, -1, 1.0))
            xc = torch.complex(xr, xi)
            lib_ms = timed(lambda: torch.fft.fftn(xc, dim=dims))
            del xc
            b_ms, b_by = bound(xr.numel(), n, xr.numel() // n)
            cases.append({"shape": list(shape), "n": n, "max_abs_err": max_abs,
                          "max_rel_err": max_rel, "tolerance": tolerance(n),
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib_ms})
            del xr, xi
            torch.cuda.empty_cache()
        first = cases[0]
        rows[kname] = {"name": kname, "route": "cuda", "source": SOURCE,
                       "replaces": replaces, "launches": None,
                       "max_abs_err": max(c["max_abs_err"] for c in cases),
                       "max_rel_err": max(c["max_rel_err"] for c in cases),
                       "ms": first["ms"], "time_ms": first["ms"],
                       "plain_ms": first["plain_ms"],
                       "bound_ms": first["bound_ms"],
                       "bound_by": first["bound_by"],
                       "library_ms": first["library_ms"], "cases": cases}

    # 4. the main path: three plans with default device and backend
    plans = [rt.make_plan(shape, axes=axes) for shape, axes in MAIN_PLANS]
    for p in plans:
        print(p.describe())
    steps3 = [ln.strip() for ln in plans[0].describe().splitlines()[1:-1]]
    if steps3 != ["(axis 1: kernel-fused2(512, 512))",
                  "(axis 0: kernel-butterfly(n=512))"]:
        raise AssertionError(f"512^3 plan steps: {steps3}")
    expected = {"fft_last": 0, "fft_cols": 0, "fft_fused2": 0}
    for p in plans:
        for kind_, a, _ in p.steps:
            if kind_ == "stockham2":
                expected["fft_fused2"] += 1
            elif kind_ == "stockham":
                is_last = a == len(p.spec.shape) - 1
                expected["fft_last" if is_last else "fft_cols"] += 1
    inputs = []
    for (shape, _), seed in zip(MAIN_PLANS, (1, 2, 3)):
        g = torch.Generator(device=dev).manual_seed(seed)
        inputs.append(torch.complex(torch.randn(shape, device=dev, generator=g),
                                    torch.randn(shape, device=dev, generator=g)))
    sk.reset_launches()
    outs = [p(x) for p, x in zip(plans, inputs)]
    torch.cuda.synchronize()
    launches = dict(sk.LAUNCHES)
    print(f"main-path launches {launches} expected {expected}")
    if launches != expected or min(launches.values()) < 1:
        raise AssertionError(f"launch counts {launches} != {expected}")
    for kname in rows:
        rows[kname]["launches"] = launches[kname]

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
            "shape": list(s.shape), "axes": list(s.axes),
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

    print(json.dumps({"plans": plan_rows}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
