#!/usr/bin/env python3
"""Time the gap-fused pass (``fft_gap``, ``fft_gap_bf16``) and the 512^3
gap-fused plans, for the ``regent_fft_tpu_torch`` package of the directory
it is run from.

    python3 scripts/torch_gap_compare.py [label]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU to compare them.  Prints the card's name and power limit,
then one JSON line: the gap pass's ms (f32 and bf16 planes, median of 10
CUDA-event runs, L2 flushed before each) at 1 x 512^3 and 4 x 256^3 as
(B, z, Y, x), and the rise of device memory during one call at 1 x 512^3
(max_memory_allocated after reset_peak_memory_stats, over what was
allocated before the call); ``fft_fused2`` ms at 512^3 and 1024 x 256^2
(both types) as the control; and for the complex64 and complex32 512^3 C2C plans built with
``REGENT_FFT_GAP_FUSED=1`` the plan ms, the peak device memory of one call
and its rise.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import regent_fft_tpu_torch as rt                        # noqa: E402
from regent_fft_tpu_torch.ops import stockham_kernels as sk   # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gap_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def timed(fn, reps=10):
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

    def peak(fn):
        """(peak bytes, rise over what was allocated before) of one call."""
        fn()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        del out
        return top, top - before

    def planes(shape, dt):
        return (torch.randn(shape, device=dev, generator=gen).to(dt),
                torch.randn(shape, device=dev, generator=gen).to(dt))

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "fft_gap_ms": {}, "fft_gap_peak_rise_bytes": {},
           "fft_fused2_ms": {}, "gap_plans": {}}
    for dt in (torch.float32, torch.bfloat16):
        for shape in ((1, 512, 512, 512), (4, 256, 256, 256)):
            xr, xi = planes(shape, dt)
            key = f"{'x'.join(map(str, shape))} {str(dt)[6:]}"
            res["fft_gap_ms"][key] = timed(
                lambda: sk.fft_axes_gap(xr, xi, -1))
            if shape[0] == 1:
                res["fft_gap_peak_rise_bytes"][key] = peak(
                    lambda: sk.fft_axes_gap(xr, xi, -1))[1]
            del xr, xi
        for shape in ((512, 512, 512), (1024, 256, 256)):
            xr, xi = planes(shape, dt)
            key = f"{'x'.join(map(str, shape))} {str(dt)[6:]}"
            res["fft_fused2_ms"][key] = timed(
                lambda: sk.fft_fused2(xr, xi, -1))
            del xr, xi
    os.environ["REGENT_FFT_GAP_FUSED"] = "1"
    rt.clear_plan_cache()
    for dtype in ("complex64", "complex32"):
        p = rt.make_plan((512, 512, 512), dtype=dtype)
        steps = [ln.strip() for ln in p.describe().splitlines()
                 if ln.startswith("  (axis")]
        if "gap-fused" not in steps[0]:
            raise RuntimeError(f"{dtype}: not the gap-fused route: {steps}")
        xr, xi = planes((512, 512, 512), torch.float32)
        x = (rt.SplitComplex(xr.bfloat16(), xi.bfloat16())
             if dtype == "complex32" else torch.complex(xr, xi))
        del xr, xi
        top, rise = peak(lambda: p(x))
        res["gap_plans"][dtype] = {"ms": timed(lambda: p(x)),
                                   "peak_bytes": top, "peak_rise_bytes": rise}
        del x
        torch.cuda.empty_cache()
    rt.clear_plan_cache()
    del os.environ["REGENT_FFT_GAP_FUSED"]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
