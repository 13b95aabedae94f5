#!/usr/bin/env python3
"""Time ``fft_fused2`` and read the 512^3 plans' peak device memory, for
the ``regent_fft_tpu_torch`` package of the directory it is run from.

    python3 scripts/torch_fused2_compare.py [label]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU to compare them.  Prints the card's name and power
limit, then one JSON line: the clusters of ``fft_fused2``'s kernel the card
holds at once at 512^2 and 256^2 (``fused2_active_clusters``) and the SMs
they cover; ``fft_fused2`` ms (f32 and bf16 planes, median of 10
CUDA-event runs, L2 flushed before each) at 512^3, 1024 x 256^2 and
16 x 512^2, and at plane counts that leave a ragged last wave of clusters
(9, 100 and 129 planes of 512^2, 37 and 1000 of 256^2); the unfused pair
at 512^3 (``fft_last`` on 262144 x 512, then ``fft_cols`` along axis 1),
the line the fused kernel has to beat; and for the default complex64 and
complex32 512^3 C2C plans the plan ms and the peak device memory of one
call (max_memory_allocated after reset_peak_memory_stats, and its rise
over what was allocated before the call).
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
        print("torch_fused2_compare: no CUDA device", file=sys.stderr)
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

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "active_clusters": {}, "fft_fused2_ms": {}, "unfused_ms": {},
           "plans": {}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for p_, n1, n2 in ((512, 512, 512), (1024, 256, 256)):
        c = sk.fused2_cluster(n1, n2, p_, sms)
        for dt in (torch.float32, torch.bfloat16):
            act = sk.fused2_active_clusters(n1, n2, c, dt)
            res["active_clusters"][f"{n1}x{n2} {str(dt)[6:]}"] = {
                "C": c, "clusters": act, "sms": act * c, "of": sms}
    for shape in ((512, 512, 512), (1024, 256, 256), (16, 512, 512),
                  (9, 512, 512), (100, 512, 512), (129, 512, 512),
                  (37, 256, 256), (1000, 256, 256)):
        for dt in (torch.float32, torch.bfloat16):
            xr = torch.randn(shape, device=dev, generator=gen).to(dt)
            xi = torch.randn(shape, device=dev, generator=gen).to(dt)
            key = f"{'x'.join(map(str, shape))} {str(dt)[6:]}"
            res["fft_fused2_ms"][key] = timed(lambda: sk.fft_fused2(xr, xi, -1))
            del xr, xi
    for dt in (torch.float32, torch.bfloat16):
        xr = torch.randn((512,) * 3, device=dev, generator=gen).to(dt)
        xi = torch.randn((512,) * 3, device=dev, generator=gen).to(dt)

        def unfused():
            yr, yi = sk.fft_last(xr.view(-1, 512), xi.view(-1, 512), -1)
            return sk.fft_cols(yr.view(512, 512, 512),
                               yi.view(512, 512, 512), -1)
        res["unfused_ms"][f"512x512x512 {str(dt)[6:]}"] = timed(unfused)
        del xr, xi
    for dtype in ("complex64", "complex32"):
        p = rt.make_plan((512, 512, 512), dtype=dtype)
        xr = torch.randn((512,) * 3, device=dev, generator=gen)
        xi = torch.randn((512,) * 3, device=dev, generator=gen)
        x = (rt.SplitComplex(xr.bfloat16(), xi.bfloat16())
             if dtype == "complex32" else torch.complex(xr, xi))
        del xr, xi
        p(x)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = p(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del y
        res["plans"][dtype] = {"ms": timed(lambda: p(x)), "peak_bytes": peak,
                               "peak_rise_bytes": peak - before}
        del x
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
