#!/usr/bin/env python3
"""Time ``fft_last`` (f32 and bf16 planes), the four-step last axis and the
4096 x 1024 C2C plans, for the ``regent_fft_tpu_torch`` package of the
directory it is run from.

    python3 scripts/torch_last_compare.py [label]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU, in turns (parent, change, change, parent), to compare them:

    (cd parent && python3 ../scripts/torch_last_compare.py parent)

Prints the card's name and power limit, then one JSON line: ``fft_last`` ms
on f32 planes at 32768 x 2048 (stage 2 of the 64 x 2^20 four-step),
4096 x 1024, 4096 x 640 and 4096 x 512 (the half-length core of the
4096 x 1024 C2R plan), and on bf16 planes at 4096 x 1024 and 8192 x 512;
``fft_last_four_step`` on 64 x 2^20; and the default complex64 and
complex32 4096 x 1024 C2C plans (median of 10 CUDA-event runs, the L2
flushed before each), with one ``torch.fft.fft`` call on the same data
beside each (complex64; a yardstick the package never calls).  Uses only
entry points that every checkout of the port has.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import regent_fft_tpu_torch as rt                        # noqa: E402
from regent_fft_tpu_torch.ops import fourstep as fs      # noqa: E402
from regent_fft_tpu_torch.ops import stockham_kernels as sk   # noqa: E402

LAST_SHAPES = [((32768, 2048), torch.float32), ((4096, 1024), torch.float32),
               ((4096, 640), torch.float32), ((4096, 512), torch.float32),
               ((4096, 1024), torch.bfloat16), ((8192, 512), torch.bfloat16)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_last_compare: no CUDA device", file=sys.stderr)
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

    def planes(shape):
        return (torch.randn(shape, device=dev, generator=gen),
                torch.randn(shape, device=dev, generator=gen))

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "fft_last_ms": {}, "torch_fft_ms": {}}
    for shape, dt in LAST_SHAPES:
        xr, xi = planes(shape)
        xc = torch.complex(xr, xi)
        xr, xi = xr.to(dt), xi.to(dt)
        key = f"{'x'.join(map(str, shape))} {str(dt)[6:]}"
        res["fft_last_ms"][key] = timed(lambda: sk.fft_last(xr, xi, -1))
        res["torch_fft_ms"][key] = timed(lambda: torch.fft.fft(xc))
        del xr, xi, xc
    fr, fi = planes((64, 1 << 20))
    res["four_step_64x2^20_ms"] = timed(
        lambda: fs.fft_last_four_step(fr, fi, rt.FORWARD))
    xc = torch.complex(fr, fi)
    res["torch_fft_ms"]["64x1048576"] = timed(lambda: torch.fft.fft(xc))
    del fr, fi, xc
    res["plans_4096x1024_ms"] = {}
    xr, xi = planes((4096, 1024))
    for dtype in ("complex64", "complex32"):
        p = rt.make_plan((4096, 1024), axes=(1,), dtype=dtype)
        x = (rt.SplitComplex(xr.bfloat16(), xi.bfloat16())
             if dtype == "complex32" else torch.complex(xr, xi))
        res["plans_4096x1024_ms"][dtype] = timed(lambda: p(x))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
