#!/usr/bin/env python3
"""Time the slab ring (``fft_axis_ring``, ``fft_axes2_ring`` and their bf16
instances) and the plans that take it, for the ``regent_fft_tpu_torch``
package of the directory it is run from.

    python3 scripts/torch_ring_compare.py [label]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU, in turns (parent, change, change, parent), to compare them.
Prints the card's name and power limit, then one JSON line:

- ``kernels_ms``: median of 10 CUDA-event runs, L2 flushed before each, of
  the axis ring at 1x512x262144 (P x n x V) and the fuse_last ring at
  512^3 and at 1024x256x256 (the trailing pair of 4 x 256^3), f32 and bf16
  planes; and as the controls, kernels this change does not touch:
  ``fft_fused2`` at 512^3 (f32 and bf16), the gap pass ``fft_gap`` at
  512^3 (as 1x512x512x512) and ``fft_cols`` at 1x512x262144 (f32 and
  bf16);
- ``torch_fft_ms``: one ``torch.fft`` call over the same axes of the same
  data (complex64; complex32 for bf16 planes where cuFFT takes it);
- ``plans_ms`` and ``plans_peak_rise_bytes``: the complex64 and complex32
  512^3 C2C plans on the default route (the grid), with
  ``f2_impl="ring"`` and with ``axis0_impl="dma"``: one call's time and
  its peak device memory over what was allocated before it.
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

CUBE = (512, 512, 512)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ring_compare: no CUDA device", file=sys.stderr)
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

    def planes(shape, dt=torch.float32):
        return (torch.randn(shape, device=dev, generator=gen).to(dt),
                torch.randn(shape, device=dev, generator=gen).to(dt))

    def key(shape, dt):
        return f"{'x'.join(map(str, shape))} {str(dt)[6:]}"

    def lib_time(xr, xi, dims):
        z = torch.complex(xr.float(), xi.float())
        if xr.dtype == torch.bfloat16:
            try:
                z = z.to(torch.complex32)
                torch.fft.fftn(z, dim=dims)
            except RuntimeError:
                z = torch.complex(xr.float(), xi.float())
        return timed(lambda: torch.fft.fftn(z, dim=dims))

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "kernels_ms": {}, "torch_fft_ms": {}, "plans_ms": {},
           "plans_peak_rise_bytes": {}}
    ks, tf = res["kernels_ms"], res["torch_fft_ms"]
    for dt in (torch.float32, torch.bfloat16):
        shape = (1, 512, 262144)
        xr, xi = planes(shape, dt)
        ks["fft_axis_ring " + key(shape, dt)] = timed(
            lambda: fs.fft_axis_ring(xr, xi, -1))
        ks["fft_cols " + key(shape, dt)] = timed(
            lambda: sk.fft_cols(xr, xi, -1))
        tf[key(shape, dt)] = lib_time(xr, xi, (1,))
        del xr, xi
        for shape in (CUBE, (1024, 256, 256)):
            xr, xi = planes(shape, dt)
            ks["fft_axes2_ring " + key(shape, dt)] = timed(
                lambda: fs.fft_axis_ring(xr, xi, -1, 1.0, True))
            if shape == CUBE:
                ks["fft_fused2 " + key(shape, dt)] = timed(
                    lambda: sk.fft_fused2(xr, xi, -1))
            tf[key(shape, dt)] = lib_time(xr, xi, (1, 2))
            del xr, xi
        torch.cuda.empty_cache()
    xr, xi = planes((1,) + CUBE)
    ks["fft_gap 1x512x512x512 float32"] = timed(
        lambda: sk.fft_axes_gap(xr, xi, -1))
    del xr, xi
    torch.cuda.empty_cache()

    for dtype in ("complex64", "complex32"):
        xr, xi = planes(CUBE)
        x = (rt.SplitComplex(xr.bfloat16(), xi.bfloat16())
             if dtype == "complex32" else torch.complex(xr, xi))
        del xr, xi
        for route, kw in (("grid", {}), ("ring", {"f2_impl": "ring"}),
                          ("dma", {"axis0_impl": "dma"})):
            p = rt.make_plan(CUBE, dtype=dtype, **kw)
            name = f"{dtype} 512^3 {route}"
            res["plans_ms"][name] = timed(lambda: p(x))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = p(x)
            torch.cuda.synchronize()
            res["plans_peak_rise_bytes"][name] = (
                torch.cuda.max_memory_allocated() - before)
            del y
        del x
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
