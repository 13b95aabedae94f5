#!/usr/bin/env python3
"""Time the mid-axis pass (``fft_cols``, ``fft_cols_bf16``, ``fft_axis0``)
and the plans it carries, for the ``regent_fft_tpu_torch`` package of the
directory it is run from.

    python3 scripts/torch_cols_compare.py [label]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU, in turns (parent, change, change, parent), to compare them.
Prints the card's name and power limit, then one JSON line:

- ``kernels_ms``: median of 10 CUDA-event runs, L2 flushed before each, of
  ``fft_cols`` at 1x512x262144, 512^3, 1024x256x128, 4x256x32768,
  1x2048x65536 and 1x1024x131072 (P x n x V), ``fft_cols_bf16`` at
  1x512x262144, 512^3, 1x2048x65536 and 1x1024x131072, ``fft_axis0`` at
  512x262144; and as the control, kernels this pass does not run:
  ``fft_fused2`` at 512^3 (f32 and bf16), ``fft_last`` at 262144x512,
  ``fft_cols_tw`` on the 64 x 2^20 four-step view (64x512x2048) and the
  leading-axis four-step (``fft_axis0_fourstep``, stages a and b) on
  512^3;
- ``torch_fft_ms``: one ``torch.fft.fft`` call along the same axis of the
  same data (complex64, and complex32 for the bf16 shapes);
- ``plans_ms``: the complex64 and complex32 512^3 C2C plans on the default
  route (the grid: fft_fused2 then fft_cols) and with
  ``axis0_impl="dma"`` (the slab ring), the complex64 512^3 gap-fused plan
  (``REGENT_FFT_GAP_FUSED=1``), and the 4 x 256^3 R2C and C2R plans.
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

COLS_F32 = [(1, 512, 262144), (512, 512, 512), (1024, 256, 128),
            (4, 256, 32768), (1, 2048, 65536), (1, 1024, 131072)]
COLS_BF16 = [(1, 512, 262144), (512, 512, 512), (1, 2048, 65536),
             (1, 1024, 131072)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cols_compare: no CUDA device", file=sys.stderr)
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

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "kernels_ms": {}, "torch_fft_ms": {}, "plans_ms": {}}
    ks, tf = res["kernels_ms"], res["torch_fft_ms"]
    for dt, shapes in ((torch.float32, COLS_F32), (torch.bfloat16, COLS_BF16)):
        for shape in shapes:
            xr, xi = planes(shape, dt)
            ks["fft_cols " + key(shape, dt)] = timed(
                lambda: sk.fft_cols(xr, xi, -1))
            z = torch.complex(xr.float(), xi.float())
            if dt == torch.bfloat16:
                z = z.to(torch.complex32)
            tf[key(shape, dt)] = timed(lambda: torch.fft.fft(z, dim=1))
            del xr, xi, z
    xr, xi = planes((512, 262144))
    ks["fft_axis0 512x262144 float32"] = timed(lambda: sk.fft_axis0(xr, xi,
                                                                  -1))
    z = torch.complex(xr, xi)
    tf["512x262144 float32 (axis 0)"] = timed(lambda: torch.fft.fft(z, dim=0))
    del xr, xi, z
    for dt in (torch.float32, torch.bfloat16):
        xr, xi = planes((512, 512, 512), dt)
        ks["fft_fused2 " + key((512, 512, 512), dt)] = timed(
            lambda: sk.fft_fused2(xr, xi, -1))
        del xr, xi
    xr, xi = planes((262144, 512))
    ks["fft_last 262144x512 float32"] = timed(lambda: sk.fft_last(xr, xi, -1))
    del xr, xi
    xr, xi = planes((64, 512, 2048))   # the 64 x 2^20 four-step view
    ks["fft_cols_tw 64x512x2048 float32"] = timed(
        lambda: fs.fft_cols_tw(xr, xi, -1))
    del xr, xi
    xr, xi = planes((512, 512, 512))
    ks["fft_axis0_fourstep 512^3 axis 0 float32"] = timed(
        lambda: fs.fft_axis0_fourstep(xr, xi, 0, rt.FORWARD))
    del xr, xi
    torch.cuda.empty_cache()

    cube = (512, 512, 512)
    for dtype in ("complex64", "complex32"):
        xr, xi = planes(cube)
        x = (rt.SplitComplex(xr.bfloat16(), xi.bfloat16())
             if dtype == "complex32" else torch.complex(xr, xi))
        del xr, xi
        for route, kw in (("grid", {}), ("dma", {"axis0_impl": "dma"})):
            p = rt.make_plan(cube, dtype=dtype, **kw)
            res["plans_ms"][f"{dtype} 512^3 {route}"] = timed(lambda: p(x))
        del x
        torch.cuda.empty_cache()
    os.environ["REGENT_FFT_GAP_FUSED"] = "1"
    rt.clear_plan_cache()
    p = rt.make_plan(cube)
    xr, xi = planes(cube)
    x = torch.complex(xr, xi)
    del xr, xi
    res["plans_ms"]["complex64 512^3 gap-fused"] = timed(lambda: p(x))
    del x, p
    rt.clear_plan_cache()
    del os.environ["REGENT_FFT_GAP_FUSED"]
    torch.cuda.empty_cache()
    shape, axes = (4, 256, 256, 256), (1, 2, 3)
    x = torch.randn(shape, device=dev, generator=gen)
    p = rt.make_plan(shape, axes=axes, kind=rt.Kind.R2C,
                     direction=rt.FORWARD)
    res["plans_ms"]["4x256^3 r2c"] = timed(lambda: p(x))
    h = torch.fft.rfftn(x, dim=axes)
    p = rt.make_plan(shape, axes=axes, kind=rt.Kind.C2R,
                     direction=rt.BACKWARD)
    res["plans_ms"]["4x256^3 c2r"] = timed(lambda: p(h))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
