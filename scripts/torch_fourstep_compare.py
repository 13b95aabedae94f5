#!/usr/bin/env python3
"""Time the four-step column passes (``fft_cols_tw``, the a0fs stages and
their bf16 instances) and the plans that take them, for the
``regent_fft_tpu_torch`` package of the directory it is run from.

    python3 scripts/torch_fourstep_compare.py [label]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU, in turns (parent, change, change, parent), to compare them.
Prints the card's name and power limit, the ptxas line of every kernel
when this run built the library (``ptxas <kernel>: ...``), then one JSON
line:

- ``kernels_ms``: median of 10 CUDA-event runs, L2 flushed before each, of
  ``fft_cols_tw`` at 64x512x2048 (the 64 x 2^20 four-step's first pass),
  stage a and stage b of the leading-axis four-step at 512^3 axis 0
  (1x512x262144 as pre x n x post) and 4 x 256^3 axis 1 (4x256x65536),
  f32 and bf16 planes (stage b on stage a's output); ``fft_cols`` on the
  same planes, the one-pass route the plans take under ``auto`` (the
  ``auto`` leading-axis decision compares it with stage a + stage b); and
  as the controls, kernels this change does not touch: ``fft_axis0`` at
  512x262144, the axis ring at 1x512x262144, ``fft_fused2`` at 512^3 and
  ``fft_last`` at 32768x2048 (the four-step's second pass), f32 and bf16
  where they take both;
- ``entries_ms``: ``fft_last_four_step`` at 64 x 2^20 and
  ``fft_axis0_fourstep`` at the two a0fs shapes, each timed whole;
- ``torch_fft_ms``: one ``torch.fft.fft`` over the same axis of the same
  data (complex64; complex32 for bf16 planes where cuFFT takes it);
- ``plans_ms``: the complex64 64 x 2^20 C2C plan (default route: the
  four-step last axis), and the complex64 and complex32 512^3 and
  4 x 256^3 (axes 1-3) C2C plans with ``axis0_impl="fourstep"`` and on
  the default route (the grid).
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import regent_fft_tpu_torch as rt                        # noqa: E402
from regent_fft_tpu_torch.ops import _build              # noqa: E402
from regent_fft_tpu_torch.ops import fourstep as fs      # noqa: E402
from regent_fft_tpu_torch.ops import stockham_kernels as sk   # noqa: E402

CUBE = (512, 512, 512)
A0FS = (((1, 512, 262144), CUBE, 0), ((4, 256, 65536), (4, 256, 256, 256), 1))


def _ptxas(log: str):
    """One line per compiled kernel: its name and what ptxas said of its
    registers, stack and spills."""
    props, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
            props[fn] = []
        elif fn and ("spill" in ln or "registers" in ln):
            props[fn].append(ln.replace("ptxas info    :", "").strip())
    return [f"{fn}: {'; '.join(lines)}" for fn, lines in props.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fourstep_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    _build.load()
    for ln in _ptxas(_build.build_log):
        print("ptxas " + ln)
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

    def lib_time(xr, xi, dim):
        z = torch.complex(xr.float(), xi.float())
        if xr.dtype == torch.bfloat16:
            try:
                z = z.to(torch.complex32)
                torch.fft.fft(z, dim=dim)
            except RuntimeError:
                z = torch.complex(xr.float(), xi.float())
        return timed(lambda: torch.fft.fft(z, dim=dim))

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "kernels_ms": {}, "entries_ms": {}, "torch_fft_ms": {},
           "plans_ms": {}}
    ks, en, tf = res["kernels_ms"], res["entries_ms"], res["torch_fft_ms"]
    # the four-step last axis: fft_cols_tw, its entry and the second pass
    shape = (64, 512, 2048)
    xr, xi = planes(shape)
    ks["fft_cols_tw " + key(shape, xr.dtype)] = timed(
        lambda: fs.fft_cols_tw(xr, xi, -1))
    fr, fi = xr.reshape(64, 1 << 20), xi.reshape(64, 1 << 20)
    en["fft_last_four_step 64x1048576 float32"] = timed(
        lambda: fs.fft_last_four_step(fr, fi, rt.FORWARD))
    tf["64x1048576 float32"] = lib_time(fr, fi, 1)
    del xr, xi, fr, fi
    for dt in (torch.float32, torch.bfloat16):
        xr, xi = planes((32768, 2048), dt)
        ks["fft_last " + key((32768, 2048), dt)] = timed(
            lambda: sk.fft_last(xr, xi, -1))
        del xr, xi
        # the leading-axis four-step, and fft_cols on the same planes
        for pshape, ashape, axis in A0FS:
            xr, xi = planes(pshape, dt)
            ar, ai = fs.a0fs_stage("a", xr, xi, -1)
            ks["a0fs_a " + key(pshape, dt)] = timed(
                lambda: fs.a0fs_stage("a", xr, xi, -1))
            ks["a0fs_b " + key(pshape, dt)] = timed(
                lambda: fs.a0fs_stage("b", ar, ai, -1))
            ks["fft_cols " + key(pshape, dt)] = timed(
                lambda: sk.fft_cols(xr, xi, -1))
            del ar, ai
            fr, fi = xr.reshape(ashape), xi.reshape(ashape)
            en["fft_axis0_fourstep " + key(ashape, dt)] = timed(
                lambda: fs.fft_axis0_fourstep(fr, fi, axis, rt.FORWARD))
            tf[key(ashape, dt)] = lib_time(fr, fi, axis)
            del xr, xi, fr, fi
        shape = (1, 512, 262144)
        xr, xi = planes(shape, dt)
        ks["fft_axis_ring " + key(shape, dt)] = timed(
            lambda: fs.fft_axis_ring(xr, xi, -1))
        if dt == torch.float32:
            ks["fft_axis0 512x262144 float32"] = timed(
                lambda: sk.fft_axis0(xr[0], xi[0], -1))
        del xr, xi
        xr, xi = planes(CUBE, dt)
        ks["fft_fused2 " + key(CUBE, dt)] = timed(
            lambda: sk.fft_fused2(xr, xi, -1))
        del xr, xi
        torch.cuda.empty_cache()

    x = torch.complex(*planes((64, 1 << 20)))
    p = rt.make_plan((64, 1 << 20), axes=(1,))
    res["plans_ms"]["complex64 64x2^20"] = timed(lambda: p(x))
    del x
    for dtype in ("complex64", "complex32"):
        for shape, axes in ((CUBE, (0, 1, 2)),
                            ((4, 256, 256, 256), (1, 2, 3))):
            xr, xi = planes(shape)
            x = (rt.SplitComplex(xr.bfloat16(), xi.bfloat16())
                 if dtype == "complex32" else torch.complex(xr, xi))
            del xr, xi
            for route, kw in (("grid", {}),
                              ("fourstep", {"axis0_impl": "fourstep"})):
                p = rt.make_plan(shape, axes=axes, dtype=dtype, **kw)
                name = f"{dtype} {'x'.join(map(str, shape))} {route}"
                res["plans_ms"][name] = timed(lambda: p(x))
            del x
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
