#!/usr/bin/env python3
"""Time ``fft_last`` (f32 and bf16 planes), the four-step last axis and the
4096 x 1024 C2C plans, for the ``regent_fft_tpu_torch`` package of the
directory it is run from.

    python3 scripts/torch_last_compare.py [label] [--radix8]

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

``--radix8`` (a checkout whose ``csrc/stockham.cu`` has the row kernel's
``LAST_CASE`` table) also builds a variant of that kernel with 8 values a
thread instead of 16: the same source with radix <= 8 stage lists
(:func:`radix8_stages`) and blocks of up to 256 threads at 128 registers,
compiled into ``build/last_radix8/`` beside the package's own library,
and times it at the same six shapes beside the package's kernel, in turns
(package, variant, variant, package), with the variant's rel_l2 against
the package's output.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import regent_fft_tpu_torch as rt                        # noqa: E402
from regent_fft_tpu_torch.ops import fourstep as fs      # noqa: E402
from regent_fft_tpu_torch.ops import stockham_kernels as sk   # noqa: E402

LAST_SHAPES = [((32768, 2048), torch.float32), ((4096, 1024), torch.float32),
               ((4096, 640), torch.float32), ((4096, 512), torch.float32),
               ((4096, 1024), torch.bfloat16), ((8192, 512), torch.bfloat16)]


def radix8_stages(n: int):
    """The variant's stage list: radix 8 while three factors of two
    remain, then the rest of the power of two, then the odd factor."""
    odd, k = n, 0
    while odd % 2 == 0:
        odd //= 2
        k += 1
    rad = [8] * (k // 3) + ([1 << (k % 3)] if k % 3 else [])
    return tuple(rad + ([odd] if odd > 1 else []))


def build_radix8():
    """Compile the 8-values-a-thread variant of fft_last's row kernel;
    returns its ctypes library."""
    from regent_fft_tpu_torch.ops import _build
    src = (_build.SRC_DIR / "stockham.cu").read_text()
    out = re.sub(r"LAST_CASE\((\d+), [0-9, ]+\)",
                 lambda m: "LAST_CASE({}, {})".format(m.group(1), ", ".join(
                     map(str, radix8_stages(int(m.group(1)))))), src)
    out = out.replace("constexpr int LAST_BLOCK = 128;",
                      "constexpr int LAST_BLOCK = 256;")
    out = out.replace("constexpr int LAST_MIN_BLOCKS = 4;",
                      "constexpr int LAST_MIN_BLOCKS = 2;")
    if out == src or "LAST_BLOCK = 256" not in out:
        raise RuntimeError("--radix8: no LAST_CASE table in stockham.cu")
    d = Path("build") / "last_radix8"
    d.mkdir(parents=True, exist_ok=True)
    (d / "stockham.cu").write_text(out)
    (d / "stockham_tile.cuh").write_text(
        (_build.SRC_DIR / "stockham_tile.cuh").read_text())
    so = d / "libradix8.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(d / "stockham.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so.resolve()))
    for name in ("fft_last", "fft_last_bf16"):
        getattr(lib, name).argtypes = _build._SIGNATURES["fft_last"]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def radix8_call(lib, xr, xi, sign=-1):
    """A no-argument launcher of the variant on these planes."""
    n = xr.shape[1]
    rad = radix8_stages(n)
    tw = torch.from_numpy(sk._stage_tables(rad, sign)).to(xr.device)
    crad = (ctypes.c_int * len(rad))(*rad)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    fn = lib.fft_last if xr.dtype == torch.float32 else lib.fft_last_bf16

    def go():
        err = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                 xr.shape[0], n, sign, 1.0, tw.data_ptr(), len(rad), crad,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"radix-8 variant: CUDA error {err}")
        return yr, yi
    return go


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

    args = [a for a in sys.argv[1:] if a != "--radix8"]
    lib8 = build_radix8() if "--radix8" in sys.argv[1:] else None
    res = {"label": args[0] if args else os.getcwd(),
           "fft_last_ms": {}, "torch_fft_ms": {}}
    if lib8 is not None:
        res["radix8"] = {}
    for shape, dt in LAST_SHAPES:
        xr, xi = planes(shape)
        xc = torch.complex(xr, xi)
        xr, xi = xr.to(dt), xi.to(dt)
        key = f"{'x'.join(map(str, shape))} {str(dt)[6:]}"
        res["fft_last_ms"][key] = timed(lambda: sk.fft_last(xr, xi, -1))
        res["torch_fft_ms"][key] = timed(lambda: torch.fft.fft(xc))
        if lib8 is not None:
            go8 = radix8_call(lib8, xr, xi)
            y8, y16 = (torch.complex(*(t.double() for t in pair))
                       for pair in (go8(), sk.fft_last(xr, xi, -1)))
            res["radix8"][key] = {
                "ms": [timed(go8), timed(go8)],
                "package_ms": [timed(lambda: sk.fft_last(xr, xi, -1))],
                "rel_l2_vs_package": float(torch.linalg.vector_norm(y8 - y16)
                                           / torch.linalg.vector_norm(y16))}
            res["radix8"][key]["package_ms"].insert(
                0, res["fft_last_ms"][key])
            del go8, y8, y16
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
