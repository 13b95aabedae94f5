#!/usr/bin/env python3
"""Time the real pair kernels (``fft_last_r2c``, ``ifft_last_c2r``) and the
real plans they carry, for the ``regent_fft_tpu_torch`` package of the
directory it is run from.

    python3 scripts/torch_real_compare.py [label]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU, in turns (parent, change, change, parent), to compare them:

    (cd parent && python3 ../scripts/torch_real_compare.py parent)

Prints the card's name and power limit, then one JSON line:

- ``kernels_ms``: median of 10 CUDA-event runs, L2 flushed before each, of
  ``fft_last_r2c`` at 4096 x 1024 narrow (the 1-D R2C plan's row step),
  262144 x 256 packed (the 4 x 256^3 R2C plan's), 65536 x 1024 packed and
  1048576 x 64 narrow and packed, and ``ifft_last_c2r`` at 262144 x 256
  packed, 65536 x 1024 packed and 1048576 x 64 narrow and packed (scale
  1); and as the controls, kernels this change does not touch:
  ``fft_last`` at 262144 x 512, 4096 x 1024 and 524288 x 64 (the bytes of
  the n = 64 real shapes, on the same row body), and ``fft_cols`` at
  4 x 256 x 32768 (a mid axis of the 4 x 256^3 real plans);
- ``torch_fft_ms``: one ``torch.fft.rfft`` (R2C) or ``torch.fft.irfft``
  (C2R, of the narrow half spectrum) call on the same rows, and one
  ``torch.fft.fft`` for the C2C controls (a yardstick the package never
  calls);
- ``plans_ms``: the 4 x 256^3 (axes 1-3) R2C and C2R plans and the
  4096 x 1024 R2C plan, default device and backend;
- ``ptxas``: the ptxas lines (registers, spills) of ``fft_last_kernel``,
  ``fft_last_r2c_kernel`` and ``ifft_last_c2r_kernel``, when this process
  built the library.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import regent_fft_tpu_torch as rt                        # noqa: E402
from regent_fft_tpu_torch.ops import _build               # noqa: E402
from regent_fft_tpu_torch.ops import stockham_kernels as sk   # noqa: E402

R2C = [((4096, 1024), False), ((262144, 256), True), ((65536, 1024), True),
       ((1048576, 64), False), ((1048576, 64), True)]
C2R = [((262144, 256), True), ((65536, 1024), True), ((1048576, 64), False),
       ((1048576, 64), True)]


def _ptxas(log: str):
    """The registers and spills ptxas reported for the row kernels."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
        elif fn and ("spill" in ln or "registers" in ln) and any(
                k in fn for k in ("fft_last_kernel", "fft_last_r2c_kernel",
                                  "ifft_last_c2r_kernel")):
            out.setdefault(fn, []).append(
                ln.replace("ptxas info    :", "").strip())
    return {fn: "; ".join(v) for fn, v in sorted(out.items())}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_real_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    _build.load()

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

    def randn(shape):
        return torch.randn(shape, device=dev, generator=gen)

    def key(shape, packed=None):
        tag = "" if packed is None else (" packed" if packed else " narrow")
        return "x".join(map(str, shape)) + tag

    res = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "kernels_ms": {}, "torch_fft_ms": {}, "plans_ms": {},
           "ptxas": _ptxas(_build.build_log)}
    ks, tf = res["kernels_ms"], res["torch_fft_ms"]
    for shape, packed in R2C:
        x = randn(shape)
        ks["fft_last_r2c " + key(shape, packed)] = timed(
            lambda: sk.fft_last_r2c(x, packed))
        if "rfft " + key(shape) not in tf:   # one call for both layouts
            tf["rfft " + key(shape)] = timed(lambda: torch.fft.rfft(x))
        del x
    for (b, n), packed in C2R:
        m = n // 2
        h = torch.complex(randn((b, m + 1)), randn((b, m + 1)))
        hr = h.real[:, :m].contiguous() if packed else h.real.contiguous()
        hi = h.imag[:, :m].contiguous() if packed else h.imag.contiguous()
        ks["ifft_last_c2r " + key((b, n), packed)] = timed(
            lambda: sk.ifft_last_c2r(hr, hi, n, packed))
        if "irfft " + key((b, n)) not in tf:
            tf["irfft " + key((b, n))] = timed(
                lambda: torch.fft.irfft(h, n=n))
        del h, hr, hi
    for shape in ((262144, 512), (4096, 1024), (524288, 64)):
        xr, xi = randn(shape), randn(shape)
        ks["fft_last " + key(shape)] = timed(lambda: sk.fft_last(xr, xi, -1))
        z = torch.complex(xr, xi)
        tf["fft " + key(shape)] = timed(lambda: torch.fft.fft(z))
        del xr, xi, z
    xr, xi = randn((4, 256, 32768)), randn((4, 256, 32768))
    ks["fft_cols 4x256x32768"] = timed(lambda: sk.fft_cols(xr, xi, -1))
    z = torch.complex(xr, xi)
    tf["fft 4x256x32768 (axis 1)"] = timed(lambda: torch.fft.fft(z, dim=1))
    del xr, xi, z
    torch.cuda.empty_cache()

    for shape, axes in (((4, 256, 256, 256), (1, 2, 3)), ((4096, 1024), (1,))):
        x = randn(shape)
        p = rt.make_plan(shape, axes=axes, kind=rt.Kind.R2C,
                         direction=rt.FORWARD)
        res["plans_ms"][key(shape) + " r2c"] = timed(lambda: p(x))
        if len(shape) == 4:
            h = torch.fft.rfftn(x, dim=axes)
            p = rt.make_plan(shape, axes=axes, kind=rt.Kind.C2R,
                             direction=rt.BACKWARD)
            res["plans_ms"][key(shape) + " c2r"] = timed(lambda: p(h))
            del h
        del x, p
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
