"""NPB FT (NAS Parallel Benchmarks 3.4, kernel FT) through the port.

FT's spectral heat-equation solver in double precision: one forward 3-D
complex128 transform of the field, then each iteration multiplies the
spectrum by exp(-4 alpha pi^2 |kbar|^2) once more (the evolve, a multiply
of the re and im planes), runs the backward transform and sums 1024
sampled elements, u[j mod n0, 3j mod n1, 5j mod n2] for j = 1..1024, into
a checksum.  Both transforms are one ``make_plan(..., dtype="complex128")``
pair on float64 planes through ``execute_split``: on the card every axis
one pass of the f64 butterfly kernels (``fft_cols``/``fft_last`` in
double), on the CPU a dense f64 DFT contraction.  The backward plan is
normalised (1/N), which is NPB's unscaled inverse with its checksum divided
by N.

The initial field is seeded standard normal values, not NPB's ``randlc``
sequence, so the checksums are not NPB's published verification values.

    python examples/npb_ft.py [--class C] [--iters 20] [--seed 1]
        [--device cuda] [--check]

``--check`` runs the plain ``torch.fft`` iteration of ``fftbench/npb_ft.py``
on the same device and field and prints, as one JSON line, the largest
relative checksum difference over the iterations and the last field's
``rel_l2`` and ``max_gap`` (largest element difference over the
reference's RMS).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import regent_fft_tpu_torch as rt  # noqa: E402

ALPHA = 1e-6
CLASSES = {"S": ((64, 64, 64), 6), "W": ((128, 128, 32), 6),
           "A": ((256, 256, 128), 6), "B": ((512, 256, 256), 20),
           "C": ((512, 512, 512), 20)}


def evolve_planes(shape, alpha: float, device) -> torch.Tensor:
    """exp(-4 alpha pi^2 |kbar|^2) as one float64 plane, kbar = k for
    k < n/2, else k - n."""
    def k2(n):
        k = torch.arange(n, dtype=torch.float64, device=device)
        return torch.where(k < n / 2, k, k - n) ** 2
    n0, n1, n2 = shape
    s = k2(n0)[:, None, None] + k2(n1)[None, :, None] + k2(n2)[None, None, :]
    return torch.exp(-4.0 * alpha * math.pi ** 2 * s)


def ft(xr: torch.Tensor, xi: torch.Tensor, iters: int,
       alpha: float = ALPHA) -> tuple:
    """FT's iterations on the float64 planes of the initial field: (the
    checksums, the last field's (re, im) planes)."""
    shape = tuple(xr.shape)
    fwd = rt.make_plan(shape, dtype="complex128", planner="estimate",
                       device=str(xr.device))
    bwd = fwd.inverse()
    sr, si = fwd.execute_split(xr, xi)
    factor = evolve_planes(shape, alpha, xr.device)
    j = torch.arange(1, 1025, device=xr.device)
    index = (j % shape[0], (3 * j) % shape[1], (5 * j) % shape[2])
    sums, u = [], None
    for _ in range(iters):
        sr.mul_(factor)
        si.mul_(factor)
        del u
        u = bwd.execute_split(sr, si)
        sums.append(complex(u[0][index].sum().item(),
                            u[1][index].sum().item()))
    return sums, u


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--class", dest="cls", default="S", choices=CLASSES)
    ap.add_argument("--iters", type=int)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device",
                    default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    shape, iters = CLASSES[args.cls]
    iters = args.iters or iters
    dev = torch.device(args.device)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    xr = torch.randn(shape, generator=g, dtype=torch.float64, device=dev)
    xi = torch.randn(shape, generator=g, dtype=torch.float64, device=dev)

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    (sums, u), port_s = timed(lambda: ft(xr, xi, iters))
    line = {"class": args.cls, "shape": list(shape), "iters": iters,
            "seed": args.seed, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu", "port_s": port_s,
            "checksums": [[c.real, c.imag] for c in sums]}
    if args.check:
        from fftbench import npb_ft
        u0 = torch.complex(xr, xi)
        del xr, xi
        (ref_sums, ref), ref_s = timed(lambda: npb_ft.iterate(u0, iters,
                                                              ALPHA))
        del u0
        d = torch.complex(*u) - ref
        rms = math.sqrt(float((ref.abs() ** 2).mean()))
        line.update({
            "reference_s": ref_s,
            "checksum_rel_max": max(abs(a - b) / abs(b)
                                    for a, b in zip(sums, ref_sums)),
            "rel_l2": float(torch.linalg.vector_norm(d)
                            / torch.linalg.vector_norm(ref)),
            "max_gap": float(d.abs().max()) / rms})
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
