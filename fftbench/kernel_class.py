"""Which layer a device operation belongs to: the one class rule.

A device kernel is the port's own unless it is ATen's, a cuBLAS or
cuBLASLt product, NCCL's, a memcpy or a memset.  So a kernel that a later
change adds to the port counts as the port's without an edit here.
"""
from __future__ import annotations

import re

PORT, ATEN, CUBLAS, NCCL, MEMCPY, MEMSET = (
    "port", "aten", "cublas", "nccl", "memcpy", "memset")

_ATEN = re.compile(r"at::|at_cuda_detail|\bc10::|cub::")
_CUBLAS = re.compile(r"gemm|gemv|cublas|cutlass|xmma|^(void )?sm\d+_|"
                     r"ampere_|splitKreduce|dot_kernel|scal_kernel|"
                     r"axpy_kernel|nrm2_kernel", re.IGNORECASE)


def classify(name: str, cat: str = "kernel") -> str:
    """The class of a device operation from its trace name and category
    (Chrome-trace ``cat``: "kernel", "gpu_memcpy", "gpu_memset")."""
    if cat == "gpu_memcpy" or name.startswith("Memcpy"):
        return MEMCPY
    if cat == "gpu_memset" or name.startswith("Memset"):
        return MEMSET
    if "nccl" in name.lower():
        return NCCL
    if _ATEN.search(name):
        return ATEN
    if _CUBLAS.search(name):
        return CUBLAS
    return PORT


def short_name(name: str) -> str:
    """A stable short name for the ledger: the symbol without its return
    type, namespace-free template arguments or parameter list."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    depth, out = 0, []
    for ch in s:
        if ch in "<(":
            if depth == 0 and ch == "(" and out:
                break
            depth += 1
            continue
        if ch in ">)":
            depth = max(0, depth - 1)
            continue
        if depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s or name[:64]
