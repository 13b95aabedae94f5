"""gemms_per_step: the port's count of contraction products
(``stockham_kernels.LAUNCHES["contract_gemm"]``) over the window, per
step, the mean over ranks; nothing where the program counts none (or
has no such counter)."""
from fftbench import records


def read(recs):
    per = [r["launches"].get("contract_gemm", 0) / r["steps"] for r in recs]
    return records.mean(per) if any(per) else None
