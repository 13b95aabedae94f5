"""glue_ms: device ms per step of every operation that is neither the
port's own kernel nor NCCL's: ATen's elementwise and ``cat`` kernels,
cuBLAS, copies and memsets (``kernel_class``), from the traced window,
the mean over ranks."""
from fftbench import kernel_class as kc, records


def read(recs):
    if not records.traced(recs):
        return None
    return records.mean(records.class_ms_per_step(
        r, (kc.ATEN, kc.CUBLAS, kc.MEMCPY, kc.MEMSET)) for r in recs)
