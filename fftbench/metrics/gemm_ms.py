"""gemm_ms: device ms per step of cuBLAS-class operations (the dense DFT
products of the port's contraction steps; the class rule of
``kernel_class``), from the traced window, the mean over ranks; nothing
where none ran."""
from fftbench import kernel_class, records


def read(recs):
    if not records.traced(recs):
        return None
    v = records.mean(records.class_ms_per_step(r, (kernel_class.CUBLAS,))
                     for r in recs)
    return v if v > 0 else None
