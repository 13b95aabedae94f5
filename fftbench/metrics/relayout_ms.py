"""relayout_ms: device ms per step of ATen, memcpy and memset operations
(the contraction steps' pack and unpack copies, and any scale pass), from
the traced window, the mean over ranks."""
from fftbench import kernel_class as kc, records


def read(recs):
    if not records.traced(recs):
        return None
    return records.mean(records.class_ms_per_step(
        r, (kc.ATEN, kc.MEMCPY, kc.MEMSET)) for r in recs)
