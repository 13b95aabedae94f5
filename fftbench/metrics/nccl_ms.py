"""nccl_ms: device ms per step of NCCL's kernels (the exchange's
collectives), from the traced window, the mean over ranks; nothing
where no NCCL kernel ran."""
from fftbench import kernel_class, records


def read(recs):
    if not records.traced(recs):
        return None
    v = records.mean(records.class_ms_per_step(r, (kernel_class.NCCL,))
                     for r in recs)
    return v if v > 0 else None
