"""launches_per_step: the program's launch counter
(``stockham_kernels.LAUNCHES``, every kernel it launches) summed over the
window, per step, the mean over ranks; nothing where it counted none
(the plain versions on a host)."""
from fftbench import records


def read(recs):
    total = [sum(r["launches"].values()) / r["steps"] for r in recs]
    return records.mean(total) if any(total) else None
