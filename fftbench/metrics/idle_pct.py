"""idle_pct: the share of the traced window in which no device operation
runs (the union of their intervals against the window), in percent, the
mean over ranks."""
from fftbench import records


def read(recs):
    if not records.traced(recs):
        return None
    return records.mean(100.0 * (1.0 - records.busy_s(r)
                                 / records.traced_window_s(r))
                        for r in recs)
