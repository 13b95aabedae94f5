"""host_ms: host milliseconds per step inside the benchmark's own calls
into the port (the ``enqueue.fwd`` and ``enqueue.bwd`` spans), all of it
over all steps, the mean over ranks.  Read in the traced run, so it
carries the profiler's own cost per call."""
from fftbench import records


def read(recs):
    return records.mean(1e3 * r["enqueue_s"] / r["steps"] for r in recs)
