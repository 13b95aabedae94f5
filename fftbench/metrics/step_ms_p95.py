"""step_ms_p95: the 95th percentile over all the window's steps of each
step's span on the device stream, between the CUDA events recorded at
the step boundaries (a gap before a step counts in that step).  Across
ranks a step lasts as long as its slowest rank's span."""
from fftbench import yardstick


def read(recs):
    spans = [max(v) for v in zip(*(r["step_ms"] for r in recs))]
    return yardstick.percentile(spans, 95)
