"""gflops: all the window's work over all its time.

5 N log2 N flops per complex transform and 2.5 N log2 N per real one,
for every transform completed in the window (``yardstick``), over the
window's wall time, which ends in ``torch.cuda.synchronize()``; across
ranks the work is the global transforms' and the time the slowest
rank's window."""


def read(recs):
    steps = recs[0]["steps"]
    work = steps * recs[0]["flops_per_step"]
    return work / max(r["window_s"] for r in recs) / 1e9
