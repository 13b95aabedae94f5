"""setup_s: process start to window start (the last rank's, across
ranks): imports, the kernel build where one runs, plans, fields and the
warm-up of the cell's own shapes."""


def read(recs):
    return max(r["setup_s"] for r in recs)
