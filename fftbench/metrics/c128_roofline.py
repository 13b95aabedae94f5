"""c128_roofline: the least time of a step's transforms over the step's
device-busy time (every class of operation, the union of their
intervals), in percent, the mean over ranks.

The least time is the larger of the ideal bytes (16 B a complex128
element read and written once) over the card's memory rate and
5 N log2 N over its FP32 peak (``yardstick``, the data sheet), for the
rank's share of the global transforms.  The count is the transform's,
so it stays the same work whatever implements it.  Nothing on a card
without a data-sheet entry or where no device operation ran."""
from fftbench import records, yardstick


def read(recs):
    if not records.traced(recs) or any(r["peak"] is None for r in recs):
        return None
    shares = []
    for r in recs:
        ms = records.busy_s(r) * 1e3 / r["steps"]
        if ms <= 0:
            return None
        least = yardstick.least_time_s(r["flops_per_step"] / r["chips"],
                                       r["bytes_per_step"] / r["chips"],
                                       r["peak"])
        shares.append(100.0 * least * 1e3 / ms)
    return records.mean(shares)
