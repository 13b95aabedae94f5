"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over set-up and
window, on the fullest card, in GiB."""


def read(recs):
    peak = max(r["peak_bytes"] for r in recs)
    return peak / 2 ** 30 if peak > 0 else None
