"""row_gather's share of its bytes roofline in the SANN cell: the bytes the
batches' cluster-row fetches need (``yardstick.gather_bytes``: the ids, each
distinct row once, each output row once), reckoned from the ids the benchmark
drew, over the kernel's device time in the traced slice, over 3.35 TB/s.
When the profiler left launches out, the bytes are scaled to the launches
it saw."""

from portbench import yardstick

UNIT = "%"
LAYER = "kernels"
MOVES = "sann_queries_per_s"


def read(trace, facts):
    ops = trace.ops_named("row_gather")
    if not ops or not facts.get("row_gather_launches"):
        return None
    seconds = sum(e - s for _, s, e in ops)
    needed = facts["row_gather_bytes"] * len(ops) / facts["row_gather_launches"]
    return yardstick.share_of_peak(needed, seconds, yardstick.PEAK_HBM_BYTES_PER_S)
