"""run_collapse's share of its bytes roofline in the SANN cell: every slot
of the sorted ids and the two value arrays read and written once
(``yardstick.collapse_bytes``), over the kernel's device time in the traced
slice, over 3.35 TB/s. When the profiler left launches out, the bytes are
scaled to the launches it saw."""

from portbench import yardstick

UNIT = "%"
LAYER = "kernels"
MOVES = "sann_queries_per_s"


def read(trace, facts):
    ops = trace.ops_named("run_collapse")
    if not ops or not facts.get("run_collapse_launches"):
        return None
    seconds = sum(e - s for _, s, e in ops)
    needed = facts["run_collapse_bytes"] * len(ops) / facts["run_collapse_launches"]
    return yardstick.share_of_peak(needed, seconds, yardstick.PEAK_HBM_BYTES_PER_S)
