"""The grouped expert GEMM's share of its roofline in the Phoenix cell: the
least time its work takes (``phoenix_flops.roofline_seconds`` of the FLOPs
and bytes reckoned from the program's per-expert slot counts) over the
device time of its kernels (``expert_gemm_*`` by name) in the traced slice.
When the profiler left launches out, the work is scaled to the launches it
saw."""

from portbench import phoenix_flops

UNIT = "%"
LAYER = "kernels"
MOVES = "sann_queries_per_s"


def read(trace, facts):
    ops = trace.ops_named("expert_gemm")
    if not ops or not facts.get("expert_gemm_launches"):
        return None
    seconds = sum(e - s for _, s, e in ops)
    share = len(ops) / facts["expert_gemm_launches"]
    bound = phoenix_flops.roofline_seconds(facts["expert_gemm_flops"] * share, facts["expert_gemm_bytes"] * share)
    return 100.0 * bound / seconds
