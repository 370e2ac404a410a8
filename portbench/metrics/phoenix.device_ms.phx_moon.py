"""Device time a Phoenix batch: the union of every device operation's
interval in the traced slice (kernels, copies, fills), over its batches."""

UNIT = "ms"
LAYER = "ranking"
MOVES = "sann_queries_per_s"


def read(trace, facts):
    if not facts.get("batches") or not trace.ops:
        return None
    return 1e3 * trace.busy_s() / facts["batches"]
