"""The card's idle share in the Phoenix cell: 1 − the union of device
operations' intervals over the traced slice's length."""

UNIT = "%"
LAYER = "device"
MOVES = "sann_queries_per_s"


def read(trace, facts):
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
