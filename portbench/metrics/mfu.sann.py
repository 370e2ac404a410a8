"""The whole SANN batch's share of the card's peak: the least bytes a batch
must move (the queries in, each distinct index row once, the top-X ids and
scores out) over the traced slice's length, over 3.35 TB/s. Retrieval does
next to no arithmetic, so bandwidth is the peak that bounds it; this bounds
every kernel roofline of the cell from above in what it can claim end to
end."""

from portbench import yardstick

UNIT = "%"
LAYER = "retrieval"
MOVES = "sann_queries_per_s"


def read(trace, facts):
    if not facts.get("needed_bytes") or trace.window_s <= 0:
        return None
    return yardstick.share_of_peak(facts["needed_bytes"], trace.window_s, yardstick.PEAK_HBM_BYTES_PER_S)
