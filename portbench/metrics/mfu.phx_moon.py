"""The Phoenix batch's share of the card's bf16 peak: the model FLOPs of the
traced slice's batches (valid history tokens and valid candidates only,
``phoenix_flops.model_flops``) over the slice's wall time, over 989.4
TFLOP/s."""

from portbench import phoenix_flops

UNIT = "%"
LAYER = "ranking"
MOVES = "sann_queries_per_s"


def read(trace, facts):
    if not facts.get("model_flops") or trace.window_s <= 0:
        return None
    return 100.0 * facts["model_flops"] / trace.window_s / phoenix_flops.PEAK_BF16_FLOPS
