"""The benchmark's arithmetic: published peaks, the bytes a kernel needs,
spreads, and the union of device intervals.

Imports nothing of the port. The byte counts follow the port's own smoke
script (``chip_smoke.time_gather`` and ``time_collapse``); a test holds them
to those figures.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def gather_bytes(n_ids: int, distinct_rows: int, row_bytes: int, id_bytes: int = 4) -> int:
    """The bytes a row gather needs from HBM: the ids read, each distinct row
    read once (a row read again may come from L2) and every output row
    written once."""
    return n_ids * id_bytes + (distinct_rows + n_ids) * row_bytes


def collapse_bytes(Q: int, W: int, k: int, word_bytes: int = 4) -> int:
    """The bytes a run collapse of [Q, W] sorted ids and ``k`` value arrays
    needs: every slot of each array read once and written once."""
    return 2 * Q * W * word_bytes * (1 + k)


def share_of_peak(needed: float, seconds: float, peak: float) -> float:
    """``needed`` (operations or bytes) over ``seconds``, as a percentage of
    ``peak`` (per second)."""
    return 100.0 * needed / seconds / peak


def quartile_spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median, by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merge_intervals(intervals))


def merge_intervals(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint ones, in order."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip_intervals(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Each interval cut to [lo, hi); those outside it dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]
