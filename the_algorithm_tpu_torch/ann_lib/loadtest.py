"""ANN loadtest harness: recall against the truth, latency percentiles, RPS.

Counterpart of ``the_algorithm_tpu/ann_lib/loadtest.py``
(``ann/src/main/scala/com/twitter/ann/service/loadtest/``:
``LoadTestRecorder.scala:16-96`` records recall@1, recall@10 and overall
recall against brute-force neighbours, and avg/p50/p90/p99 query latency
(µs) and avg RPS; ``AnnLoadTestWorker.scala:20`` defines the result row).
Latencies are host-clock times of whole ``query`` calls, the device's work
and the copy of the answer back included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from the_algorithm_tpu_torch.ann_lib.index import BruteForceIndex, Metric


@dataclasses.dataclass
class LoadTestResult:
    """≡ the AnnLoadTestWorker TSV row."""

    recall_at_1: float
    recall_at_10: float
    overall_recall: float
    avg_latency_us: float
    p50_latency_us: float
    p90_latency_us: float
    p99_latency_us: float
    avg_rps: float
    num_queries: int

    def row(self) -> str:
        return (
            f"{self.recall_at_1:.4f}\t{self.recall_at_10:.4f}\t"
            f"{self.overall_recall:.4f}\t{self.avg_latency_us:.0f}\t"
            f"{self.p50_latency_us:.0f}\t{self.p90_latency_us:.0f}\t"
            f"{self.p99_latency_us:.0f}\t{self.avg_rps:.1f}"
        )


class LoadTestRecorder:
    def __init__(self):
        self.latencies_us: List[float] = []
        self.hits_at: Dict[int, int] = {1: 0, 10: 0}
        self.overall_hits = 0
        self.overall_truth = 0
        self.n = 0

    def record(self, got: np.ndarray, truth: np.ndarray, latency_us: float):
        """One query: got / truth are id arrays (truth: the brute-force top-K)."""
        self.latencies_us.append(latency_us)
        self.n += 1
        t1 = set(truth[:1].tolist())
        t10 = set(truth[:10].tolist())
        g = got.tolist()
        self.hits_at[1] += int(bool(t1 & set(g[:1])))
        self.hits_at[10] += len(t10 & set(g[:10]))
        tk = set(truth.tolist())
        self.overall_hits += len(tk & set(g))
        self.overall_truth += len(tk)

    def result(self, wall_s: float) -> LoadTestResult:
        lat = np.asarray(self.latencies_us)
        return LoadTestResult(
            recall_at_1=self.hits_at[1] / max(self.n, 1),
            recall_at_10=self.hits_at[10] / max(10 * self.n, 1),
            overall_recall=self.overall_hits / max(self.overall_truth, 1),
            avg_latency_us=float(lat.mean()) if self.n else 0.0,
            p50_latency_us=float(np.percentile(lat, 50)) if self.n else 0.0,
            p90_latency_us=float(np.percentile(lat, 90)) if self.n else 0.0,
            p99_latency_us=float(np.percentile(lat, 99)) if self.n else 0.0,
            avg_rps=self.n / max(wall_s, 1e-9),
            num_queries=self.n,
        )


def run_loadtest(
    index,
    queries: np.ndarray,
    k: int = 100,
    truth_index: Optional[BruteForceIndex] = None,
    truth_vectors: Optional[np.ndarray] = None,
    truth_ids: Optional[np.ndarray] = None,
    metric: Metric = Metric.COSINE,
    *,
    device=None,
) -> LoadTestResult:
    """Drive an index query by query against brute-force truth (a
    :class:`BruteForceIndex` on ``device``, the card by default, when
    ``truth_index`` is not given)."""
    if truth_index is None:
        truth_index = BruteForceIndex(queries.shape[1], metric, device=device)
        truth_index.append(truth_ids, truth_vectors)
    truth_ids_all, _ = truth_index.query(queries, k)

    rec = LoadTestRecorder()
    t_start = time.perf_counter()
    for i in range(queries.shape[0]):
        t0 = time.perf_counter()
        got_ids, _ = index.query(queries[i : i + 1], k)
        lat = (time.perf_counter() - t0) * 1e6
        rec.record(got_ids[0], truth_ids_all[i], lat)
    return rec.result(time.perf_counter() - t_start)
