"""Batched product front: the request batcher behind the HTTP timeline edge.

≡ how the reference fleet actually sustains >6,000 RPS through the For You
path: concurrent requests coalesce into shared accelerator batches (navi's
size+deadline rule) BEHIND the Thrift edge, invisibly to clients. Here:
:class:`BatchedTimelineFront` exposes the same ``run(query) -> Timeline``
surface as a product pipeline — so it drops into
``InferenceServer(products=…)`` unchanged — while internally routing every
concurrent request through ONE
:class:`~the_algorithm_tpu_torch.mixers.batched_foryou.BatchedForYouEngine`
serve batch (one earlybird scan, one UTEG traversal, one fused
hydration+scoring pass for all coalesced requests).

A host copy of ``the_algorithm_tpu/serving/product_front.py``: any engine
with ``serve_batch(queries) -> [candidates]`` will do.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from the_algorithm_tpu_torch.mixers.batched_foryou import BatchedForYouEngine
from the_algorithm_tpu_torch.pipeline.component import Candidate
from the_algorithm_tpu_torch.pipeline.mixer import EntryKind, Timeline, TimelineEntry
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig, RequestBatcher


def default_timeline_builder(query, candidates: List[Candidate]) -> Timeline:
    """Ranked candidates → the URT-marshallable Timeline (tweet entries +
    cursor bounds — the minimal ScoredTweets product envelope)."""
    entries = [TimelineEntry(kind=EntryKind.TWEET, candidate=c)
               for c in candidates]
    ids = [c.id for c in candidates]
    return Timeline(
        entries=entries,
        top_cursor=max(ids) if ids else None,
        bottom_cursor=min(ids) if ids else None,
    )


class BatchedTimelineFront:
    """Pipeline-shaped wrapper: ``run(query)`` blocks on the coalesced
    batch and returns this request's Timeline."""

    def __init__(
        self,
        engine: BatchedForYouEngine,
        config: BatcherConfig = BatcherConfig(
            max_batch_size=32, max_delay_ms=8.0),
        timeline_builder: Optional[Callable] = None,
        timeout_s: float = 30.0,
    ):
        self.engine = engine
        self._build = timeline_builder or default_timeline_builder
        self._timeout = timeout_s
        self._front = RequestBatcher(engine.serve_batch, config)

    def run(self, query, params=None) -> Timeline:
        candidates = self._front.serve(query, timeout=self._timeout)
        return self._build(query, candidates)

    def close(self) -> None:
        self._front.close()
