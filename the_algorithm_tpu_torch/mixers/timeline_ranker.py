"""TimelineRanker: the legacy fetch layer (recap + recycled candidates).

Counterpart of ``the_algorithm_tpu/mixers/timeline_ranker.py``
(``timelineranker/``): two light-ranked streams for home-mixer —
earlybird-relevance-scored in-network tweets ("recap", the port's
``search/earlybird.search`` or the ``search/root.SuperRoot`` fan-out) and
UTEG out-of-network tweets ("recycled", ``graph/uteg.recommend``: one
row_gather and one run_collapse launch) — each truncated by its score.
Results come back on the host (numpy), copied from the card explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.graph import uteg as uteg_mod
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.search import earlybird as eb


@dataclasses.dataclass(frozen=True)
class TimelineRankerConfig:
    max_in_network: int = 300
    max_out_of_network: int = 100
    min_social_proof: int = 1


@dataclasses.dataclass
class TimelineCandidates:
    in_network_ids: np.ndarray
    in_network_scores: np.ndarray
    oon_ids: np.ndarray
    oon_scores: np.ndarray


def _recap_query(followed_authors: Sequence[int], min_ts: int, max_ts: int, device) -> eb.SearchQuery:
    """The RecapQuery: match-all recency over the follow set (sorted)."""
    return eb.SearchQuery(
        tokens=torch.full((1,), PAD_ID, dtype=torch.int32, device=device),
        require_all=False,
        min_ts=int(min_ts),
        max_ts=int(max_ts),
        followed_authors=torch.tensor(sorted(followed_authors), dtype=torch.int32, device=device),
    )


def _recycled(graph: uteg_mod.EngagementGraph, followed_authors, seed_weights, min_ts: int,
              config: TimelineRankerConfig):
    """The RecycledQuery: UTEG over the follows as seeds, one query."""
    dev = graph.tweet_ids.device
    ids, scores, _ = uteg_mod.recommend(
        graph,
        torch.tensor([list(followed_authors)], dtype=torch.int32, device=dev),
        torch.tensor([list(seed_weights)], dtype=torch.float32, device=dev),
        max_results=config.max_out_of_network,
        min_social_proof=config.min_social_proof,
        min_timestamp=int(min_ts),
    )
    return host_array(ids[0]), host_array(scores[0])


def get_ranked_timeline(
    index: eb.EarlybirdIndex,
    graph: uteg_mod.EngagementGraph,
    *,
    followed_authors: Sequence[int],
    seed_weights: Sequence[float],
    min_ts: int,
    max_ts: int,
    config: TimelineRankerConfig = TimelineRankerConfig(),
) -> TimelineCandidates:
    """Fetch both streams (the RecapQuery + RecycledQuery paths)."""
    in_ids, in_scores = eb.search(
        index, _recap_query(followed_authors, min_ts, max_ts, index.tokens.device),
        max_results=config.max_in_network,
    )
    oon_ids, oon_scores = _recycled(graph, followed_authors, seed_weights, min_ts, config)
    return TimelineCandidates(host_array(in_ids), host_array(in_scores), oon_ids, oon_scores)


def get_ranked_timeline_multitier(
    root,  # search.root.SuperRoot
    graph: uteg_mod.EngagementGraph,
    *,
    followed_authors: Sequence[int],
    seed_weights: Sequence[float],
    min_ts: int,
    max_ts: int,
    relevance: "eb.RelevanceParams" = None,
    config: TimelineRankerConfig = TimelineRankerConfig(),
) -> TimelineCandidates:
    """Multi-tier variant: the recap stream fans out through the SuperRoot
    (realtime + archive tiers, request-scoped relevance), which moves the
    query to each tier's device; recycled stays UTEG."""
    in_ids, in_scores, _ = root.search(
        _recap_query(followed_authors, min_ts, max_ts, "cpu"),
        max_results=config.max_in_network,
        relevance=relevance,
    )
    oon_ids, oon_scores = _recycled(graph, followed_authors, seed_weights, min_ts, config)
    return TimelineCandidates(np.asarray(in_ids), np.asarray(in_scores), oon_ids, oon_scores)
