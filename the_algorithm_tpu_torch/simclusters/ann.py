"""SimClusters-ANN "service": config + batched query path, on one device.

Counterpart of the single-device part of ``the_algorithm_tpu/simclusters/ann.py``
(``SimClustersANNCandidateSource.scala:35-95``): truncate the source
embedding to maxScanClusters, multiget the cluster rows, score, filter,
top-X. Prod parameters (``simclusters-ann/README.md:7,23-33``): N=50 scan
clusters, M=400 tweets/cluster, X=200 results.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from the_algorithm_tpu_torch.ops import retrieval, sparse
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, PerQuery, ScoringAlgorithm
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding


@dataclasses.dataclass(frozen=True)
class SimClustersANNConfig:
    """≡ thrift ``SimClustersANNConfig`` (simClustersAnn.thrift:18-28)."""

    max_scan_clusters: int = 50  # N
    max_top_tweets_per_cluster: int = 400  # M
    max_num_results: int = 200  # X
    min_score: float = 0.0
    scoring_algorithm: ScoringAlgorithm = ScoringAlgorithm.COSINE
    max_tweet_candidate_age_hours: int = 48
    min_tweet_candidate_age_hours: int = 0


def _query(
    index: ClusterTweetIndex,
    sources: SparseEmbedding,
    config: SimClustersANNConfig,
    now: Optional[PerQuery],
    exclude_tweet_id: Optional[PerQuery],
) -> Tuple[torch.Tensor, torch.Tensor]:
    src = sparse.truncate(sources, config.max_scan_clusters)
    earliest = latest = None
    if now is not None:
        earliest = now - config.max_tweet_candidate_age_hours * 3600
        latest = now - config.min_tweet_candidate_age_hours * 3600
    return retrieval.approximate_cosine_similarity(
        index,
        src,
        max_results=config.max_num_results,
        algorithm=config.scoring_algorithm,
        min_score=config.min_score,
        max_top_tweets_per_cluster=config.max_top_tweets_per_cluster,
        exclude_tweet_id=exclude_tweet_id,
        earliest_ts=earliest,
        latest_ts=latest,
    )


def get_tweet_candidates(
    index: ClusterTweetIndex,
    source_embedding: SparseEmbedding,  # [N]
    config: SimClustersANNConfig,
    *,
    now: Optional[int] = None,
    exclude_tweet_id: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-query path (``SimClustersANNCandidateSource.get:35-64``) → ([X], [X])."""
    one = SparseEmbedding(source_embedding.ids[None], source_embedding.scores[None])
    ids, scores = _query(index, one, config, now, exclude_tweet_id)
    return ids[0], scores[0]


def get_tweet_candidates_batch(
    index: ClusterTweetIndex,
    sources: SparseEmbedding,  # [Q, N]
    config: SimClustersANNConfig,
    *,
    now: Optional[PerQuery] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched query path → (tweet_ids [Q, X], scores [Q, X]).

    ``now`` (seconds, in the index timestamps' epoch) turns on the age
    window [now - max_age, now - min_age]: one value for all queries, or a
    [Q] tensor.
    """
    return _query(index, sources, config, now, None)
