"""SimClusters candidate sources: cluster ranking and the SANN wrapper.

Counterpart of ``the_algorithm_tpu/simclusters/candidate_source.py``
(``simclusters_v2/candidate_source/{ClusterRanker,HeavyRanker,
SimClustersANNCandidateSource,SimClustersANNWrapperCandidateSource}.scala``):
before the ANN scan the consumer's InterestedIn clusters are re-ranked
(which clusters are worth scanning is a lever apart from their scores), and
after it an optional heavy ranker re-scores the candidates.

The wrapper's request: an RMS fetch (one ``row_gather`` launch on a miss of
a table store), :func:`rank_clusters` (``retrieval.top_k``), then
``ann.get_tweet_candidates``: the SANN scan's row fetch (one ``row_gather``
launch) and dedup (one ``run_collapse_sorted`` launch).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, List, Optional

import torch

from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.ops.gather import jax_rows
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, top_k
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidateSource
from the_algorithm_tpu_torch.simclusters import ann
from the_algorithm_tpu_torch.simclusters.representation_manager import EmbeddingId, RepresentationManager


class ClusterRankStrategy(enum.Enum):
    """≡ ``ClusterRanker.scala`` ranking modes (RankBy*Score)."""

    BY_SCORE = "score"  # the embedding score as it is
    BY_LOG_SCORE = "log_score"  # dampens head clusters
    BY_NORMALIZED_SCORE = "normalized"  # score / the cluster's global norm
    BY_INDEX_POPULARITY = "index_popularity"  # score × log1p(tweets in the cluster's row)


def rank_clusters(
    embedding: SparseEmbedding,  # [..., K]
    top_n: int,
    strategy: ClusterRankStrategy = ClusterRankStrategy.BY_SCORE,
    *,
    cluster_norms: Optional[torch.Tensor] = None,  # [C] for BY_NORMALIZED_SCORE
    index_fill: Optional[torch.Tensor] = None,  # [C] row fill counts
) -> SparseEmbedding:
    """The top-N clusters to scan, keeping their embedding scores
    (``ClusterRanker.getTopKClustersByScore``): the ranking key changes with
    the strategy, the scores that enter the scan do not. Ties rank as
    ``lax.top_k`` ranks them (lower slot first)."""
    valid = embedding.ids != PAD_ID
    if strategy is ClusterRankStrategy.BY_SCORE:
        key = embedding.scores
    elif strategy is ClusterRankStrategy.BY_LOG_SCORE:
        key = torch.log1p(torch.clamp(embedding.scores, min=0.0))
    elif strategy is ClusterRankStrategy.BY_NORMALIZED_SCORE:
        if cluster_norms is None:
            raise ValueError("BY_NORMALIZED_SCORE needs cluster_norms")
        safe = jax_rows(torch.where(valid, embedding.ids, 0), cluster_norms.shape[0])
        key = embedding.scores / torch.clamp(cluster_norms[safe], min=1e-9)
    elif strategy is ClusterRankStrategy.BY_INDEX_POPULARITY:
        if index_fill is None:
            raise ValueError("BY_INDEX_POPULARITY needs index_fill")
        safe = jax_rows(torch.where(valid, embedding.ids, 0), index_fill.shape[0])
        key = embedding.scores * torch.log1p(index_fill[safe].to(torch.float32))
    else:  # pragma: no cover
        raise ValueError(strategy)
    key = torch.where(valid, key, -torch.inf)
    n = min(top_n, embedding.ids.shape[-1])
    top_key, idx = top_k(key, n)
    keep = torch.isfinite(top_key)
    return SparseEmbedding(torch.where(keep, torch.take_along_dim(embedding.ids, idx, dim=-1), PAD_ID),
                           torch.where(keep, torch.take_along_dim(embedding.scores, idx, dim=-1), 0.0))


def index_fill_counts(index: ClusterTweetIndex) -> torch.Tensor:
    """Real tweets a cluster row holds: the BY_INDEX_POPULARITY signal."""
    return (index.tweet_ids != PAD_ID).sum(dim=1)


# ≡ HeavyRanker.scala: a post-retrieval re-scorer hook (prod plugs a model)
HeavyRanker = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class SimClustersANNWrapperConfig:
    """The wrapper's knobs (≡ SimClustersANNWrapperCandidateSource params)."""

    embedding: EmbeddingId = None  # type: ignore[assignment]
    ann_config: ann.SimClustersANNConfig = dataclasses.field(default_factory=ann.SimClustersANNConfig)
    cluster_rank_strategy: ClusterRankStrategy = ClusterRankStrategy.BY_SCORE
    enable_heavy_ranker: bool = False


class SimClustersANNWrapperCandidateSource(CandidateSource):
    """≡ ``SimClustersANNWrapperCandidateSource.scala``: RMS fetch → cluster
    rank → SANN scan → optional heavy rerank, as one component."""

    def __init__(
        self,
        rms: RepresentationManager,
        index: ClusterTweetIndex,
        config: SimClustersANNWrapperConfig,
        heavy_ranker: Optional[HeavyRanker] = None,
    ):
        self.rms = rms
        self.index = index
        self.config = config
        self.heavy_ranker = heavy_ranker
        self._fill = index_fill_counts(index)

    def get(self, query: Any, params: Params) -> List[Candidate]:
        user_id = getattr(query, "user_id", None)
        if user_id is None:
            user_id = query["user_id"]
        emb = self.rms.get(self.config.embedding, int(user_id))
        dev, cfg = self.index.tweet_ids.device, self.config.ann_config
        ranked = rank_clusters(SparseEmbedding(emb.ids.to(dev), emb.scores.to(dev)), cfg.max_scan_clusters,
                               self.config.cluster_rank_strategy, index_fill=self._fill)
        ids, scores = ann.get_tweet_candidates(self.index, ranked, cfg)
        if self.heavy_ranker is not None and self.config.enable_heavy_ranker:
            scores = self.heavy_ranker(query, ids, scores)
            order = torch.sort(-scores, stable=True).indices  # jnp.argsort: stable
            ids, scores = ids[order], scores[order]
        ids_np, scores_np = host_array(ids), host_array(scores)
        return [Candidate(id=int(t), score=float(s), source="simclusters_ann_wrapper")
                for t, s in zip(ids_np, scores_np) if t != PAD_ID]
