"""InterestedIn consumer embeddings: U = A·V.

Counterpart of ``the_algorithm_tpu/simclusters/interested_in.py``
(``InterestedInFromKnownFor.scala``): for each consumer, aggregate the
KnownFor clusters of followed/faved producers
(``userClusterPairsWithoutNormalization:249``), social-proof threshold,
cluster-level L2 normalization (``attachNormalizedScores:342``), and
per-user top-K truncation ranked by (favScore, logFavScore, followScore)
(``keepOnlyTopClusters:530``), default top-50 clusters a user
(``summingbird/common/Configs.scala:43``).

The join + flatMap + sumByKey shuffle is a gather (producer → cluster
through KnownFor) and a per-row grouped sum over the [U, D] follow/fav
adjacency (``ops/segment.row_dedup_sum``: one run-collapse launch with four
value rows). The cluster L2 norms are a deterministic scatter
(``segment.scatter_sum``: sort + one launch, no float atomic). The top-K
over the composite rank key goes through ``retrieval.top_k`` (``lax.top_k``'s
order among equal keys).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from the_algorithm_tpu_torch.ops.retrieval import top_k
from the_algorithm_tpu_torch.ops.segment import row_dedup_sum, scatter_sum
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.simclusters.known_for import KnownFor


class FollowFavGraph(NamedTuple):
    """User → producer engagement adjacency (fixed width, PAD_ID padded).

    ≡ ``UserAndNeighbors`` with per-edge ``isFollowed``,
    ``favScoreHalfLife100Days`` and ``logFavScore``
    (``InterestedInFromKnownFor.scala:263-300``).
    """

    producer_ids: torch.Tensor  # [U, D] int32
    followed: torch.Tensor  # [U, D] bool
    fav_score: torch.Tensor  # [U, D] float32 (half-life-decayed fav weight)
    log_fav_score: torch.Tensor  # [U, D] float32

    def to(self, device) -> "FollowFavGraph":
        return FollowFavGraph(*(t.to(device) for t in self))


@dataclasses.dataclass(frozen=True)
class InterestedInParams:
    num_clusters: int
    social_proof_threshold: int = 2  # socialProofThreshold default
    max_clusters_per_user: int = 50  # topKClustersPerEntity (Configs.scala:43)


class InterestedIn(NamedTuple):
    """Per-user cluster scores, each a [U, K] SparseEmbedding batch with the
    same cluster layout across score types (ids come from ``fav`` ranking)."""

    ids: torch.Tensor  # [U, K] int32 cluster ids (PAD_ID padded)
    follow_score: torch.Tensor  # [U, K]
    fav_score: torch.Tensor  # [U, K]
    log_fav_score: torch.Tensor  # [U, K]
    fav_cluster_normalized: torch.Tensor  # [U, K] — fav / cluster L2 norm
    log_fav_cluster_normalized: torch.Tensor  # [U, K]

    def embedding(self, kind: str = "fav") -> SparseEmbedding:
        arr = {
            "follow": self.follow_score,
            "fav": self.fav_score,
            "log_fav": self.log_fav_score,
            "fav_norm": self.fav_cluster_normalized,
            "log_fav_norm": self.log_fav_cluster_normalized,
        }[kind]
        return SparseEmbedding(self.ids, arr)


def interested_in_from_known_for(graph: FollowFavGraph, kf: KnownFor, params: InterestedInParams) -> InterestedIn:
    """The full InterestedIn job."""
    valid = graph.producer_ids != PAD_ID
    safe_p = torch.where(valid, graph.producer_ids, 0).long()
    p_cluster = torch.where(valid, kf.cluster[safe_p], -1)  # [U, D]
    p_score = torch.clamp(kf.score[safe_p], min=0.0)  # knownForScore clamped ≥0
    has_cluster = p_cluster >= 0
    real = valid & has_cluster

    contributes = real & (graph.followed | (graph.fav_score > 0))
    group = torch.where(real, p_cluster, PAD_ID)
    follow_part = torch.where(graph.followed & real, p_score, 0.0)
    fav_part = torch.where(real, graph.fav_score * p_score, 0.0)
    logfav_part = torch.where(real, graph.log_fav_score * p_score, 0.0)

    rep, follow_s, fav_s, logfav_s, proof = row_dedup_sum(group, follow_part, fav_part, logfav_part,
                                                          contributes.float())
    # social-proof threshold: ≥ N distinct contributing producers
    keep = (rep != PAD_ID) & (proof >= params.social_proof_threshold)
    follow_s = torch.where(keep, follow_s, 0.0)
    fav_s = torch.where(keep, fav_s, 0.0)
    logfav_s = torch.where(keep, logfav_s, 0.0)
    rep = torch.where(keep, rep, PAD_ID)

    # cluster-level L2 norms over all users (attachNormalizedScores)
    safe_rep = torch.where(keep, rep, 0).long()
    fav_norm_sq, logfav_norm_sq = scatter_sum(torch.where(keep, rep, -1), fav_s * fav_s, logfav_s * logfav_s,
                                              size=params.num_clusters)
    fav_norm = torch.sqrt(torch.clamp(fav_norm_sq, min=1e-30))
    logfav_norm = torch.sqrt(torch.clamp(logfav_norm_sq, min=1e-30))
    fav_n = torch.where(keep, fav_s / fav_norm[safe_rep], 0.0)
    logfav_n = torch.where(keep, logfav_s / logfav_norm[safe_rep], 0.0)

    # per-user top-K by (favScore, logFavScore, followScore) lexicographic —
    # approximated by a single composite key (fav dominates, then logfav,
    # then follow; keepOnlyTopClusters:553-560)
    rank_key = torch.where(keep, fav_s + 1e-4 * logfav_s + 1e-8 * follow_s, -torch.inf)
    K = min(params.max_clusters_per_user, rank_key.shape[-1])
    top_key, top_idx = top_k(rank_key, K)
    sel_keep = torch.isfinite(top_key)

    def z(a):
        return torch.where(sel_keep, torch.take_along_dim(a, top_idx, dim=-1), 0.0)

    return InterestedIn(
        ids=torch.where(sel_keep, torch.take_along_dim(rep, top_idx, dim=-1), PAD_ID),
        follow_score=z(follow_s),
        fav_score=z(fav_s),
        log_fav_score=z(logfav_s),
        fav_cluster_normalized=z(fav_n),
        log_fav_cluster_normalized=z(logfav_n),
    )
