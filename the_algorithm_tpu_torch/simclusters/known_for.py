"""KnownFor community detection: the label-update iteration.

Counterpart of ``the_algorithm_tpu/simclusters/known_for.py``
(``UpdateKnownFor.scala``: every node looks at its neighbours' cluster
assignments and picks the cluster maximizing a TP/FN/FP-weighted score,
``getScoresForCluster:89-112``, ``pickBestCluster:114-149``,
``collectInformationPerNode:222-276``). The types — :class:`Graph`, the
fixed-width top-D neighbour graph that ``simclusters/sims_graph.py`` builds
and the follow-recommendation sources read, :class:`KnownFor`,
:class:`KnownForParams`, :data:`NO_CLUSTER` — and the iteration.

The Scalding shuffle is a gather plus a per-row grouped sum: neighbour
assignments gathered through the [U, D] adjacency, per-cluster neighbourhood
stats from ``ops/segment.row_dedup_sum`` (one run-collapse launch with four
value rows), per-cluster totals from ``segment.scatter_sum`` (sort + one
launch; no float atomic), and the pick an argmax. ``torch.argmax`` takes the
first maximum, as JAX's does, and an all ``-inf`` row gives 0. A near-tie
between two clusters can flip on f32 rounding between summation orders and
then cascade through later iterations.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from the_algorithm_tpu_torch.ops.segment import row_dedup_sum, scatter_sum
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

NO_CLUSTER = -1


class Graph(NamedTuple):
    """Fixed-width symmetric adjacency (top-D neighbors, PAD_ID padded)."""

    nbr_ids: torch.Tensor  # [U, D] int32, PAD_ID = empty slot
    nbr_weights: torch.Tensor  # [U, D] float32, 0 in padding

    @property
    def num_nodes(self) -> int:
        return self.nbr_ids.shape[0]

    def to(self, device) -> "Graph":
        return Graph(self.nbr_ids.to(device), self.nbr_weights.to(device))


class KnownFor(NamedTuple):
    """One cluster per node (``cluster = -1`` ⇒ unassigned)."""

    cluster: torch.Tensor  # [U] int32
    score: torch.Tensor  # [U] float32


@dataclasses.dataclass(frozen=True)
class KnownForParams:
    """≡ UpdateKnownForApps args (``UpdateKnownForApps.scala:159-177``)."""

    num_clusters: int
    min_neighbors_in_cluster: int = 2  # minNeighborsInCluster default
    true_positive_wt_factor: float = 10.0  # truePositiveWtFactor default
    # 'sum' | 'ratio' | 'ratio_membership' (clusterScoresToFinalScore options)
    final_score: str = "ratio_membership"


def cluster_stats(kf: KnownFor, num_clusters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(size_c, Σ membership_c) per cluster — ``clusterOverallStatsMap``."""
    assigned = kf.cluster >= 0
    keys = torch.where(assigned, kf.cluster, -1)
    return scatter_sum(keys, assigned.float(), torch.where(assigned, kf.score, 0.0), size=num_clusters)


def global_stats(graph: Graph, kf: KnownFor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global avg edge weight, avg membership score of assigned nodes)."""
    valid = graph.nbr_ids != PAD_ID
    total_w = torch.sum(torch.where(valid, graph.nbr_weights, 0.0))
    avg_w = total_w / torch.clamp(valid.sum(), min=1)
    assigned = kf.cluster >= 0
    avg_m = torch.sum(torch.where(assigned, kf.score, 0.0)) / torch.clamp(assigned.sum(), min=1)
    return avg_w, avg_m


def _scores_for_clusters(*, sum_w, sum_mw, cand_count, cand_sum_w, cand_sum_mw, cand_sum_m,
                         cand_cluster_size, cand_cluster_memb, avg_w, params: KnownForParams):
    """≡ ``getScoresForCluster`` (UpdateKnownFor.scala:89-112), vectorized."""
    tp = cand_sum_w
    fn = sum_w[:, None] - tp
    fp = (cand_cluster_size - cand_count) * avg_w
    mw_tp = cand_sum_mw
    mw_fn = sum_mw[:, None] - mw_tp
    mw_fp = (cand_cluster_memb - cand_sum_m) * avg_w
    eps = 1e-20
    sum_score = params.true_positive_wt_factor * tp - fn - fp
    ratio = tp / torch.clamp(tp + fn + fp, min=eps)
    ratio_m = mw_tp / torch.clamp(mw_tp + mw_fp + mw_fn, min=eps)
    return sum_score, ratio, ratio_m


def _neighbours(graph: Graph, kf: KnownFor):
    valid = graph.nbr_ids != PAD_ID
    safe = torch.where(valid, graph.nbr_ids, 0).long()
    nbr_cluster = torch.where(valid, kf.cluster[safe], NO_CLUSTER)  # [U, D]
    return valid, safe, nbr_cluster, torch.where(valid, graph.nbr_weights, 0.0)


def update_iteration(graph: Graph, kf: KnownFor, params: KnownForParams) -> KnownFor:
    """One label-update sweep (``updateGeneric``)."""
    sizes, membs = cluster_stats(kf, params.num_clusters)
    avg_w, avg_m = global_stats(graph, kf)
    valid, safe, nbr_cluster, w = _neighbours(graph, kf)
    nbr_assigned = nbr_cluster >= 0
    nbr_score = torch.where(nbr_assigned, kf.score[safe], avg_m)

    # overall neighborhood stats (collectInformationPerNode's outer sum)
    deg = valid.sum(-1)  # nodeCount
    sum_w = w.sum(-1)
    sum_mw = (w * nbr_score).sum(-1)

    # per-cluster stats within the neighborhood: group by neighbor's cluster
    group_ids = torch.where(valid & nbr_assigned, nbr_cluster, PAD_ID)
    rep, c_count, c_sum_w, c_sum_mw, c_sum_m = row_dedup_sum(
        group_ids,
        (valid & nbr_assigned).float(),
        torch.where(nbr_assigned, w, 0.0),
        torch.where(nbr_assigned, w * nbr_score, 0.0),
        torch.where(nbr_assigned, nbr_score, 0.0),
    )
    is_cand = rep != PAD_ID
    safe_rep = torch.where(is_cand, rep, 0).long()
    sum_score, ratio, ratio_m = _scores_for_clusters(
        sum_w=sum_w, sum_mw=sum_mw, cand_count=c_count, cand_sum_w=c_sum_w, cand_sum_mw=c_sum_mw,
        cand_sum_m=c_sum_m, cand_cluster_size=sizes[safe_rep], cand_cluster_memb=membs[safe_rep],
        avg_w=avg_w, params=params)
    final = {"sum": sum_score, "ratio": ratio, "ratio_membership": ratio_m}[params.final_score]

    # eligibility: ≥ minNeighborsInCluster neighbors in the cluster, and the
    # node itself has ≥ minNeighbors neighbors (updateGeneric:173-176)
    eligible = (is_cand & (c_count >= params.min_neighbors_in_cluster)
                & (deg >= params.min_neighbors_in_cluster)[:, None])
    masked = torch.where(eligible, final, -torch.inf)
    best = torch.argmax(masked, dim=-1, keepdim=True)  # the first maximum, as JAX's
    best_score = torch.take_along_dim(masked, best, dim=-1)[:, 0]
    best_cluster = torch.take_along_dim(safe_rep, best, dim=-1)[:, 0].to(torch.int32)
    has_winner = torch.isfinite(best_score)
    return KnownFor(torch.where(has_winner, best_cluster, NO_CLUSTER).to(torch.int32),
                    torch.where(has_winner, best_score, 0.0))


def final_scores(graph: Graph, kf: KnownFor, params: KnownForParams) -> KnownFor:
    """Replace scores with ratioScoreIgnoringMembershipScores for the
    assigned cluster (``newKnownForScores:287-310``, tpFactor=0)."""
    sizes, _ = cluster_stats(kf, params.num_clusters)
    avg_w, _ = global_stats(graph, kf)
    _, _, nbr_cluster, w = _neighbours(graph, kf)
    sum_w = w.sum(-1)
    own = kf.cluster
    in_own = (nbr_cluster == own[:, None]) & (own >= 0)[:, None]
    tp = torch.where(in_own, w, 0.0).sum(-1)
    count = in_own.sum(-1)
    fn = sum_w - tp
    fp = (sizes[torch.clamp(own, min=0).long()] - count) * avg_w
    ratio = tp / torch.clamp(tp + fn + fp, min=1e-20)
    return KnownFor(own, torch.where(own >= 0, ratio, 0.0))


def iterate(graph: Graph, kf: KnownFor, params: KnownForParams, num_iterations: int) -> KnownFor:
    """Run ``num_iterations`` sweeps then the final scoring pass."""
    for _ in range(num_iterations):
        kf = update_iteration(graph, kf, params)
    return final_scores(graph, kf, params)


def initialize_random(generator: torch.Generator, num_nodes: int, num_clusters: int,
                      fraction: float = 1.0) -> KnownFor:
    """Random initial assignment (stand-in for the egonet-based seeding in
    ``KnownForSources.scala`` — any seeding works; iteration refines it),
    drawn from ``generator`` on its device."""
    dev = generator.device
    clusters = torch.randint(0, num_clusters, (num_nodes,), generator=generator, device=dev, dtype=torch.int32)
    mask = torch.rand((num_nodes,), generator=generator, device=dev) < fraction
    return KnownFor(torch.where(mask, clusters, NO_CLUSTER).to(torch.int32), mask.float())
