"""KnownFor's types: the producer-similarity graph and the assignment.

Counterpart of the types of ``the_algorithm_tpu/simclusters/known_for.py``
(``UpdateKnownFor.scala``): :class:`Graph`, the fixed-width top-D neighbour
graph that ``simclusters/sims_graph.py`` builds and the follow-recommendation
sources read, :class:`KnownFor`, :class:`KnownForParams` and
:data:`NO_CLUSTER`. The label-update iteration itself (``update_iteration``,
``iterate``, ``final_scores``, ``cluster_stats``, ``initialize_random``)
needs ``ops/segment.row_dedup_sum`` and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

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
