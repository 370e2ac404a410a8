"""Graph Feature Service (GFS): set-intersection edge features.

Counterpart of ``the_algorithm_tpu/features/graph_features.py``
(``graph-feature-service/``, "how many of A's follows faved C?"). Adjacency
lists are fixed-width sorted rows of per-edge-type tables [E, U, D];
intersection counts are all-pairs equality masks, batched over (user,
candidate) pairs. The sharded worker path (:func:`shard_tables`,
:func:`feature_block_sharded`) partitions adjacency by neighbor-id bucket
over the mesh's 'model' axis and sums the partial counts.
"""

from __future__ import annotations

import enum
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.ops.gather import jax_rows
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


class EdgeType(enum.IntEnum):
    """≡ gfs thrift edge types (follow/fav/retweet/mention directions)."""

    FOLLOWING = 0
    FOLLOWED_BY = 1
    FAVORITE = 2
    FAVORITED_BY = 3
    RETWEET = 4
    RETWEETED_BY = 5
    MENTION = 6
    MENTIONED_BY = 7


class GraphTables(NamedTuple):
    """Per-edge-type fixed-width adjacency: [E, U, D] int32 sorted rows."""

    neighbors: torch.Tensor  # [num_edge_types, U, D], PAD_ID padded, sorted asc

    @property
    def num_users(self) -> int:
        return self.neighbors.shape[1]


def intersection_count(a_row: torch.Tensor, b_row: torch.Tensor) -> torch.Tensor:
    """|a ∩ b| for padded id rows [..., Da] and [..., Db] (all-pairs equality)."""
    eq = ((a_row[..., :, None] == b_row[..., None, :])
          & (a_row != PAD_ID)[..., :, None] & (b_row != PAD_ID)[..., None, :])
    return eq.sum(dim=(-2, -1))


def get_intersection(
    tables: GraphTables,
    user_id,
    candidate_ids: torch.Tensor,  # [C] e.g. candidate authors
    user_edge: EdgeType,
    candidate_edge: EdgeType,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(count [C], user_degree) — ``ServerGetIntersectionHandler`` analog:
    count[c] = |edge(user, user_edge) ∩ edge(candidate_c, candidate_edge)|.
    An id outside [0, U) reads the row a JAX gather reads (:func:`jax_rows`)."""
    U, dev = tables.num_users, tables.neighbors.device
    a_row = tables.neighbors[int(user_edge), jax_rows(torch.as_tensor(user_id, device=dev), U)]  # [D]
    b_rows = tables.neighbors[int(candidate_edge), jax_rows(torch.as_tensor(candidate_ids, device=dev), U)]  # [C, D]
    return intersection_count(a_row[None, :], b_rows), (a_row != PAD_ID).sum()


FEATURE_PAIRS: Dict[str, Tuple[EdgeType, EdgeType]] = {
    # the canonical gfs features used by FRS/home feature hydrators
    "follows_who_favorited": (EdgeType.FOLLOWING, EdgeType.FAVORITED_BY),
    "follows_who_follow": (EdgeType.FOLLOWING, EdgeType.FOLLOWED_BY),
    "follows_who_retweeted": (EdgeType.FOLLOWING, EdgeType.RETWEETED_BY),
    "follows_who_mentioned": (EdgeType.FOLLOWING, EdgeType.MENTIONED_BY),
}


def feature_block(tables: GraphTables, user_id, candidate_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All standard intersection features + normalized variants for a
    candidate batch."""
    out: Dict[str, torch.Tensor] = {}
    for name, (ue, ce) in FEATURE_PAIRS.items():
        counts, degree = get_intersection(tables, user_id, candidate_ids, ue, ce)
        out[name] = counts.float()
        out[name + "_normalized"] = counts / torch.clamp(degree, min=1).float()
    return out


# -- sharded worker path ------------------------------------------------------
#
# ≡ the server→worker fan-out: each worker computes partial intersection
# counts over the slice of the adjacency lists it owns and the server sums
# them (``WorkerGetIntersectionHandler.scala:18-31``). Adjacency rows are
# repartitioned by neighbor-id bucket (id % n_shards — a filtered
# subsequence of a sorted row stays sorted), each 'model' shard computes
# |A_w ∩ B_w| on its slice, and the exact total is a sum: buckets partition
# the id space, so cross-shard pairs can never match.


def shard_tables(tables: GraphTables, n_shards: int, width: int = 0) -> torch.Tensor:
    """Repartition [E, U, D] adjacency into per-worker slices [n_shards, E,
    U, W] by neighbor-id bucket (a host build step, with numpy, as the JAX
    package's), on the tables' device. ``width`` defaults to D (worst-case
    bucket skew keeps every neighbor)."""
    nbrs = tables.neighbors.cpu().numpy()
    E, U, D = nbrs.shape
    W = width or D
    out = np.full((n_shards, E, U, W), PAD_ID, np.int32)
    valid = nbrs != PAD_ID
    bucket = np.where(valid, nbrs % n_shards, -1)
    for s in range(n_shards):
        sel = bucket == s  # order-preserving → stays sorted
        # pack each row's selected ids to the front
        order = np.argsort(~sel, axis=2, kind="stable")
        out[s] = np.take_along_axis(np.where(sel, nbrs, PAD_ID), order, axis=2)[:, :, :W]
    return torch.from_numpy(out).to(tables.neighbors.device)


def feature_block_sharded(mesh, sharded_neighbors: torch.Tensor, user_id,
                          candidate_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The worker fan-out on the mesh: this rank's [1, E, U, W] slice of
    :func:`shard_tables`' output (P('model') on the first axis), partial
    intersections summed over 'model' (integer counts and degrees, exact) —
    the same features as :func:`feature_block`, on every rank."""
    from the_algorithm_tpu_torch.core.mesh import MODEL_AXIS

    local = GraphTables(sharded_neighbors[0])  # [E, U, W] this worker's slice
    out: Dict[str, torch.Tensor] = {}
    for name, (ue, ce) in FEATURE_PAIRS.items():
        counts, degree = get_intersection(local, user_id, candidate_ids, ue, ce)
        counts = mesh.psum(counts, MODEL_AXIS)
        degree = mesh.psum(degree, MODEL_AXIS)
        out[name] = counts.float()
        out[name + "_normalized"] = counts / torch.clamp(degree, min=1).float()
    return out
