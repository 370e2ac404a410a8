"""Graph Feature Service (GFS): set-intersection edge features.

Counterpart of ``the_algorithm_tpu/features/graph_features.py``
(``graph-feature-service/``, "how many of A's follows faved C?"). Adjacency
lists are fixed-width sorted rows of per-edge-type tables [E, U, D];
intersection counts are all-pairs equality masks, batched over (user,
candidate) pairs. The sharded worker path (``shard_tables``,
``feature_block_sharded``) comes with the port's mesh layer.
"""

from __future__ import annotations

import enum
from typing import Dict, NamedTuple, Tuple

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
