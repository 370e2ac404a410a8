"""Multi-type engagement graph assembly with right-node top-K truncation.

Counterpart of ``the_algorithm_tpu/simclusters/multi_type_graph.py``
(``scalding/multi_type_graph/assemble_multi_type_graph/
AssembleMultiTypeGraph.scala``): per-engagement-type bipartite edges (user →
{fav, retweet, reply, follow, click} → right node) become one typed graph,
each (right node, type) truncated to its top-K heaviest left neighbours.

The sort by (group, −weight) is one stable sort of an int64 key: the group
above an order-preserving image of the weight, descending, so equal weights
keep their input order. ``lax.sort`` ranks −0.0 equal to +0.0 (JAX 0.9 on
the CPU: a stable sort keeps them in input order), and so does the image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from the_algorithm_tpu_torch.ops.gather import jax_rows
from the_algorithm_tpu_torch.ops.segment import ranked, run_rank
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


class MultiTypeGraph(NamedTuple):
    """right node → per edge type top-K left neighbours."""

    left_ids: torch.Tensor  # [R, E, K] int32, PAD_ID padded
    weights: torch.Tensor  # [R, E, K] float32


def assemble(
    left: torch.Tensor,  # [B] int32 left (user) ids
    right: torch.Tensor,  # [B] int32 right node ids (< num_right)
    edge_type: torch.Tensor,  # [B] int32 (< num_types)
    weight: torch.Tensor,  # [B] float32
    *,
    num_right: int,
    num_types: int,
    top_k: int,
) -> MultiTypeGraph:
    """Assemble and truncate (``getTopKRightNounsWithFrequencies``).

    Duplicate (left, right, type) edges should be summed by the caller
    first, as in the JAX package (else each takes a slot)."""
    group = right.to(torch.int64) * num_types + edge_type.to(torch.int64)
    order = ranked(group, weight.to(torch.float32))
    g_s, w_s, left_s = group[order], weight.to(torch.float32)[order], left.to(torch.int32)[order]
    rank = run_rank(g_s)
    ok = (rank < top_k) & (g_s >= 0) & (g_s < num_right * num_types)
    slot = torch.where(ok, g_s * top_k + rank, num_right * num_types * top_k)  # a spare slot takes the rest
    n = num_right * num_types * top_k
    left_table = torch.full((n + 1,), PAD_ID, dtype=torch.int32, device=left.device)
    w_table = torch.zeros(n + 1, dtype=torch.float32, device=left.device)
    left_table.index_put_((slot,), left_s)
    w_table.index_put_((slot,), w_s)
    shape = (num_right, num_types, top_k)
    return MultiTypeGraph(left_table[:-1].view(shape), w_table[:-1].view(shape))


def truncated_similarity(graph: MultiTypeGraph, a, b) -> torch.Tensor:
    """Weighted overlap of two right nodes' truncated neighbour sets, summed
    over edge types (the multi-type similarity used downstream). ``a`` and
    ``b`` are node ids of any (matching) shape."""
    R = graph.left_ids.shape[0]
    a = jax_rows(torch.as_tensor(a, device=graph.left_ids.device), R)
    b = jax_rows(torch.as_tensor(b, device=graph.left_ids.device), R)
    la, lb = graph.left_ids[a], graph.left_ids[b]  # [..., E, K]
    wa, wb = graph.weights[a], graph.weights[b]
    eq = (la[..., :, None] == lb[..., None, :]) & (la[..., :, None] != PAD_ID)
    return torch.sum(eq * wa[..., :, None] * wb[..., None, :], dim=(-3, -2, -1))
