"""Producer-producer similarity graph: follower-cosine over the follow matrix.

Counterpart of ``the_algorithm_tpu/simclusters/sims_graph.py``
(``TopUsersSimilarityGraph.scala``: pairwise cosine similarity of follower
columns, top-D neighbours per producer, symmetrized, optional self-loops).
sim(p, q) = |followers(p) ∩ followers(q)| / (√deg(p)·√deg(q)) is computed
``block_size`` producers at a time as Fᵀ·F (one [block, P] panel at a time,
so the P×P product never materializes), then each row's top-K in
``lax.top_k``'s order (:func:`~the_algorithm_tpu_torch.ops.retrieval.top_k`).

Co-follow counts are whole numbers and exact in f32 (TF32 off on the card);
``torch.rsqrt`` and XLA's ``rsqrt`` may differ by an ulp, so equal
similarities can rank apart. :func:`symmetrize` keeps the larger directed
weight with ``scatter_reduce_("amax")``, JAX's ``.at[].max``.
"""

from __future__ import annotations

import torch

from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.simclusters.known_for import Graph


def follow_matrix_from_adjacency(producer_ids: torch.Tensor, num_producers: int) -> torch.Tensor:
    """Dense [U, P] follow counts from a [U, D] int32 follow adjacency
    (PAD_ID padded); an id outside [0, P) counts nowhere, as
    ``jax.nn.one_hot`` gives it no column."""
    valid = producer_ids != PAD_ID
    inside = valid & (producer_ids >= 0) & (producer_ids < num_producers)
    out = torch.zeros((producer_ids.shape[0], num_producers), dtype=torch.float32, device=producer_ids.device)
    return out.scatter_add_(1, torch.where(inside, producer_ids, 0).long(), inside.float())


def cosine_similarity_graph(
    follow: torch.Tensor,  # [U, P]
    *,
    top_k: int,
    min_similarity: float = 0.0,
    include_self_loops: bool = True,
    block_size: int = 512,
) -> Graph:
    """Top-K follower-cosine neighbours per producer (self-loops, sim 1,
    included by default as ``TopUsersSimilarityGraph`` adds them)."""
    k = top_k
    P = follow.shape[1]
    dev = follow.device
    deg = torch.sum(follow, dim=0)
    inv_norm = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), 0.0)
    n_blocks = (P + block_size - 1) // block_size
    pad_p = n_blocks * block_size
    if pad_p != P:
        follow = torch.nn.functional.pad(follow, (0, pad_p - P))
        inv_norm = torch.nn.functional.pad(inv_norm, (0, pad_p - P))
    ids_out = torch.empty((pad_p, k), dtype=torch.int32, device=dev)
    scores_out = torch.empty((pad_p, k), dtype=torch.float32, device=dev)
    rows = torch.arange(block_size, device=dev)
    for i in range(n_blocks):
        sl = slice(i * block_size, (i + 1) * block_size)
        co = follow[:, sl].T @ follow  # [block, pad_p]
        sim = co * inv_norm[sl][:, None] * inv_norm[None, :]
        if not include_self_loops:
            sim[rows, i * block_size + rows] = 0.0
        sim = torch.where(sim >= min_similarity, sim, 0.0)
        scores, idx = retrieval.top_k(sim, k)
        ids = torch.where((scores > 0) & (idx < P), idx.to(torch.int32), PAD_ID)
        ids_out[sl] = ids
        scores_out[sl] = torch.where(ids != PAD_ID, scores, 0.0)
    return Graph(ids_out[:P].contiguous(), scores_out[:P].contiguous())



def symmetrize(graph: Graph) -> Graph:
    """Make the top-K graph symmetric (if p lists q, q lists p), keeping the
    larger of the two directed weights, through a dense [P, P] max."""
    P, D = graph.nbr_ids.shape
    dev = graph.nbr_ids.device
    valid = graph.nbr_ids != PAD_ID
    safe = torch.where(valid, graph.nbr_ids, 0).long()
    rows = torch.arange(P, device=dev)[:, None].expand(P, D)
    w = torch.where(valid, graph.nbr_weights, 0.0)
    dense = torch.zeros(P * P, dtype=torch.float32, device=dev)
    dense.scatter_reduce_(0, (rows * P + safe).reshape(-1), w.reshape(-1), "amax", include_self=True)
    dense = dense.view(P, P)
    dense = torch.maximum(dense, dense.T)
    scores, idx = retrieval.top_k(dense, D)
    ids = torch.where(scores > 0, idx.to(torch.int32), PAD_ID)
    return Graph(ids.contiguous(), torch.where(ids != PAD_ID, scores, 0.0).contiguous())
