"""Producer embeddings: Ṽ = Aᵀ·U.

Counterpart of ``the_algorithm_tpu/simclusters/producer_embeddings.py``
(``ProducerEmbeddingsFromInterestedIn.scala:15-230``): the producer×cluster
matrix is the product of the user→producer engagement matrix with the
user→cluster InterestedIn matrix (``getProducerClusterEmbedding:592``,
``legacyMultiplyMatrices``), thresholded at cosine ≥ 0.01
(``cosineSimilarityThreshold:544``), then written as top-K clusters per
producer and top-K producers per cluster.

The 12000-reducer MapReduce multiply becomes one deterministic scatter of
the (user, adjacency-slot, interest-slot) triples into a dense [P, C]:
their flat int32 keys ``p·C + c`` in one stable sort, then one run-collapse
launch over the sorted [1, U·D·K] row (``ops/segment.scatter_sum``), each
(p, c) total written once; no float atomic. P·C must stay below 2**31, as
JAX's int32 key does. Both top-K sweeps go through ``retrieval.top_k``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from the_algorithm_tpu_torch.ops.retrieval import top_k
from the_algorithm_tpu_torch.ops.segment import scatter_sum
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding


class ProducerEmbeddings(NamedTuple):
    by_producer: SparseEmbedding  # [P, Kp] top clusters per producer
    cluster_top_producers_ids: torch.Tensor  # [C, Kc] producer ids per cluster
    cluster_top_producers_scores: torch.Tensor  # [C, Kc]


def producer_cluster_matrix(
    producer_ids: torch.Tensor,  # [U, D] int32, PAD_ID padded
    edge_weights: torch.Tensor,  # [U, D] float32 — producer-normalized scores
    interest_ids: torch.Tensor,  # [U, K] int32 cluster ids, PAD_ID padded
    interest_scores: torch.Tensor,  # [U, K] float32 — cluster-normalized
    num_producers: int,
    num_clusters: int,
) -> torch.Tensor:
    """Dense [P, C] = Σ_u w(u,p)·i(u,c); the ``legacyMultiplyMatrices`` core."""
    if num_producers * num_clusters >= 2**31:
        raise ValueError(f"[{num_producers}, {num_clusters}] needs keys p·C + c past int32")
    e_valid = producer_ids != PAD_ID
    i_valid = interest_ids != PAD_ID
    w = torch.where(e_valid, edge_weights, 0.0)
    s = torch.where(i_valid, interest_scores, 0.0)
    contrib = w[:, :, None] * s[:, None, :]  # [U, D, K]
    p_idx = torch.where(e_valid, producer_ids, 0)[:, :, None]
    c_idx = torch.where(i_valid, interest_ids, 0)[:, None, :]
    keys = p_idx * num_clusters + c_idx  # int32, as JAX's
    (dense,) = scatter_sum(keys, contrib, size=num_producers * num_clusters)
    return dense.reshape(num_producers, num_clusters)


def producer_embeddings_from_interested_in(
    producer_ids: torch.Tensor,
    edge_weights: torch.Tensor,
    interest_ids: torch.Tensor,
    interest_scores: torch.Tensor,
    *,
    num_producers: int,
    num_clusters: int,
    top_k_clusters: int = 50,  # topKClustersToKeep
    top_k_producers: int = 100,  # topKUsersToKeep
    threshold: float = 0.01,  # cosineSimilarityThreshold:544
) -> ProducerEmbeddings:
    dense = producer_cluster_matrix(producer_ids, edge_weights, interest_ids, interest_scores,
                                    num_producers, num_clusters)
    dense = torch.where(dense >= threshold, dense, 0.0)

    # top clusters per producer
    p_scores, p_cids = top_k(dense, min(top_k_clusters, num_clusters))
    p_ids = torch.where(p_scores > 0, p_cids.to(torch.int32), PAD_ID)
    p_scores = torch.where(p_scores > 0, p_scores, 0.0)

    # top producers per cluster
    c_scores, c_pids = top_k(dense.T.contiguous(), min(top_k_producers, num_producers))
    c_ids = torch.where(c_scores > 0, c_pids.to(torch.int32), PAD_ID)
    c_scores = torch.where(c_scores > 0, c_scores, 0.0)
    return ProducerEmbeddings(SparseEmbedding(p_ids, p_scores), c_ids, c_scores)
