"""Pluggable clustering methods for embedding spaces.

Counterpart of ``the_algorithm_tpu/simclusters/clustering.py``
(``simclusters_v2/common/clustering/``: ``ClusteringMethod`` with connected
components, Louvain and largest dimension, and the medoid and max-fav
representatives). The methods work on a dense [N, N] similarity matrix (N
up to a few thousand a call, as the reference clusters one user's
neighbourhood).

Connected components is min-label propagation on the device, one flag read
back a round; Louvain is the JAX package's host numpy, copied; the
representatives take a per-cluster max with ``scatter_reduce_`` (``amax``).
"""

from __future__ import annotations

import numpy as np
import torch

from the_algorithm_tpu_torch.ops import sparse
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding


SIM_BLOCK = 1 << 27  # K×K match entries a block of rows of the similarity matrix holds at once


def similarity_matrix(embeddings: SparseEmbedding) -> torch.Tensor:
    """[N, N] cosine similarity (``SimilarityFunctions.simClustersCosineSimilarity``):
    each pair's K×K matches as JAX sums them, in blocks of rows that hold
    at most :data:`SIM_BLOCK` match entries."""
    N, K = embeddings.ids.shape
    rows = max(1, SIM_BLOCK // max(N * K * K, 1))
    return torch.cat([sparse.pairwise_cosine_matrix(
        SparseEmbedding(embeddings.ids[i:i + rows], embeddings.scores[i:i + rows]), embeddings)
        for i in range(0, N, rows)]) if N else sparse.pairwise_cosine_matrix(embeddings, embeddings)


def connected_components(sim: torch.Tensor, threshold: float) -> torch.Tensor:
    """Cluster = connected component of the ≥threshold similarity graph
    (``ConnectedComponentsClusteringMethod.scala``): every node takes the
    least label among its neighbours until no label moves. Labels are the
    least node index of each component (int64)."""
    n = sim.shape[0]
    adj = (sim >= threshold) | torch.eye(n, dtype=torch.bool, device=sim.device)
    labels = torch.arange(n, device=sim.device)
    while True:
        new = torch.minimum(labels, torch.where(adj, labels[None, :], n).amin(dim=1))
        moved = bool((new != labels).any())  # the one flag a round
        labels = new
        if not moved:
            return labels


def largest_dimension(embeddings: SparseEmbedding) -> torch.Tensor:
    """Cluster by each embedding's max-score cluster id
    (``LargestDimensionClusteringMethod.scala``); the first slot of equal maxima."""
    best = torch.argmax(embeddings.scores, dim=-1)
    return torch.take_along_dim(embeddings.ids, best[..., None], dim=-1)[..., 0]


def louvain(sim: np.ndarray, threshold: float = 0.0, max_passes: int = 10) -> np.ndarray:
    """Greedy modularity maximization (one-level Louvain,
    ``LouvainClusteringMethod.scala``). Host numpy: the greedy sweep is
    sequential by nature and N is small a call."""
    w = np.where(sim >= threshold, np.maximum(sim, 0.0), 0.0)
    np.fill_diagonal(w, 0.0)
    n = w.shape[0]
    m2 = w.sum()  # 2m
    if m2 <= 0:
        return np.arange(n)
    k = w.sum(axis=1)
    labels = np.arange(n)
    for _ in range(max_passes):
        moved = False
        for i in range(n):
            own = labels[i]
            # gain of moving i to neighbour community c:
            #   Σ_in(i→c)/m - k_i·Σ_tot(c)/(2m²)  (standard ΔQ up to consts)
            best_c, best_gain = own, 0.0
            labels[i] = -1  # remove i
            for c in np.unique(labels[w[i] > 0]):
                if c < 0:
                    continue
                in_c = labels == c
                ki_in = w[i, in_c].sum()
                tot_c = k[in_c].sum()
                gain = ki_in / m2 - (k[i] * tot_c) / (m2 * m2)
                if gain > best_gain + 1e-12:
                    best_gain, best_c = gain, c
            labels[i] = best_c
            if best_c != own:
                moved = True
        if not moved:
            break
    # relabel compactly
    _, compact = np.unique(labels, return_inverse=True)
    return compact


def _best_of_cluster(labels: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Each member's cluster's largest value, from 0 up (JAX's
    ``zeros(n).at[labels].max(values)[labels]``)."""
    labels = labels.to(torch.int64)
    best = torch.zeros(labels.shape[0], dtype=values.dtype, device=values.device)
    best.scatter_reduce_(0, labels, values, reduce="amax", include_self=True)
    return best[labels]


def medoid_representative(embeddings: SparseEmbedding, labels: torch.Tensor) -> torch.Tensor:
    """Per cluster, the member maximizing summed in-cluster similarity
    (``MedoidRepresentativeSelectionMethod.scala``): [N] bool, True where
    the member is its cluster's medoid."""
    sim = similarity_matrix(embeddings)
    same = labels[:, None] == labels[None, :]
    score = torch.sum(torch.where(same, sim, 0.0), dim=1)  # [N]
    return score >= _best_of_cluster(labels, score) - 1e-9


def max_weight_representative(labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per cluster, the member with the largest external weight (e.g. fav
    count): ``MaxFavScoreRepresentativeSelectionMethod``."""
    return weights >= _best_of_cluster(labels, weights) - 1e-9
