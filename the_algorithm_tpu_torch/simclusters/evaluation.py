"""Offline cluster-quality evaluation: the evaluation-as-testing jobs.

Counterpart of ``the_algorithm_tpu/simclusters/evaluation.py``
(``scalding/{ClusterEvaluation,BipartiteClusterEvaluation,
CompareClusters}.scala`` and ``EigenVectorsForSparseSymmetric.scala``):
per-cluster neighbourhood quality, bipartite engagement agreement, the
agreement of two KnownFor versions, and the top eigenvectors of the sparse
similarity graph by subspace power iteration.

``evaluate_clusters``' three per-cluster sums are one ``segment.scatter_sum``
(one sort, one run collapse of k = 3). ``top_eigenvectors``' matvec gathers
its [U, k] block at the graph's neighbours with one ``row_gather`` launch an
iteration (k·4-byte rows). Its start is a draw of a ``torch.Generator`` on
the CPU (JAX draws from ``PRNGKey(seed)``, which torch cannot reproduce):
compare converged eigenvalues and the projector Q·Qᵀ, since QR's column
signs differ between LAPACK and cuSOLVER. ``compare_known_for`` and
``bipartite_engagement_eval`` are host code.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.ops import segment
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.simclusters.known_for import Graph, KnownFor


class ClusterQuality(NamedTuple):
    """Per-cluster neighbourhood quality (``ClusterEvaluation.scala``)."""

    sizes: torch.Tensor  # [C] member counts
    in_cluster_weight_fraction: torch.Tensor  # [C] Σ within-cluster edge w / Σ all
    mean_in_cluster_similarity: torch.Tensor  # [C]


def evaluate_clusters(graph: Graph, kf: KnownFor, num_clusters: int) -> ClusterQuality:
    """How much of each member's edge weight stays inside its cluster."""
    valid = graph.nbr_ids != PAD_ID
    safe = jax_rows(torch.where(valid, graph.nbr_ids, 0), kf.cluster.shape[0])
    nbr_cluster = torch.where(valid, kf.cluster[safe], -1)
    own = kf.cluster  # [U]
    w = torch.where(valid, graph.nbr_weights, 0.0)

    in_cluster = (nbr_cluster == own[:, None]) & (own >= 0)[:, None]
    w_in = torch.sum(torch.where(in_cluster, w, 0.0), dim=1)
    w_all = torch.sum(w, dim=1)
    frac = torch.where(w_all > 0, w_in / torch.clamp(w_all, min=1e-30), 0.0)
    n_in = torch.sum(in_cluster, dim=1)
    sim_mean = torch.where(n_in > 0, w_in / torch.clamp(n_in, min=1), 0.0)

    assigned = own >= 0
    sizes, frac_sum, sim_sum = segment.scatter_sum(
        torch.where(assigned, own, 0), assigned.to(torch.float32), torch.where(assigned, frac, 0.0),
        torch.where(assigned, sim_mean, 0.0), size=num_clusters)
    denom = torch.clamp(sizes, min=1.0)
    return ClusterQuality(sizes, frac_sum / denom, sim_sum / denom)


def compare_known_for(a: KnownFor, b: KnownFor, num_clusters: int) -> Dict[str, float]:
    """≡ ``CompareClusters.scala``: agreement of two assignments — coverage
    and purity both ways (label ids are arbitrary across runs)."""
    a_c = host_array(a.cluster)
    b_c = host_array(b.cluster)
    both = (a_c >= 0) & (b_c >= 0)
    if both.sum() == 0:
        return {"coverage": 0.0, "purity_ab": 0.0, "purity_ba": 0.0}

    def purity(x, y):
        out = 0.0
        for c in np.unique(x[both]):
            members = y[both][x[both] == c]
            out += np.bincount(members).max()
        return out / both.sum()

    return {
        "coverage": float(both.mean()),
        "purity_ab": float(purity(a_c, b_c)),
        "purity_ba": float(purity(b_c, a_c)),
    }


def bipartite_engagement_eval(user_cluster, eng_user_ids, eng_tweet_ids, tweet_cluster) -> float:
    """≡ ``BipartiteClusterEvaluation.scala``: the share of engagements whose
    user cluster is the engaged tweet's cluster (ids read as JAX's gather
    reads them: clamped into range)."""
    uc_all, tc_all = host_array(user_cluster), host_array(tweet_cluster)
    uc = uc_all[np.clip(host_array(eng_user_ids), 0, len(uc_all) - 1)]
    tc = tc_all[np.clip(host_array(eng_tweet_ids), 0, len(tc_all) - 1)]
    valid = (uc >= 0) & (tc >= 0)
    agree = np.sum((uc == tc) & valid)
    return float(np.float32(agree) / np.float32(max(valid.sum(), 1)))


def top_eigenvectors(graph: Graph, k: int, iterations: int = 50, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of the symmetric sparse adjacency by subspace (block
    power) iteration with QR re-orthonormalization → (eigenvalues [k],
    vectors [U, k]). The start is drawn on the CPU from a generator seeded
    with ``seed``, so a card and the CPU start alike."""
    U = graph.num_nodes
    valid = graph.nbr_ids != PAD_ID
    safe = jax_rows(torch.where(valid, graph.nbr_ids, 0), U).to(torch.int32)
    w = torch.where(valid, graph.nbr_weights, 0.0)

    def matvec(v):  # [U, k]
        (gathered,) = row_gather(safe, v.contiguous())  # [U, D, k]
        return torch.einsum("ud,udk->uk", w, gathered)

    q = torch.randn((U, k), generator=torch.Generator().manual_seed(seed), dtype=torch.float32).to(w.device)
    q, _ = torch.linalg.qr(q)
    for _ in range(iterations):
        q, _ = torch.linalg.qr(matvec(q))
    z = matvec(q)
    return torch.einsum("uk,uk->k", q, z), q
