"""ANN indexes: brute force and clustered scan behind one typed API.

Counterpart of ``the_algorithm_tpu/ann_lib/index.py``
(``ann/src/main/scala/com/twitter/ann/common/Api.scala:24-149``: the
``Queryable`` / ``Appendable`` index traits, and ``common/Metric.scala:
88-222``: L2, cosine, inner product):

  - :class:`BruteForceIndex`: the exact scan, a matmul and ``retrieval.
    top_k`` (the JAX package computes it outside any Pallas kernel); the
    quality ceiling every loadtest compares against;
  - :class:`ClusteredScanIndex`: IVF: k-means cells, probe the top-P cells
    nearest a query, scan only their members, whose vectors one
    ``row_gather`` launch reads (D·4-byte rows).

Both buffer appends on the host and put their tables on a device at the
next query: the card unless the constructor names another device. k-means
starts from the index's own ``torch.Generator`` draw (JAX draws with
``jax.random.choice``); :meth:`ClusteredScanIndex.from_jax` carries a built
JAX index's centroids and cells over, so that queries can be held equal.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array, resolve
from the_algorithm_tpu_torch.ops.gather import row_gather
from the_algorithm_tpu_torch.ops.retrieval import top_k


class Metric(enum.Enum):
    L2 = "l2"
    COSINE = "cosine"
    INNER_PRODUCT = "inner_product"


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)


def _scores(queries: torch.Tensor, items: torch.Tensor, metric: Metric) -> torch.Tensor:
    """[Q, N] scores of [Q, D] queries against [N, D] items; higher is
    closer for every metric (L2 negated)."""
    if metric == Metric.L2:
        # ||q - x||² = ||q||² - 2qx + ||x||²; the scan needs only the ranking
        qn = torch.sum(queries * queries, dim=-1, keepdim=True)
        xn = torch.sum(items * items, dim=-1)
        return -(qn - 2 * queries @ items.T + xn[None, :])
    if metric == Metric.COSINE:
        return _unit(queries) @ _unit(items).T
    return queries @ items.T  # inner product


def _scores_rows(queries: torch.Tensor, cand: torch.Tensor, metric: Metric) -> torch.Tensor:
    """[Q, M] scores of each of [Q, D] queries against its own [Q, M, D]
    candidates (the JAX package's ``vmap`` of :func:`_scores`)."""
    if metric == Metric.L2:
        qn = torch.sum(queries * queries, dim=-1, keepdim=True)
        xn = torch.sum(cand * cand, dim=-1)
        return -(qn - torch.einsum("qd,qmd->qm", 2 * queries, cand) + xn)
    if metric == Metric.COSINE:
        return torch.einsum("qd,qmd->qm", _unit(queries), _unit(cand))
    return torch.einsum("qd,qmd->qm", queries, cand)


def _distance_from_score(score: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Back to the reference's distance convention (Metric.scala)."""
    if metric == Metric.L2:
        return torch.sqrt(torch.clamp(-score, min=0.0))
    if metric == Metric.COSINE:
        return 1.0 - score  # cosine distance
    return -score  # higher IP = closer ⇒ negative "distance"


class BruteForceIndex:
    """The exact scan over all items: one matmul and a top-k a query batch."""

    def __init__(self, dim: int, metric: Metric = Metric.COSINE, *, device=None):
        self.dim = dim
        self.metric = metric
        self.device = resolve(device, "BruteForceIndex")
        self._vectors = np.zeros((0, dim), np.float32)
        self._ids = np.zeros((0,), np.int64)
        self._device: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __len__(self) -> int:
        return self._vectors.shape[0]

    # Appendable
    def append(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32).reshape(-1, self.dim)
        self._vectors = np.concatenate([self._vectors, vectors])
        self._ids = np.concatenate([self._ids, np.asarray(ids, np.int64)])
        self._device = None  # uploaded again at the next query

    def _dev(self):
        if self._device is None:
            self._device = (torch.from_numpy(self._vectors).to(self.device),
                            torch.from_numpy(self._ids).to(self.device))
        return self._device

    # Queryable
    def query(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """[Q, dim] → (ids [Q, k], distances [Q, k])."""
        items, ids = self._dev()
        q = torch.from_numpy(np.asarray(queries, np.float32).reshape(-1, self.dim)).to(self.device)
        top, idx = top_k(_scores(q, items, self.metric), min(k, len(self)))
        return host_array(ids[idx]), host_array(_distance_from_score(top, self.metric))


class ClusteredScanIndex:
    """IVF: k-means cells, then probe and scan. The sub-linear engine."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.COSINE,
        n_clusters: int = 64,
        n_probes: int = 8,
        kmeans_iters: int = 10,
        seed: int = 0,
        *,
        device=None,
    ):
        self.dim = dim
        self.metric = metric
        self.n_clusters = n_clusters
        self.n_probes = min(n_probes, n_clusters)
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.device = resolve(device, "ClusteredScanIndex")
        self._vectors = np.zeros((0, dim), np.float32)
        self._ids = np.zeros((0,), np.int64)
        self._built = False

    def __len__(self) -> int:
        return self._vectors.shape[0]

    def append(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32).reshape(-1, self.dim)
        self._vectors = np.concatenate([self._vectors, vectors])
        self._ids = np.concatenate([self._ids, np.asarray(ids, np.int64)])
        self._built = False

    def _cells(self, assign: np.ndarray) -> np.ndarray:
        """[n_clusters, cap] member rows (-1 pad) from each vector's cell,
        members in index order; cap the fullest cell's count."""
        counts = np.bincount(assign, minlength=self.n_clusters)
        order = np.argsort(assign, kind="stable")
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        members = np.full((self.n_clusters, max(int(counts.max()), 1)), -1, np.int64)
        members[assign[order], np.arange(order.shape[0]) - start[assign[order]]] = order
        return members

    def _load(self, centroids: torch.Tensor, members: np.ndarray) -> None:
        self._centroids = centroids.to(self.device)
        self._members = torch.from_numpy(members.astype(np.int64)).to(self.device)
        self._device_vectors = torch.from_numpy(self._vectors).to(self.device)
        self._device_ids = torch.from_numpy(self._ids).to(self.device)
        self._built = True

    def build(self) -> None:
        """k-means on the device, then the members bucketed into cells."""
        x = torch.from_numpy(self._vectors).to(self.device)
        n = x.shape[0]
        pick = torch.randperm(n, generator=torch.Generator().manual_seed(self.seed))[:self.n_clusters]
        c = x[pick.to(self.device)]
        for _ in range(self.kmeans_iters):
            assign = torch.argmax(_scores(x, c, Metric.L2), dim=1)  # [N] (−dist²)
            onehot = torch.nn.functional.one_hot(assign, self.n_clusters).to(torch.float32)
            counts = torch.clamp(onehot.sum(0), min=1.0)
            c = (onehot.T @ x) / counts[:, None]
        self._load(c, self._cells(host_array(torch.argmax(_scores(x, c, Metric.L2), dim=1))))

    @classmethod
    def from_jax(cls, jax_index, *, device=None) -> "ClusteredScanIndex":
        """A port index over a built JAX ``ClusteredScanIndex``'s vectors,
        ids, centroids and cells (read as host arrays)."""
        out = cls(jax_index.dim, Metric(jax_index.metric.value), jax_index.n_clusters, jax_index.n_probes,
                  jax_index.kmeans_iters, jax_index.seed, device=device)
        out.append(np.asarray(jax_index._ids), np.asarray(jax_index._vectors))
        out._load(torch.from_numpy(np.asarray(jax_index._centroids, np.float32)), np.asarray(jax_index._members))
        return out

    def query(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self._built:
            self.build()
        q = torch.from_numpy(np.asarray(queries, np.float32).reshape(-1, self.dim)).to(self.device)
        Q = q.shape[0]
        # the cells by centroid proximity in the query metric
        _, probe = top_k(_scores(q, self._centroids, self.metric), self.n_probes)  # [Q, P]
        cand_rows = self._members[probe].reshape(Q, -1)  # [Q, P·cap]
        valid = cand_rows >= 0
        safe = torch.where(valid, cand_rows, 0)
        (cand_vecs,) = row_gather(safe.to(torch.int32), self._device_vectors)  # [Q, P·cap, D]
        score = torch.where(valid, _scores_rows(q, cand_vecs, self.metric), -torch.inf)
        top, idx = top_k(score, min(k, score.shape[1]))
        ids = torch.take_along_dim(safe, idx, dim=1)
        out_ids = torch.where(torch.isfinite(top), self._device_ids[ids], -1)
        return host_array(out_ids), host_array(_distance_from_score(top, self.metric))
