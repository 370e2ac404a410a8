"""SimClusters sparse embeddings as fixed-capacity tensors.

Counterpart of ``the_algorithm_tpu/ops/sparse.py`` (the part the SANN scan
needs). An embedding is a pair of tensors — ``ids: int32[..., K]`` (padding is
:data:`PAD_ID`) and ``scores: float32[..., K]`` (0 in padding) —
score-descending. Every op works over any leading batch shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAD_ID = 2**31 - 1  # int32 max: sorts after every real id


class SparseEmbedding(NamedTuple):
    """Fixed-capacity sparse embedding: (ids, scores), score-descending."""

    ids: torch.Tensor  # [..., K] int32, PAD_ID in empty slots
    scores: torch.Tensor  # [..., K] float32, 0.0 in empty slots

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        return self.ids != PAD_ID


def make(ids: torch.Tensor, scores: torch.Tensor, capacity: int) -> SparseEmbedding:
    """Keep the top-``capacity`` entries by score, score-descending, PAD fill.

    Ties keep their input order, as ``lax.top_k`` does in the JAX package, so
    both packages accumulate a truncated embedding's clusters in one order.
    """
    ids = ids.to(torch.int32)
    scores = scores.to(torch.float32)
    k = min(capacity, ids.shape[-1])
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores = top_scores[..., :k]
    top_ids = torch.take_along_dim(ids, idx[..., :k], dim=-1)
    pad = capacity - k
    if pad > 0:
        top_ids = torch.cat([top_ids, top_ids.new_full(top_ids.shape[:-1] + (pad,), PAD_ID)], -1)
        top_scores = torch.cat([top_scores, top_scores.new_zeros(top_scores.shape[:-1] + (pad,))], -1)
    top_scores = torch.where(top_ids == PAD_ID, 0.0, top_scores)
    return SparseEmbedding(top_ids, top_scores)


def truncate(emb: SparseEmbedding, size: int) -> SparseEmbedding:
    """Keep top-``size`` by score (``SimClustersEmbedding.truncate:377``)."""
    return make(emb.ids, emb.scores, size)


def sum_of_squares(emb: SparseEmbedding) -> torch.Tensor:
    return torch.sum(emb.scores * emb.scores, dim=-1)


def l2_norm(emb: SparseEmbedding) -> torch.Tensor:
    """``normArray``: sqrt(Σ s²)."""
    return torch.sqrt(sum_of_squares(emb))


def log_norm(emb: SparseEmbedding) -> torch.Tensor:
    """``logNormArray``: log(Σ s² + 1)."""
    return torch.log(sum_of_squares(emb) + 1.0)
