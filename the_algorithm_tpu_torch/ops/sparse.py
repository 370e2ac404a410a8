"""SimClusters sparse embeddings as fixed-capacity tensors.

Counterpart of ``the_algorithm_tpu/ops/sparse.py``. An embedding is a pair
of tensors — ``ids: int32[..., K]`` (padding is :data:`PAD_ID`) and
``scores: float32[..., K]`` (0 in padding) — score-descending. Every op works
over any leading batch shape, broadcast between its two arguments: where the
JAX package writes an op for one pair and ``vmap``s it, the port gives the
batch dimensions to the tensors (``pairwise_matrix`` broadcasts [Na] against
[Nb]). The pairwise similarities are K×K id-equality masks, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAD_ID = 2**31 - 1  # int32 max: sorts after every real id
DEFAULT_EXPONENT = 0.3  # SimClustersEmbedding.scala:454


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


def exp_scaled_norm(emb: SparseEmbedding, exponent: float = DEFAULT_EXPONENT) -> torch.Tensor:
    """``expScaledNormArray``: (Σ s²)^exponent."""
    return torch.pow(sum_of_squares(emb), exponent)


# -- pairwise similarities (CosineSimilarityUtil.scala) -------------------------


def _match_matrix(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """[..., Ka, Kb] float mask of id equality (PAD never matches)."""
    eq = a.ids[..., :, None] == b.ids[..., None, :]
    both_valid = a.valid_mask()[..., :, None] & b.valid_mask()[..., None, :]
    return (eq & both_valid).float()


def _matched(a: SparseEmbedding, b: SparseEmbedding) -> tuple:
    """(b's score at each a-slot, a's score at each b-slot), 0 where unmatched."""
    m = _match_matrix(a, b)
    return (m * b.scores[..., None, :]).sum(-1), (m * a.scores[..., :, None]).sum(-2)


def dot(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """Sparse dot product (``dotProductForSortedClusterAndScores`` analog)."""
    return torch.sum(a.scores * (_match_matrix(a, b) * b.scores[..., None, :]).sum(-1), dim=-1)


def _scaled(d: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    return torch.where(denom > 0, d / torch.clamp(denom, min=1e-30), 0.0)


def cosine(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    return _scaled(dot(a, b), l2_norm(a) * l2_norm(b))


def log_norm_cosine(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """``logNormCosineSimilarity``: dot of log-norm-scaled vectors."""
    return _scaled(dot(a, b), log_norm(a) * log_norm(b))


def exp_scaled_cosine(a: SparseEmbedding, b: SparseEmbedding, exponent: float = DEFAULT_EXPONENT) -> torch.Tensor:
    """``expScaledCosineSimilarity``: dot of (Σs²)^exp-scaled vectors."""
    return _scaled(dot(a, b), exp_scaled_norm(a, exponent) * exp_scaled_norm(b, exponent))


def jaccard(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """Set jaccard over cluster-id sets (``jaccardSimilarity``)."""
    intersect = torch.sum(_match_matrix(a, b), dim=(-2, -1))
    union = a.valid_mask().sum(-1) + b.valid_mask().sum(-1) - intersect
    return torch.where(union > 0, intersect / torch.clamp(union, min=1.0), 0.0)


def fuzzy_jaccard(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """Σ min(sa, sb) / Σ max(sa, sb) over the id union (``fuzzyJaccardSimilarity``)."""
    b_in_a, a_in_b = _matched(a, b)
    num = torch.sum(torch.minimum(a.scores, b_in_a) * (b_in_a > 0), dim=-1)
    den = (torch.sum(torch.maximum(a.scores, b_in_a), dim=-1)  # all a-slots (union side a)
           + torch.sum(torch.where(a_in_b > 0, 0.0, b.scores), dim=-1))  # b-only slots
    return _scaled(num, den)


def euclidean(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """sqrt Σ_union (sa - sb)² (``euclideanDistance``)."""
    b_in_a, a_in_b = _matched(a, b)
    d_a = torch.sum((a.scores - b_in_a) ** 2, dim=-1)  # a slots (incl. matched)
    d_b = torch.sum(torch.where(a_in_b > 0, 0.0, b.scores ** 2), dim=-1)  # b-only slots
    return torch.sqrt(d_a + d_b)


def manhattan(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """Σ_union |sa - sb| (``manhattanDistance``)."""
    b_in_a, a_in_b = _matched(a, b)
    d_a = torch.sum(torch.abs(a.scores - b_in_a), dim=-1)
    d_b = torch.sum(torch.where(a_in_b > 0, 0.0, torch.abs(b.scores)), dim=-1)
    return d_a + d_b


# -- monoid ----------------------------------------------------------------------


def add(a: SparseEmbedding, b: SparseEmbedding, capacity: int) -> SparseEmbedding:
    """Merge-add two embeddings, truncating to top-``capacity`` by score.

    The ``SimClustersEmbeddingMonoid`` analog: duplicate cluster ids sum.
    Concat → stable sort by id → sum each run into its first slot → top-K.
    """
    ids = torch.cat([a.ids, b.ids], dim=-1)
    scores = torch.cat([a.scores, b.scores], dim=-1)
    ids, order = torch.sort(ids, dim=-1, stable=True)
    scores = torch.take_along_dim(scores, order, dim=-1)
    new_run = torch.ones_like(ids, dtype=torch.bool)
    new_run[..., 1:] = ids[..., 1:] != ids[..., :-1]
    seg = torch.cumsum(new_run.long(), dim=-1) - 1  # run index of each slot
    summed = torch.zeros_like(scores).scatter_add_(-1, seg, scores)
    rep_ids = torch.where(new_run, ids, PAD_ID)
    rep_scores = torch.where(new_run & (rep_ids != PAD_ID), torch.gather(summed, -1, seg), 0.0)
    return make(rep_ids, rep_scores, capacity)


def scale(emb: SparseEmbedding, factor: float) -> SparseEmbedding:
    return SparseEmbedding(emb.ids, emb.scores * factor)


def pairwise_matrix(fn, a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """[..., Na, Nb] matrix of any pairwise similarity op between a [..., Na, K]
    and a [..., Nb, K] batch (the listwise block behind the RSX similarity
    kinds, ``SimClustersEmbeddingPairScoreStore.build*Store``)."""
    return fn(SparseEmbedding(a.ids[..., :, None, :], a.scores[..., :, None, :]),
              SparseEmbedding(b.ids[..., None, :, :], b.scores[..., None, :, :]))
