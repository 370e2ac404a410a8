"""SimClusters-ANN in plain PyTorch: the cosine scan of
``ApproximateCosineSimilarity.scala`` over a cluster → top-M tweet index.

For each query: the tweets of its N clusters' index rows (PAD slots
skipped); per tweet, dot = Σ tweetScore · queryScore and norm = Σ
tweetScore² over the query's clusters that hold it; cosine = dot / (‖q‖ ·
√norm); the best X by cosine. Sums run in float64 by default. ``dtype`` of
bfloat16 gives the control: every product, sum and division in bf16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAD_ID = 2**31 - 1


class Candidates(NamedTuple):
    """Every candidate of a block of queries, sorted by (query, tweet):
    ``keys`` = query · (PAD_ID + 1) + tweet, ``scores`` their cosines."""

    keys: torch.Tensor  # [n] int64
    scores: torch.Tensor  # [n] float64 (or the control's dtype)


def candidates(index_ids, index_scores, q_ids, q_scores, dtype=torch.float64) -> Candidates:
    """All candidates of queries ``q_ids`` / ``q_scores`` [Qb, N]."""
    Qb, N = q_ids.shape
    rows = index_ids[q_ids.long()]  # [Qb, N, M]
    ts = index_scores[q_ids.long()].to(dtype)
    qs = q_scores.to(dtype)
    valid = rows != PAD_ID
    qrow = torch.arange(Qb, device=rows.device)[:, None, None].expand_as(rows)
    keys = (qrow.long() * (PAD_ID + 1) + rows.long())[valid]
    dot_part = (ts * qs[:, :, None])[valid]
    norm_part = (ts * ts)[valid]
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    dot = torch.zeros(uniq.numel(), dtype=dtype, device=rows.device).index_add_(0, inv, dot_part)
    norm = torch.zeros(uniq.numel(), dtype=dtype, device=rows.device).index_add_(0, inv, norm_part)
    q_l2 = torch.sqrt((qs * qs).sum(dim=1))
    cos = dot / (q_l2[uniq // (PAD_ID + 1)] * torch.sqrt(norm))
    return Candidates(uniq, cos)


def top(cands: Candidates, Qb: int, X: int):
    """Each query's best X: (ids [Qb, X] int64, scores [Qb, X]), PAD_ID /
    -inf past the last candidate; among equal scores the lower id first."""
    q = cands.keys // (PAD_ID + 1)
    tweet = cands.keys % (PAD_ID + 1)
    order = torch.sort(-cands.scores, stable=True).indices  # keys ascending within equal scores
    order = order[torch.sort(q[order], stable=True).indices]
    qo = q[order]
    start = torch.searchsorted(qo, torch.arange(Qb, device=qo.device))
    rank = torch.arange(qo.numel(), device=qo.device) - start[qo]
    keep = rank < X
    ids = torch.full((Qb, X), PAD_ID, dtype=torch.int64, device=qo.device)
    scores = torch.full((Qb, X), -torch.inf, dtype=cands.scores.dtype, device=qo.device)
    ids[qo[keep], rank[keep]] = tweet[order][keep]
    scores[qo[keep], rank[keep]] = cands.scores[order][keep]
    return ids, scores
