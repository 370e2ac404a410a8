"""Retrieval-quality metrics.

Counterpart of ``recall_at_k`` in ``the_algorithm_tpu/training/metrics.py``.
"""

from __future__ import annotations

import torch


def recall_at_k(
    retrieved_ids: torch.Tensor,  # [Q, K] (PAD allowed)
    relevant_ids: torch.Tensor,  # [Q, R] ground-truth (PAD allowed)
    pad_id: int,
) -> torch.Tensor:
    """Mean fraction of relevant items appearing in the retrieved top-K —
    the ANN loadtest recall definition (``ann/.../LoadTestRecorder.scala:16-60``)."""
    rel_valid = relevant_ids != pad_id
    hit = (retrieved_ids[:, :, None] == relevant_ids[:, None, :]) & rel_valid[:, None, :]
    hits_per_query = torch.sum(torch.any(hit, dim=1), dim=-1)
    n_relevant = torch.sum(rel_valid, dim=-1)
    per_query = hits_per_query / torch.clamp(n_relevant, min=1)
    has_rel = n_relevant > 0
    return torch.sum(torch.where(has_rel, per_query, 0.0)) / torch.clamp(
        torch.sum(has_rel), min=1
    )
