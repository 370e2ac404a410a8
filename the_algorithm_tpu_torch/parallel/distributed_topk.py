"""Distributed top-K: per-shard scan + cross-shard merge.

Counterpart of ``the_algorithm_tpu/parallel/distributed_topk.py``
(Earlybird's partition scatter-gather, ``earlybird_root/``): every shard
takes a local top-K over the entries it owns, the K winners are gathered
over the ``model`` axis, and a final top-K picks the global winners —
correct because the global top-K is always inside the union of the
per-shard top-Ks. Both top-Ks go through ``retrieval.top_k``, so among
equal scores the lower index wins, and after the gather (shard order, then
index) the lower shard: the order of ``lax.top_k``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from the_algorithm_tpu_torch.core.mesh import MODEL_AXIS, Mesh
from the_algorithm_tpu_torch.ops.retrieval import top_k


def _merge(mesh: Mesh, local_scores: torch.Tensor, local_payload: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    all_scores = mesh.all_gather(local_scores, MODEL_AXIS, dim=-1)
    all_payload = mesh.all_gather(local_payload, MODEL_AXIS, dim=-1)
    top_scores, top_idx = top_k(all_scores, k)
    return top_scores, torch.take_along_dim(all_payload, top_idx, dim=-1)


def sharded_topk(mesh: Mesh, scores: torch.Tensor, payload: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of a model-sharded score axis: ``scores`` and
    ``payload`` (e.g. candidate ids) are this rank's [..., N/E] block of the
    last axis; returns [..., k] scores and payload, the same on every rank."""
    local_scores, local_idx = top_k(scores, k)
    return _merge(mesh, local_scores, torch.take_along_dim(payload, local_idx, dim=-1), k)


def sharded_argtopk_batched(mesh: Mesh, score_fn: Callable[[torch.Tensor], torch.Tensor],
                            items: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score this rank's block of a model-sharded [N, ...] item table with
    ``score_fn`` ([n_local, ...] → [n_local]), then merge the global top-k:
    (scores [k], global item indices [k]), the same on every rank. The
    brute-force-ANN building block: each shard scores only its rows."""
    n_local = items.shape[0]
    scores = score_fn(items)
    local_scores, local_idx = top_k(scores, k)
    return _merge(mesh, local_scores, local_idx + mesh.coord(MODEL_AXIS) * n_local, k)
