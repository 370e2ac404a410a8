"""Hashed sparse logistic-regression compute.

Counterpart of ``the_algorithm_tpu/ops/hashed_lr.py`` ≡ libtwml's
``BinarySparseTensorDenseMatMul``
(``twml/libtwml/src/ops/binary_sparse_dense_matmul.cpp``) + twml's
``FullSparse`` layer (``twml/twml/layers/full_sparse.py:214-275``): examples
arrive as (hashed-index, value) pairs; the logit is a sparse dot against a
2**bits weight table.

Examples are padded fixed-width — ``indices [B, W] int32`` (pad = 0 with
mask), ``values [B, W] f32``. The JAX package leaves the gather and its
transpose (a scatter-add) to XLA; here both are hand kernels, as the port's
rules ask of every keyed table read and every sum (deterministic run to run,
no atomic scatter-add):

- forward: the ``[N, O]`` weight rows of all B·W slots in one
  :func:`~the_algorithm_tpu_torch.ops.gather.row_gather` launch, then the
  masked contraction;
- backward: d(weights) from the flattened ids and their contributions
  ``mask·value·dlogits`` through ``retrieval._dedup_sum`` (a stable sort,
  then :func:`~the_algorithm_tpu_torch.ops.seg_scan.run_collapse_sorted`),
  each distinct row written once. O > 3 outputs go in chunks of
  ``seg_scan.MAX_VALUES``.

Ids follow JAX's indexing: a negative id counts from the end; the forward
reads an id still outside the table at the clamped row (``gather.jax_rows``),
and the backward drops its contribution, as the transpose of JAX's clamped
gather (a scatter-add that drops out-of-bounds ids) does. On the CPU both
kernels run their plain versions; on CUDA they launch or raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from the_algorithm_tpu_torch.ops.gather import grad_ids, jax_rows, row_gather
from the_algorithm_tpu_torch.ops.retrieval import _dedup_sum
from the_algorithm_tpu_torch.ops.seg_scan import MAX_VALUES
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


class SparseBatch(NamedTuple):
    """Padded fixed-width hashed sparse features for one batch."""

    indices: torch.Tensor  # [B, W] int32 in [0, num_buckets)
    values: torch.Tensor  # [B, W] float32
    mask: torch.Tensor  # [B, W] bool — False in padding


def weight_grad(ids: torch.Tensor, vals: torch.Tensor, dlogits: torch.Tensor, num_rows: int) -> torch.Tensor:
    """d(weights) [num_rows, O] of Σ_w vals·weights[ids] for ``dlogits``
    [B, O]: every slot's contribution ``vals[b, w]·dlogits[b, :]`` summed per
    id by sort + run-collapse, each distinct row written once (the rest
    zero). ``ids`` [B, W] int32 within [0, num_rows), or PAD_ID for a slot
    that contributes nothing."""
    O = dlogits.shape[1]
    flat = ids.reshape(1, -1)
    contrib = vals[:, :, None] * dlogits[:, None, :]  # [B, W, O]
    cols = [contrib[..., o].reshape(1, -1).contiguous() for o in range(O)]
    # one spare row takes every PAD slot's zero, so no host sync picks the kept slots
    grad = torch.zeros((num_rows + 1, O), dtype=dlogits.dtype, device=dlogits.device)
    for c in range(0, O, MAX_VALUES):
        rep, *sums = _dedup_sum(flat, *cols[c:c + MAX_VALUES])
        rows = torch.where(rep == PAD_ID, num_rows, rep).reshape(-1).long()
        grad[rows, c:c + len(sums)] = torch.stack([s.reshape(-1) for s in sums], dim=1)
    return grad[:num_rows]


class _SparseDot(torch.autograd.Function):
    """logits [B, O] = Σ_w vals[b, w]·weights[rows[b, w], :], the gather a
    row_gather launch and d(weights) :func:`weight_grad` over ``grad_ids``
    (``rows``, or PAD_ID where JAX's gradient drops the slot)."""

    @staticmethod
    def forward(ctx, rows, grad_ids, vals, weights):
        (gathered,) = row_gather(rows, weights)  # [B, W, O]
        ctx.save_for_backward(grad_ids, vals, gathered)
        ctx.num_rows = weights.shape[0]
        return torch.einsum("bw,bwo->bo", vals, gathered)

    @staticmethod
    def backward(ctx, dlogits):
        grad_ids, vals, gathered = ctx.saved_tensors
        d_vals = torch.einsum("bo,bwo->bw", dlogits, gathered) if ctx.needs_input_grad[2] else None
        d_w = weight_grad(grad_ids, vals, dlogits.contiguous(), ctx.num_rows) if ctx.needs_input_grad[3] else None
        return None, None, d_vals, d_w


def sparse_logits(
    batch: SparseBatch,
    weights: torch.Tensor,  # [num_buckets, O] or [num_buckets]
    bias: Optional[torch.Tensor] = None,  # [O] or scalar
) -> torch.Tensor:
    """logits[b, o] = Σ_w mask·value·weights[index, o]  (+ bias)."""
    squeeze = weights.dim() == 1
    w = weights[:, None] if squeeze else weights  # [N, O]
    n = w.shape[0]
    vals = torch.where(batch.mask, batch.values, 0.0)
    logits = _SparseDot.apply(jax_rows(batch.indices, n).to(torch.int32), grad_ids(batch.indices, n), vals,
                              w.contiguous())
    if bias is not None:
        logits = logits + bias
    return logits[..., 0] if squeeze else logits


def binary_sparse_logits(
    indices: torch.Tensor,  # [B, W] int32
    mask: torch.Tensor,  # [B, W] bool
    weights: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binary-feature fast path (values ≡ 1), the op the C++ kernel special-cases."""
    batch = SparseBatch(indices, torch.ones(indices.shape, dtype=torch.float32, device=indices.device), mask)
    return sparse_logits(batch, weights, bias)
