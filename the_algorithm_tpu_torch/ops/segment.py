"""Static-shaped grouped reductions — the ``sumByKey`` of the offline jobs.

Counterpart of ``the_algorithm_tpu/ops/segment.py``. Every Scalding shuffle
of the reference's matrix jobs (``UpdateKnownFor.collectInformationPerNode``
``.sumByKey``, ``InterestedInFromKnownFor.userClusterPairsWithoutNormalization``
``.sumByKey``) becomes a per-row grouped sum: a stable sort of each row's
ids, then the run-collapse kernel (``ops/seg_scan.run_collapse_sorted``),
one launch for up to :data:`~the_algorithm_tpu_torch.ops.seg_scan.MAX_VALUES`
value rows (more go in several launches; no caller sends more than 4).

The layout is JAX's exactly: each distinct id and its sums sit at the
run's **first** slot after the sort, every other slot holds PAD_ID / 0 (the
kernel leaves a run's total at its last slot, moved here). A run of PAD_ID
keeps the sum of its values at its first slot, as JAX's prefix-sum
difference does. Where the sums differ: JAX takes a run's total as the
difference of two f32 prefix sums, so its error grows with the row's prefix;
the kernel sums each run directly.

:func:`ranked` and :func:`run_rank` are the ranked cuts of the offline jobs
(top-K a group after a sort by group, then score descending), in
``lax.sort``'s order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from the_algorithm_tpu_torch.ops.seg_scan import MAX_VALUES, run_collapse_sorted
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


def _run_starts_and_ends(s_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_start, end_idx) of sorted rows [Q, W]: the first slot of each run
    (JAX's rule: a slot differing from the one before, the first slot
    compared with -1), and for every slot the last slot of its run."""
    Q, W = s_ids.shape
    is_start = torch.ones_like(s_ids, dtype=torch.bool)
    is_start[:, 1:] = s_ids[:, 1:] != s_ids[:, :-1]
    is_start[:, 0] = s_ids[:, 0] != -1
    is_end = torch.ones_like(s_ids, dtype=torch.bool)
    is_end[:, :-1] = s_ids[:, :-1] != s_ids[:, 1:]
    idx = torch.arange(W, device=s_ids.device).expand(Q, W)
    ends = torch.where(is_end, idx, W).flip(-1)
    end_idx = torch.cummin(ends, dim=-1).values.flip(-1)  # nearest run end at or after each slot
    return is_start, end_idx


def row_dedup_sum(ids: torch.Tensor, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-row grouped sum: for each row, sum ``values`` over equal ids.

    ``ids``: [..., W] int32 (PAD_ID sorts last and is kept as PAD_ID);
    ``values``: float32 of the same shape. Returns (rep_ids, *sums) of the
    same shape: each distinct id once, at its run-start position after a
    stable in-row sort; other slots PAD_ID / 0. Rows are independent.
    """
    shape = ids.shape
    W = shape[-1]
    s_ids, order = torch.sort(ids.reshape(-1, W), dim=-1, stable=True)
    s_vals = [torch.take_along_dim(v.reshape(-1, W).float(), order, dim=-1) for v in values]
    is_start, end_idx = _run_starts_and_ends(s_ids)
    pad_run = is_start & (s_ids == PAD_ID)
    out = []
    for c in range(0, len(s_vals), MAX_VALUES):
        _, *sums = run_collapse_sorted(s_ids, *s_vals[c:c + MAX_VALUES])
        for v, s in zip(s_vals[c:c + MAX_VALUES], sums):
            total = torch.take_along_dim(s, end_idx, dim=-1)
            pad_total = torch.where(s_ids == PAD_ID, v, 0.0).sum(-1, keepdim=True)
            out.append(torch.where(pad_run, pad_total, torch.where(is_start, total, 0.0)).reshape(shape))
    rep = torch.where(is_start, s_ids, PAD_ID).reshape(shape)
    return (rep,) + tuple(out)


def row_dedup_count(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row distinct ids + multiplicity counts (same layout as above)."""
    rep, counts = row_dedup_sum(ids, torch.ones(ids.shape, dtype=torch.float32, device=ids.device))
    return rep, torch.where(rep == PAD_ID, 0.0, counts)


def scatter_sum(keys: torch.Tensor, *values: torch.Tensor, size: int) -> Tuple[torch.Tensor, ...]:
    """Dense [size] sums of each of ``values`` by ``keys`` (any shape, int),
    deterministic: one stable sort of the flattened keys and one run-collapse
    launch (for up to MAX_VALUES value arrays), each key's total written once
    — JAX's ``zeros(size).at[keys].add(values)`` with no float atomic. Keys
    outside [0, size) are dropped."""
    if not 0 < size < 2**31:
        raise ValueError(f"no int32-keyed scatter into {size} slots")
    flat = keys.reshape(1, -1)
    inside = (flat >= 0) & (flat < size)
    s_keys, order = torch.sort(torch.where(inside, flat, PAD_ID).to(torch.int32), dim=-1, stable=True)
    vals = [torch.take_along_dim(torch.where(inside, v.reshape(1, -1).float(), 0.0), order, dim=-1) for v in values]
    out = []
    for c in range(0, len(vals), MAX_VALUES):
        rep, *sums = run_collapse_sorted(s_keys, *vals[c:c + MAX_VALUES])
        rows = torch.where(rep == PAD_ID, size, rep).reshape(-1).long()  # a spare slot takes every other slot's 0
        for t in sums:
            dense = torch.zeros(size + 1, dtype=torch.float32, device=keys.device)
            out.append(dense.index_put_((rows,), t.reshape(-1))[:size])
    return tuple(out)


_U32 = 0xFFFFFFFF


def _descending_image(score: torch.Tensor) -> torch.Tensor:
    """An int64 in [0, 2³²) per f32 score that sorts ascending as the score
    sorts descending; −0.0 maps with +0.0 (``lax.sort`` ranks them equal)."""
    bits = (score + 0.0).contiguous().view(torch.int32).to(torch.int64) & _U32
    ascending = torch.where(bits >= 0x80000000, _U32 - bits, bits + 0x80000000)
    return _U32 - ascending


def ranked(group: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """The permutation of a stable sort by (group ascending, score
    descending): ``lax.sort((group, −score), num_keys=2)``'s order, one
    int64 sort of the group above an order-preserving image of the score.
    ``group`` fits 32 bits; equal (group, score) keep their input order."""
    return torch.sort(group.to(torch.int64) * (1 << 32) + _descending_image(score), stable=True).indices


def run_rank(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal (sorted) keys."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    is_start = torch.ones_like(keys, dtype=torch.bool)
    is_start[1:] = keys[1:] != keys[:-1]
    return idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
