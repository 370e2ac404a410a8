"""Run-collapse (dedup-sum) over sorted id rows.

Counterpart of ``the_algorithm_tpu/ops/seg_scan.py``. Per row of ids sorted
ascending, each maximal run of equal ids collapses: the run's **last** slot
holds (id, Σ value) for each value array and every other slot holds
(PAD_ID, 0). A run of PAD_ID reads (PAD_ID, 0) too. Consumers mask by PAD_ID
and never depend on which slot of a run holds it.

:func:`run_collapse_sorted` launches the CUDA kernel of ``csrc/seg_scan.cu``
for tensors on a GPU and runs :func:`run_collapse_sorted_plain` for tensors on
the CPU. A single row is the same call with Q = 1, so the JAX package's
separate 1-D form (there for ``jax.vmap``) has no counterpart.

The kernel gives each row a thread-block cluster of CTAs, each scanning one
tile of the row per pass; :func:`_plan` sizes the launch from Q, W, k and the
SM count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from the_algorithm_tpu_torch import _build
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

MAX_VALUES = 3  # the kernel's template instances: k = 1, 2, 3 value arrays
ITEMS = 8  # consecutive slots a thread scans (csrc/seg_scan.cu)
MAX_THREADS = 512
MAX_STAGES = 3
MAX_CLUSTER = 8  # the portable cluster size
SMEM_PER_CTA = 112 * 1024  # a CTA's ring, at most: two CTAs share an SM's 228 KB


class TileShape(NamedTuple):
    """The kernel's tuning knobs."""

    tile_max: int  # most slots one CTA scans at once: a multiple of 4, at most 8·512 − 8
    stages: int  # tiles in flight in a CTA's ring, 1 to 3
    per_sm: int  # CTAs the launch aims to give each SM: rows too few for that get more CTAs each


# tuned on an H100 at [256, 20,000] k=2 (chip_smoke.py re-times the neighbours)
SHAPE = TileShape(tile_max=4088, stages=2, per_sm=1)


class Plan(NamedTuple):
    cluster: int  # CTAs to a row, one cluster
    tile: int  # slots of a CTA's tile, a multiple of 4
    passes: int  # tiles of a row a CTA scans, one after another
    stages: int  # tiles in its shared-memory ring
    threads: int  # threads of a CTA, 8 slots each
    smem: int  # bytes of dynamic shared memory


def _plan(Q: int, W: int, k: int, sms: int, shape: Optional[TileShape] = None) -> Plan:
    """The launch for Q rows of W slots and k value arrays on ``sms`` SMs.

    A row gets one CTA if Q rows give every SM ``shape.per_sm`` of them, and
    more, up to a cluster of 8 (and at least 4 slots each), if they do not;
    then the fewest passes that keep a tile within ``shape.tile_max`` and
    the ring within :data:`SMEM_PER_CTA`, and tiles as even as multiples of
    4 let them be. A CTA's threads cover its tile and the up to 3 slots
    before it in the tile's first 16 bytes.
    ``shape`` defaults to :data:`SHAPE`; the kernel sizes its persistent
    grid itself.
    """
    shape = SHAPE if shape is None else shape
    if Q < 1 or W < 1 or not 1 <= k <= MAX_VALUES or sms < 1:
        raise ValueError(f"no launch for Q={Q}, W={W}, k={k} on {sms} SMs")
    if shape.tile_max % 4 or not 4 <= shape.tile_max <= ITEMS * MAX_THREADS - 8:
        raise ValueError(f"tile_max {shape.tile_max} not a multiple of 4 in [4, {ITEMS * MAX_THREADS - 8}]")
    if not 1 <= shape.stages <= MAX_STAGES or shape.per_sm < 1:
        raise ValueError(f"no launch for {shape}")
    cluster = max(1, min(MAX_CLUSTER, -(-W // 4), -(-shape.per_sm * sms // Q)))
    # the most slots a ring stage may hold, in whole warps of threads, less the lead
    slots = SMEM_PER_CTA // (shape.stages * (1 + k) * 4) // (32 * ITEMS) * (32 * ITEMS)
    tile_max = min(shape.tile_max, slots - 8)
    passes = -(-W // (cluster * tile_max))
    tile = 4 * -(-W // (4 * cluster * passes))
    cluster = -(-W // (tile * passes))  # no CTA left without a slot
    threads = 32 * -(-(tile + 3) // (32 * ITEMS))
    return Plan(cluster, tile, passes, shape.stages, threads, shape.stages * (1 + k) * threads * ITEMS * 4)


def _check(ids: torch.Tensor, values: Tuple[torch.Tensor, ...]) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"ids must be int32 [Q, W], got {ids.dtype} {tuple(ids.shape)}")
    if not 1 <= len(values) <= MAX_VALUES:
        raise ValueError(f"need 1..{MAX_VALUES} value arrays, got {len(values)}")
    for v in values:
        if v.dtype != torch.float32 or v.shape != ids.shape:
            raise ValueError(
                f"values must be float32 {tuple(ids.shape)}, got {v.dtype} {tuple(v.shape)}"
            )
        if v.device != ids.device:
            raise ValueError(f"values on {v.device}, ids on {ids.device}")
    if not all(t.is_contiguous() for t in (ids, *values)):
        raise ValueError("run_collapse_sorted takes contiguous tensors")


def run_collapse_sorted_plain(
    ids: torch.Tensor, *values: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: run totals by scatter-add over run indices
    (no prefix-sum difference, so no cancellation in f32)."""
    _check(ids, values)
    Q, W = ids.shape
    if Q == 0 or W == 0:
        return (ids.clone(),) + tuple(v.clone() for v in values)
    change = ids[:, 1:] != ids[:, :-1]
    edge = torch.ones((Q, 1), dtype=torch.bool, device=ids.device)
    head = torch.cat([edge, change], dim=1)
    last = torch.cat([change, edge], dim=1) & (ids != PAD_ID)
    run = torch.cumsum(head, dim=1) - 1  # run index of every slot
    rep = torch.where(last, ids, PAD_ID)
    sums = []
    for v in values:
        total = torch.zeros_like(v).scatter_add_(1, run, v)
        sums.append(torch.where(last, torch.gather(total, 1, run), 0.0))
    return (rep,) + tuple(sums)


def run_collapse_sorted(
    ids: torch.Tensor, *values: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Collapse equal-id runs of pre-sorted rows by summing ``values``.

    ids: [Q, W] int32 sorted ascending per row; values: 1 to 3 arrays
    [Q, W] float32, all contiguous on one device. Returns (rep_ids, *sums) of
    the same shape. On a CUDA device this launches the kernel or raises; only
    tensors on the CPU take the plain version.
    """
    if ids.device.type == "cpu":
        return run_collapse_sorted_plain(ids, *values)
    _check(ids, values)
    if ids.device.type != "cuda":
        raise ValueError(f"run_collapse_sorted runs on cpu or cuda, not {ids.device}")
    Q, W = ids.shape
    out_ids = torch.empty_like(ids)
    outs = [torch.empty_like(v) for v in values]
    if ids.numel() == 0:  # nothing to launch
        return (out_ids,) + tuple(outs)
    k = len(values)
    plan = _plan(Q, W, k, torch.cuda.get_device_properties(ids.device).multi_processor_count)
    vp = [v.data_ptr() for v in values] + [None] * (MAX_VALUES - k)
    op = [o.data_ptr() for o in outs] + [None] * (MAX_VALUES - k)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().run_collapse_sorted(
            ids.data_ptr(), *vp, out_ids.data_ptr(), *op, Q, W, k, *plan, stream
        )
    _build.check(err, "run_collapse_sorted")
    run_collapse_sorted.launches += 1
    return (out_ids,) + tuple(outs)


run_collapse_sorted.launches = 0  # kernel launches, counted by the wrapper
