"""Row gather from k aligned tables in one launch: the multiget primitive.

Counterpart of ``the_algorithm_tpu/ops/gather.py``. :func:`row_gather`
launches a CUDA kernel of ``csrc/gather.cu`` for tensors on a GPU and runs
:func:`row_gather_plain` (``index_select``) for tensors on the CPU. Ids must
be in range: the caller masks PAD ids first (``where(valid, ids, 0)``), as the
JAX package's callers do. The JAX gather clamped an id out of range silently;
here the plain version raises and the kernel traps.

:func:`_plan` picks the kernel by alignment and sizes the TMA ring's launch
from the row widths, the row count and the card's SM count alone, so the CPU
tests can check every ring the card would run.

:func:`table_read` is an embedding table's read under autograd: the forward
one ``row_gather`` launch at JAX's rows (:func:`jax_rows`), the backward the
D-wide run collapse (:func:`~the_algorithm_tpu_torch.ops.seg_scan.
run_collapse_rows`) over the stably sorted ids, into a dense [N, D]
gradient as ``jax.grad`` gives it: each row written once, no atomic
scatter-add.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from the_algorithm_tpu_torch import _build
from the_algorithm_tpu_torch.ops.seg_scan import run_collapse_rows
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

MAX_TABLES = 3  # the kernel takes up to three table pointers per launch
SMEM_PER_SM = 233_472  # 228 KB of shared memory on each SM of an H100...
SMEM_RESERVED = 1024  # ...of which the card keeps 1 KB for each resident CTA


class RingShape(NamedTuple):
    """The TMA ring's shape, tuned on the card (PERF.md; chip_smoke.py times
    the neighbours of this choice on every run)."""

    stage_bytes: int = 16 * 1024  # the most bytes a stage holds
    stages: int = 4
    ctas_per_sm: int = 8  # at most; fewer where their stages do not fit an SM


RING = RingShape()


class Plan(NamedTuple):
    path: str  # "ring" (TMA bulk copies) or "words" (register copies; the C entry sizes its launch)
    grid: int = 0  # ring: CTAs, never more than its units of work
    rows_per_stage: int = 0  # ring: whole output rows of all tables a stage holds; 0: pieces
    piece: int = 0  # ring with no whole rows: the most bytes of one table's row a stage holds
    stages: int = 0  # ring: its depth
    stage_bytes: int = 0  # ring: a stage's size, a multiple of 16
    smem: int = 0  # ring: dynamic shared memory per CTA, the stages and their mbarriers


def _plan(row_bytes: Sequence[int], ptrs: Sequence[int], B: int, num_sms: int) -> Plan:
    """The launch for B rows of tables with these row widths (bytes).

    ``ptrs`` are every table's and output's base address. Rows and bases
    that are all multiples of 16 bytes go to the TMA ring; multiples of 4 to
    the register kernel; anything else raises. The ring's stages hold whole
    rows of all tables, as many as fit ``RING.stage_bytes`` but no more than
    leave every CTA two units of work (each unit costs its CTA a wait for its
    ids); a row wider than that is copied in pieces of ``RING.stage_bytes``.
    An SM holds ``RING.ctas_per_sm`` CTAs, or as many as its shared memory
    fits, so every CTA of the grid is resident at once.
    """
    if B < 1:
        raise ValueError(f"nothing to plan for {B} rows")
    if all(b % 16 == 0 for b in row_bytes) and all(p % 16 == 0 for p in ptrs):
        ring = RING
        row = sum(row_bytes)
        if row <= ring.stage_bytes:
            rows = max(1, min(ring.stage_bytes // row, -(-B // (2 * num_sms * ring.ctas_per_sm))))
            units, piece, stage = -(-B // rows), 0, rows * row
        else:
            piece = ring.stage_bytes
            units, rows, stage = B * sum(-(-b // piece) for b in row_bytes), 0, piece
        smem = ring.stages * (stage + 8)
        per_sm = min(ring.ctas_per_sm, SMEM_PER_SM // (smem + SMEM_RESERVED))
        return Plan("ring", min(num_sms * per_sm, units), rows, piece, ring.stages, stage, smem)
    if all(b % 4 == 0 for b in row_bytes) and all(p % 4 == 0 for p in ptrs):
        return Plan("words")
    raise ValueError(f"row_gather needs rows and bases 4-byte aligned, got rows of {list(row_bytes)} B")


def jax_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The row a JAX gather reads for each id of an axis of ``n`` rows: a
    negative id counts from the end (+n), and the result is clamped to
    [0, n-1]. Callers map ids through this before :func:`row_gather` or an
    indexing, so that no out-of-range request traps the card."""
    return torch.where(ids < 0, ids + n, ids).clamp_(0, n - 1)


def _check(ids: torch.Tensor, tables: Tuple[torch.Tensor, ...]) -> None:
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"need 1..{MAX_TABLES} tables, got {len(tables)}")
    R = tables[0].shape[0]
    for t in tables:
        if t.dim() != 2 or t.shape[0] != R:
            raise ValueError(f"tables must be aligned [R={R}, M], got {tuple(t.shape)}")
        if t.device != ids.device:
            raise ValueError(f"table on {t.device}, ids on {ids.device}")
        if not t.is_contiguous():
            raise ValueError("row_gather takes contiguous tables")


def row_gather_plain(ids: torch.Tensor, *tables: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: one ``index_select`` per table."""
    _check(ids, tables)
    flat = ids.reshape(-1)
    return tuple(
        torch.index_select(t, 0, flat).reshape(ids.shape + (t.shape[1],)) for t in tables
    )


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_gather(ids: torch.Tensor, *tables: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gather the same rows from k aligned [R, M_k] tables.

    ``ids`` (int32) may have any shape; outputs are ``ids.shape + (M_k,)``.
    On a CUDA device this launches the kernel or raises; only tensors on the
    CPU take the plain version.
    """
    if ids.device.type == "cpu":
        return row_gather_plain(ids, *tables)
    _check(ids, tables)
    if ids.device.type != "cuda":
        raise ValueError(f"row_gather runs on cpu or cuda, not {ids.device}")
    flat = ids.reshape(-1).contiguous()
    B, R, k = flat.shape[0], tables[0].shape[0], len(tables)
    if R >= 2**31:
        raise ValueError(f"{R} table rows do not fit int32 ids")
    outs = [torch.empty((B, t.shape[1]), dtype=t.dtype, device=t.device) for t in tables]
    if B == 0:  # nothing to launch
        return tuple(o.reshape(ids.shape + (o.shape[1],)) for o in outs)
    row_bytes = [t.shape[1] * t.element_size() for t in tables]
    tptrs, optrs = [t.data_ptr() for t in tables], [o.data_ptr() for o in outs]
    sms = _num_sms(ids.device.index)
    plan = _plan(row_bytes, tptrs + optrs, B, sms)
    pad = [None] * (MAX_TABLES - k)
    args = (flat.data_ptr(), B, R, k, *tptrs, *pad, *optrs, *pad, *row_bytes, *[0] * (MAX_TABLES - k))
    with torch.cuda.device(ids.device):
        # the raw handle: torch.cuda.current_stream() builds a Python Stream object on every call
        stream = torch._C._cuda_getCurrentRawStream(ids.device.index)
        if plan.path == "ring":
            err = _build.lib().row_gather_ring(
                *args, plan.rows_per_stage, plan.piece, plan.stages, plan.grid, plan.smem, stream
            )
        else:
            err = _build.lib().row_gather_words(*args, sms, stream)
    _build.check(err, f"row_gather_{plan.path}")
    _build.count_launch(row_gather)
    return tuple(o.reshape(ids.shape + (o.shape[1],)) for o in outs)


row_gather.launches = 0  # kernel launches, counted by the wrapper


def ring_rows(t: torch.Tensor) -> bool:
    """Whether the TMA ring copies this [rows, width] table: its rows and its
    base are 16-byte multiples (:func:`_plan`)."""
    return (t.shape[1] * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0


def launch_groups(group: Dict[str, torch.Tensor]) -> List[List[str]]:
    """The names of ``group`` (tables viewed as [rows, width]) split into
    :func:`multiget`'s row_gather launches: 16-byte rows together, then the
    rest, at most :data:`MAX_TABLES` a launch."""
    ring = [n for n, t in group.items() if ring_rows(t)]
    words = [n for n, t in group.items() if not ring_rows(t)]
    return [names[i:i + MAX_TABLES] for names in (ring, words) for i in range(0, len(names), MAX_TABLES)]


def multiget(group: Dict[str, torch.Tensor], key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{name: table[key]}`` for same-row-count tables (rows of any shape),
    through the row-gather kernel in :func:`launch_groups`' launches (its
    plain version on the CPU); ``key`` holds rows in range."""
    key = key.to(torch.int32)
    flat = {n: t.reshape(t.shape[0], -1) for n, t in group.items()}
    out = {}
    for names in launch_groups(flat):
        for n, g in zip(names, row_gather(key, *(flat[n] for n in names))):
            out[n] = g.reshape(key.shape + group[n].shape[1:])
    return out


def grad_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The row each id's gradient goes to, as JAX's transpose of its gather
    (a scatter-add that drops out-of-bounds ids) sends it: a negative id
    counts from the end; an id still outside [0, n) is PAD_ID (dropped).
    int32, ``ids.shape``."""
    wrapped = torch.where(ids < 0, ids + n, ids)
    return torch.where((wrapped >= 0) & (wrapped < n), wrapped, PAD_ID).to(torch.int32)


class _TableRead(torch.autograd.Function):
    """``table[ids]`` with JAX's index rule: forward one row_gather, backward
    the D-wide collapse of the output gradient (a dense [N, D] gradient)."""

    @staticmethod
    def forward(ctx, ids, table):
        n = table.shape[0]
        (rows,) = row_gather(jax_rows(ids, n).to(torch.int32), table)
        ctx.save_for_backward(ids)
        ctx.num_rows = n
        return rows

    @staticmethod
    def backward(ctx, d_rows):
        if not ctx.needs_input_grad[1]:
            return None, None
        (ids,) = ctx.saved_tensors
        sorted_ids, perm = torch.sort(grad_ids(ids, ctx.num_rows).reshape(-1), stable=True)
        dy = d_rows.reshape(-1, d_rows.shape[-1]).contiguous()
        return None, run_collapse_rows(sorted_ids, perm, dy, ctx.num_rows)


def table_read(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as JAX's gather reads it, ids of any shape →
    ``ids.shape + (D,)``, with a gradient for ``table`` when autograd asks
    for one (:class:`_TableRead`). ``table`` is a contiguous [N, D] tensor
    of 4-byte entries."""
    ids = torch.as_tensor(ids, device=table.device)
    return _TableRead.apply(ids, table)
