"""Row gather from k aligned tables in one launch: the multiget primitive.

Counterpart of ``the_algorithm_tpu/ops/gather.py``. :func:`row_gather`
launches the CUDA kernel of ``csrc/gather.cu`` for tensors on a GPU and runs
:func:`row_gather_plain` (``index_select``) for tensors on the CPU. Ids must
be in range: the caller masks PAD ids first (``where(valid, ids, 0)``), as the
JAX package's callers do. The JAX gather clamped an id out of range silently;
here the plain version raises and the kernel traps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from the_algorithm_tpu_torch import _build

MAX_TABLES = 3  # the kernel takes up to three table pointers per launch


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
    ptrs = [t.data_ptr() for t in tables] + [o.data_ptr() for o in outs]
    if all(b % 16 == 0 for b in row_bytes) and all(p % 16 == 0 for p in ptrs):
        vec = 16
    elif all(b % 4 == 0 for b in row_bytes) and all(p % 4 == 0 for p in ptrs):
        vec = 4
    else:
        raise ValueError(f"row_gather needs rows and bases 4-byte aligned, got rows of {row_bytes} B")
    pad = [None] * (MAX_TABLES - k)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().row_gather(
            flat.data_ptr(), B, R, k,
            *[t.data_ptr() for t in tables], *pad,
            *[o.data_ptr() for o in outs], *pad,
            *(row_bytes + [0] * (MAX_TABLES - k)), vec, stream,
        )
    _build.check(err, "row_gather")
    row_gather.launches += 1
    return tuple(o.reshape(ids.shape + (o.shape[1],)) for o in outs)


row_gather.launches = 0  # kernel launches, counted by the wrapper
