"""Stable sort of id rows by id, carrying value arrays: the dedup's sort.

Each [Q, W] row of int32 ids is sorted ascending, equal ids in slot order,
and every value array's entries move with their ids: what
``torch.sort(stable=True)`` followed by ``take_along_dim`` gives, bit for bit.
The JAX package does this with one multi-operand ``lax.sort``
(``the_algorithm_tpu/ops/retrieval.py:89``) and has no kernel for it.

:func:`sort_by_id` launches the CUDA kernel of ``csrc/id_sort.cu`` where
:func:`engages` says so: a row sorts in one CTA's shared memory, so rows up
to :data:`W_MAX` slots with 1 to :data:`MAX_VALUES` float32 value arrays on
a GPU. Everything else, the CPU included, takes :func:`sort_by_id_plain`.
:func:`_plan` sizes the launch from W alone.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from the_algorithm_tpu_torch import _build

MAX_VALUES = 4  # value arrays one launch carries
MAX_THREADS = 1024
IPT = (4, 8, 12, 16, 20)  # places a thread holds: the kernel's template instances (csrc/id_sort.cu)
W_MAX = MAX_THREADS * IPT[-1]  # 20,480 slots: 10 bytes each beside the counters, in one CTA's 227 KB
DIGITS = 256  # 8-bit digits: at most four passes over the 32-bit key


class Plan(NamedTuple):
    ipt: int  # slots a thread holds
    threads: int  # threads of the row's CTA, a multiple of 32
    smem: int  # bytes of dynamic shared memory


def smem_bytes(threads: int, ipt: int) -> int:
    """Keys, a value row and 16-bit slots of every place, the 16-bit
    counters of each digit by warp (one spare column), 40 words of totals
    (``smem_bytes`` of ``csrc/id_sort.cu``)."""
    return 10 * threads * ipt + 2 * DIGITS * (threads // 32 + 1) + 4 * 40


def _plan(W: int) -> Plan:
    """The fewest places a thread that let at most 1,024 threads hold the
    row, and the fewest whole warps that hold it at that."""
    if not 0 < W <= W_MAX:
        raise ValueError(f"no one-CTA sort for rows of {W} slots (at most {W_MAX})")
    ipt = next(n for n in IPT if n * MAX_THREADS >= W)
    threads = 32 * -(-W // (32 * ipt))
    return Plan(ipt, threads, smem_bytes(threads, ipt))


def engages(device_type: str, Q: int, W: int, k: int) -> bool:
    """Whether [Q, W] ids with k value arrays sort in the kernel: on a GPU,
    a row of at most :data:`W_MAX` slots, 1 to :data:`MAX_VALUES` arrays.
    No threshold on Q: at every caller's shape, one row included, the kernel
    takes less device time than the stable sort and its carries (PERF.md)."""
    return device_type == "cuda" and Q > 0 and 0 < W <= W_MAX and 1 <= k <= MAX_VALUES


def _check(ids: torch.Tensor, values: Tuple[torch.Tensor, ...]) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"ids must be int32 [Q, W], got {ids.dtype} {tuple(ids.shape)}")
    for v in values:
        if v.dtype != torch.float32 or v.shape != ids.shape:
            raise ValueError(f"values must be float32 {tuple(ids.shape)}, got {v.dtype} {tuple(v.shape)}")
        if v.device != ids.device:
            raise ValueError(f"values on {v.device}, ids on {ids.device}")
    if not all(t.is_contiguous() for t in (ids, *values)):
        raise ValueError("sort_by_id takes contiguous tensors")


def sort_by_id_plain(ids: torch.Tensor, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: the stable sort's order, each value array
    gathered through it."""
    ids, order = torch.sort(ids, dim=-1, stable=True)
    return (ids,) + tuple(torch.take_along_dim(v, order, dim=-1) for v in values)


def sort_by_id(ids: torch.Tensor, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Stable sort of each [Q, W] row of ``ids`` by id, carrying ``values``.

    Returns (sorted ids, *values in the same order). Where :func:`engages`
    says so this launches the kernel, which takes int32 ids and float32
    value arrays of their shape, all contiguous on one device, and raises
    on anything else; every other call runs :func:`sort_by_id_plain`.
    """
    if ids.dim() != 2 or ids.device.type != "cuda":
        return sort_by_id_plain(ids, *values)
    Q, W = ids.shape
    if not engages("cuda", Q, W, len(values)):
        return sort_by_id_plain(ids, *values)
    _check(ids, values)
    plan = _plan(W)
    out_ids = torch.empty_like(ids)
    outs = [torch.empty_like(v) for v in values]
    vp = [v.data_ptr() for v in values] + [None] * (MAX_VALUES - len(values))
    op = [o.data_ptr() for o in outs] + [None] * (MAX_VALUES - len(values))
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().sort_by_id(
            ids.data_ptr(), *vp, out_ids.data_ptr(), *op, Q, W, len(values), *plan, stream
        )
    _build.check(err, "sort_by_id")
    _build.count_launch(sort_by_id)
    return (out_ids,) + tuple(outs)


sort_by_id.launches = 0  # kernel launches, counted by the wrapper
