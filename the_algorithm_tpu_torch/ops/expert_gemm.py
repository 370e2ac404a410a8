"""The routed experts of a mixture-of-experts layer: dispatch, the grouped
expert GEMM and the weighted combine.

Replaces no TPU kernel: the JAX package has no mixture of experts. Its
models' products are left to XLA; a routed layer looped over its experts
would take two or three library calls an expert (64 experts × 26 layers of
Moonlight-16B-A3B: 3,328 launches a batch, paced by the host). Here the
tokens are grouped by expert once a layer, and every expert's product runs
in one launch.

- :func:`dispatch`: each token's k experts as slots ``token · k + j``,
  stably sorted by expert (``torch.sort`` on the card, no host sync), the
  slots' offsets by expert and the count of ``BM``-row tiles before each.
- :func:`expert_swiglu`: ``silu(x · Wgᵀ) * (x · Wuᵀ)`` for every sorted
  slot under its expert's weights, the A rows read straight from the
  token rows (no gathered copy), SwiGLU on the f32 sums: one launch.
- :func:`expert_down`: ``h · Wdᵀ`` for every sorted slot, written to the
  slot's place in token order: one launch.
- :func:`moe_combine`: ``residual + shared + Σ_j w_j · y_j`` a token in f32,
  rounded once: one launch.

The grouped GEMMs are CUDA C++ (``csrc/experts/expert_gemm.cu``, wgmma on
sm_90a, built by ``_build.lib("experts")`` at their first launch); the
combine, a fused weighted sum, is Triton (``tsrc/expert_gemm.py``, loaded at
its first launch on a card). What bounds them: at Moonlight's widths and
~1,536 slots an expert, the GEMMs do ~600 FLOP a byte moved, above the
H100's 295, so the tensor cores (989 TFLOP/s dense bf16); the combine moves
7 rows a token (memory). The design keeps each expert's weights and rows in
L2 while its tiles run (tiles expert-major: one expert's tiles are about
one wave) and fuses the gather of A rows, the SwiGLU and the scatter back to
token order into the GEMMs. Empty and uneven groups need no host knowledge:
the grid is sized for the most tiles any routing can give, and tiles past
the last exit.

Each op has its plain version beside it (a loop of per-expert f32 matmuls;
the CPU tests' oracle), taken for CPU tensors; a CUDA tensor launches the
kernel or raises. The kernels have no backward: under autograd the GPU path
raises. Launches are counted on each wrapper (``_build.count_launch``).
"""

from __future__ import annotations

import functools
import importlib.util
import os
import sys
from typing import NamedTuple

import torch
import torch.nn.functional as F

from the_algorithm_tpu_torch import _build

_TSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tsrc", "expert_gemm.py")


class Tiles(NamedTuple):
    """Launch shapes. The GEMMs' are fixed in ``csrc/experts/expert_gemm.cu``
    (BM, BN, BK 64, 4 stages, two warpgroups); the combine's were chosen on
    the card at Moonlight's widths (PERF.md)."""

    bm: int = 128  # rows of a GEMM tile (the kernels' BM): every expert's slots are cut into these
    combine_tokens: int = 8
    combine_dims: int = 512


TILES = Tiles()


class Dispatch(NamedTuple):
    """Where each routed slot goes (``S = tokens · k`` slots, ``E`` experts)."""

    src: torch.Tensor  # [S] int32: the token row of each sorted slot
    dst: torch.Tensor  # [S] int32: the slot (token · k + j) each sorted slot came from
    offsets: torch.Tensor  # [E + 1] int32: expert e owns sorted slots offsets[e]:offsets[e + 1]
    tiles: torch.Tensor  # [E + 1] int32: BM-row tiles of the experts before e (the last: all)

    @property
    def counts(self) -> torch.Tensor:
        """[E] slots routed to each expert (a device tensor; no sync)."""
        return self.offsets.diff()


def dispatch(topk_idx: torch.Tensor, num_experts: int) -> Dispatch:
    """The slots of ``topk_idx`` [T, k] (each token's experts) grouped by
    expert, stably (slot order inside an expert)."""
    T, k = topk_idx.shape
    flat = topk_idx.reshape(-1).to(torch.int32)
    expert, order = torch.sort(flat, stable=True)
    bounds = torch.arange(num_experts + 1, dtype=torch.int32, device=flat.device)
    offsets = torch.searchsorted(expert, bounds).to(torch.int32)
    per = (offsets.diff() + (TILES.bm - 1)) // TILES.bm
    tiles = torch.cat([per.new_zeros(1), torch.cumsum(per, 0)]).to(torch.int32)
    order = order.to(torch.int32)
    return Dispatch(torch.div(order, k, rounding_mode="floor"), order, offsets, tiles)


def max_tiles(slots: int, num_experts: int) -> int:
    """The most row tiles any routing of ``slots`` slots over ``num_experts``
    experts can give (every expert a partial tile)."""
    return -(-slots // TILES.bm) + num_experts


@functools.lru_cache(maxsize=None)
def _triton():
    """The combine kernel's module, loaded once by path (it imports ``triton``)."""
    spec = importlib.util.spec_from_file_location("the_algorithm_tpu_torch_tsrc_expert_gemm", _TSRC)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _guard(name: str, *tensors: torch.Tensor) -> None:
    """What the kernels take: bf16 operands, contiguous, on one CUDA device,
    and no autograd (they have no backward)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() or inference_mode()")


def expert_swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """Plain version: per expert, its rows' f32 products and SwiGLU, rounded
    once to ``x.dtype``. [S, I]."""
    E, I, _ = w_gate.shape
    h = x.new_empty((d.src.shape[0], I))
    offs = d.offsets.tolist()
    for e in range(E):
        a, b = offs[e], offs[e + 1]
        if a == b:
            continue
        xe = x[d.src[a:b].long()].float()
        h[a:b] = (F.silu(xe @ w_gate[e].float().T) * (xe @ w_up[e].float().T)).to(x.dtype)
    return h


def expert_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """``silu(x[src] · Wg[e]ᵀ) * (x[src] · Wu[e]ᵀ)`` for every sorted slot:
    x [T, D], w_gate and w_up [E, I, D] → [S, I] in sorted-slot order. One
    launch on a card (bf16 only); the plain version on the CPU."""
    if x.device.type == "cpu":
        return expert_swiglu_plain(x, w_gate, w_up, d)
    _guard("expert_swiglu", x, w_gate, w_up, *d)
    if x.dtype != torch.bfloat16 or w_gate.dtype != torch.bfloat16 or w_up.dtype != torch.bfloat16:
        raise ValueError("expert_swiglu takes bf16 tokens and weights")
    E, I, D = w_gate.shape
    if w_up.shape != w_gate.shape or x.shape[1] != D or D % 8 or I % 8:
        raise ValueError(f"expert_swiglu: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, w_up "
                         f"{tuple(w_up.shape)}: want [T, D] and [E, I, D] each, D and I multiples of 8")
    S = d.src.shape[0]
    h = torch.empty((S, I), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib("experts").expert_gemm_swiglu(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr(), d.src.data_ptr(), d.offsets.data_ptr(),
            d.tiles.data_ptr(), E, D, I, max_tiles(S, E), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "expert_gemm_swiglu")
    _build.count_launch(expert_swiglu)
    return h


expert_swiglu.launches = 0  # kernel launches, counted by the wrapper


def expert_down_plain(h: torch.Tensor, w_down: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """Plain version: per expert, its rows' f32 product, rounded once, put
    at each row's slot. [S, D]."""
    E, D, _ = w_down.shape
    y = h.new_empty((h.shape[0], D))
    offs = d.offsets.tolist()
    for e in range(E):
        a, b = offs[e], offs[e + 1]
        if a == b:
            continue
        y[d.dst[a:b].long()] = (h[a:b].float() @ w_down[e].float().T).to(h.dtype)
    return y


def expert_down(h: torch.Tensor, w_down: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """``h[r] · Wd[e]ᵀ`` for every sorted slot r, at its slot: h [S, I],
    w_down [E, D, I] → [S, D] in slot order (token · k + j). One launch on
    a card (bf16 only); the plain version on the CPU."""
    if h.device.type == "cpu":
        return expert_down_plain(h, w_down, d)
    _guard("expert_down", h, w_down, *d)
    if h.dtype != torch.bfloat16 or w_down.dtype != torch.bfloat16:
        raise ValueError("expert_down takes bf16 rows and weights")
    E, D, I = w_down.shape
    if h.shape[1] != I or D % 8 or I % 8:
        raise ValueError(f"expert_down: h {tuple(h.shape)}, w_down {tuple(w_down.shape)}: want [S, I] and "
                         "[E, D, I], D and I multiples of 8")
    S = h.shape[0]
    y = torch.empty((S, D), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        err = _build.lib("experts").expert_gemm_down(
            h.data_ptr(), w_down.data_ptr(), y.data_ptr(), d.dst.data_ptr(), d.offsets.data_ptr(), d.tiles.data_ptr(),
            E, I, D, max_tiles(S, E), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "expert_gemm_down")
    _build.count_launch(expert_down)
    return y


expert_down.launches = 0  # kernel launches, counted by the wrapper


def moe_combine_plain(y: torch.Tensor, weights: torch.Tensor, shared: torch.Tensor,
                      residual: torch.Tensor) -> torch.Tensor:
    """Plain version: the routed terms summed in f32, plus the shared
    expert and the residual, rounded once to ``residual.dtype``."""
    T, k = weights.shape
    routed = (y.reshape(T, k, -1).float() * weights.float()[..., None]).sum(1)
    return (routed + shared.float() + residual.float()).to(residual.dtype)


def moe_combine(y: torch.Tensor, weights: torch.Tensor, shared: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """``residual + shared + Σ_j weights[t, j] · y[t · k + j]`` a token: y
    [T · k, D] in slot order, weights [T, k] f32, shared and residual
    [T, D] → [T, D] in ``residual.dtype``. One launch on a card; the plain
    version on the CPU."""
    if y.device.type == "cpu":
        return moe_combine_plain(y, weights, shared, residual)
    _guard("moe_combine", y, weights, shared, residual)
    if weights.dtype != torch.float32:
        raise ValueError("moe_combine takes f32 routing weights")
    T, k = weights.shape
    D, t = residual.shape[1], TILES
    out = torch.empty_like(residual)
    grid = (-(-T // t.combine_tokens), -(-D // t.combine_dims))
    with torch.cuda.device(y.device):
        _triton().moe_combine_kernel[grid](y, weights, shared, residual, out, T, D, K=k, BT=t.combine_tokens,
                                           BD=t.combine_dims, num_warps=4)
    _build.count_launch(moe_combine)
    return out


moe_combine.launches = 0  # kernel launches, counted by the wrapper
