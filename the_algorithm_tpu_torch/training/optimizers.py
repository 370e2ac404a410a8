"""Optimizers with optax's arithmetic, as ``torch.optim.Optimizer`` s.

Counterpart of ``the_algorithm_tpu/training/optimizers.py``
(``scale_by_adam_bf16`` / ``adam_bf16``), plus the optax transforms that
``training/trainer.make_optimizer`` chains in the JAX package
(``optax.adamw``, ``optax.adagrad``, ``optax.sgd``,
``optax.clip_by_global_norm``). ``torch.optim``'s own Adam and Adagrad
compute other functions (eps inside the square root, an accumulator that
starts at 0, a clip with +1e-6), so each update here is written out in
optax's order of operations:

- :class:`Adam`: ``scale_by_adam`` (bias corrections ``1 − b**count`` from
  an int32 count, in f32 tensors; eps outside the square root), then
  decoupled decay (``add_decayed_weights``), then ``−lr``. Moments are kept
  in ``moment_dtype``; all arithmetic is f32.
- :class:`AdamBf16`: :class:`Adam` with both moments stored in bf16 — the
  JAX package's ``adam_bf16``, which halves the update's optimizer-state
  traffic.
- :class:`Adagrad`: ``scale_by_rss`` (the accumulator starts at 0.1;
  ``g·rsqrt(acc + eps)`` where acc > 0, else 0), then ``−lr``.
- :class:`SGD`: ``−lr·g``, no momentum.

Every optimizer takes ``max_grad_norm``: ``optax.clip_by_global_norm``
before the update (g as it is while ‖g‖ < max, else g/‖g‖·max). Updates run
in place under ``no_grad`` with ``torch._foreach_*`` ops (the JAX package
donates the state to XLA; it has no Pallas kernel here). Nothing syncs the
host with the card.

On a mesh (a sharded ``Trainer``) a parameter may be this rank's block of
a global array (:meth:`_Optax.split_over`): the update is elementwise, so
each rank updates its blocks and keeps their moments, sharded like them;
only the global norm spans ranks: the replicated gradients' squares plus
the blocks' squares summed over the axes that split them, one all-reduce a
step.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch


class _Optax(torch.optim.Optimizer):
    """The shared step: optional global-norm clipping over every gradient,
    then each group's update (:meth:`_update`) on its params with grads."""

    def __init__(self, params: Iterable, defaults: dict, max_grad_norm: Optional[float] = None):
        super().__init__(params, defaults)
        self.max_grad_norm = max_grad_norm
        self.mesh = None
        self.block_axes: Dict[torch.Tensor, Tuple[str, ...]] = {}

    def split_over(self, mesh, block_axes: Dict[torch.Tensor, Tuple[str, ...]]) -> None:
        """Tell the global-norm clip which params are blocks of a global
        array and over which mesh axes (an axis of one rank left out)."""
        self.mesh = mesh
        self.block_axes = {p: tuple(a) for p, a in block_axes.items() if a}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        groups = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            groups.append((group, params, [p.grad for p in params]))
        if self.max_grad_norm:
            pairs = [(p, g) for _, params, grads in groups for p, g in zip(params, grads)]
            _clip_by_global_norm([g for _, g in pairs], self.max_grad_norm,
                                 [self.block_axes.get(p, ()) for p, _ in pairs], self.mesh)
        for group, params, grads in groups:
            if params:
                self._update(group, params, grads)
        return loss

    def _update(self, group: dict, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        raise NotImplementedError


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                         axes: Optional[List[Tuple[str, ...]]] = None, mesh=None) -> None:
    """``optax.clip_by_global_norm`` in place: every g as it is while the
    global norm is below ``max_norm``, else (g / norm) · max_norm. ``axes``:
    for each g that is a block of a global array, the mesh axes that split
    it; their squares are summed over those axes (one all-reduce an axis
    set) and added to the replicated gradients'."""
    if not grads:
        return
    axes = axes or [()] * len(grads)
    norm2 = sum(torch.sum(g.float() * g.float()) for g, a in zip(grads, axes) if not a)
    blocks: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for g, a in zip(grads, axes):
        if a:
            blocks.setdefault(a, []).append(g)
    for a, gs in blocks.items():
        norm2 = norm2 + mesh.all_reduce_(sum(torch.sum(g.float() * g.float()) for g in gs), a)
    norm = torch.sqrt(norm2)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


class Adam(_Optax):
    """``optax.adamw`` (``weight_decay`` 0 is ``optax.adam``) with moments
    stored in ``moment_dtype``. State per param: ``count`` (int32), ``mu``,
    ``nu``."""

    # optax.scale_by_adam squares g first, (1 − b2)·(g·g); the JAX package's
    # scale_by_adam_bf16 scales first, ((1 − b2)·g)·g: each class rounds as
    # its twin does
    square_first = True

    def __init__(
        self,
        params: Iterable,
        lr: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        max_grad_norm: Optional[float] = None,
        moment_dtype: torch.dtype = torch.float32,
    ):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay), max_grad_norm)
        self.moment_dtype = moment_dtype

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["count"] = torch.zeros((), dtype=torch.int32, device=p.device)
            st["mu"] = torch.zeros_like(p, dtype=self.moment_dtype)
            st["nu"] = torch.zeros_like(p, dtype=self.moment_dtype)
        return st

    def _update(self, group, params, grads):
        b1, b2, eps, lr, wd = group["b1"], group["b2"], group["eps"], group["lr"], group["weight_decay"]
        states = [self._state(p) for p in params]
        counts = [s["count"] for s in states]
        torch._foreach_add_(counts, 1)
        mus, nus = [s["mu"] for s in states], [s["nu"] for s in states]
        g32 = [g.float() for g in grads]
        # m = b1·m + (1 − b1)·g;  v = b2·v + (1 − b2)·g·g  (f32)
        m32 = torch._foreach_mul([m.float() for m in mus], b1)
        torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - b1))
        v32 = torch._foreach_mul([v.float() for v in nus], b2)
        if self.square_first:
            sq = torch._foreach_mul(g32, g32)
            torch._foreach_mul_(sq, 1 - b2)
        else:
            sq = torch._foreach_mul(g32, 1 - b2)
            torch._foreach_mul_(sq, g32)
        torch._foreach_add_(v32, sq)
        # bias corrections from the int32 count, in f32 (all counts are equal)
        count = counts[0].float()
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=count.device), count)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=count.device), count)
        den = torch._foreach_div(v32, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(m32, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_copy_(mus, m32)
        torch._foreach_copy_(nus, v32)
        _apply(params, upd, lr, wd)

    def load_state_dict(self, state_dict):
        # torch casts the state of a floating param to the param's dtype on
        # load; the count stays int32 and the moments keep their own type
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if st:
                st["count"] = st["count"].to(torch.int32)
                st["mu"] = st["mu"].to(self.moment_dtype)
                st["nu"] = st["nu"].to(self.moment_dtype)


class AdamBf16(Adam):
    """Adam(W) with both moments stored in bf16 and f32 math — the JAX
    package's ``adam_bf16`` (decay, when given, decoupled as optax's
    ``add_decayed_weights``)."""

    square_first = False

    def __init__(
        self,
        params: Iterable,
        lr: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: Optional[float] = None,
        max_grad_norm: Optional[float] = None,
    ):
        super().__init__(params, lr, b1, b2, eps, weight_decay or 0.0, max_grad_norm, torch.bfloat16)


class Adagrad(_Optax):
    """``optax.adagrad``: the sum of squares starts at
    ``initial_accumulator_value``; update ``g·rsqrt(acc + eps)`` where
    acc > 0, else 0; then ``−lr``."""

    def __init__(
        self,
        params: Iterable,
        lr: float,
        initial_accumulator_value: float = 0.1,
        eps: float = 1e-7,
        max_grad_norm: Optional[float] = None,
    ):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value, eps=eps),
                         max_grad_norm)

    def _update(self, group, params, grads):
        accs = []
        for p in params:
            st = self.state[p]
            if not st:
                st["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
            accs.append(st["sum_of_squares"])
        torch._foreach_add_(accs, torch._foreach_mul(grads, grads))
        upd = []
        for acc, g in zip(accs, grads):
            upd.append(torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0) * g)
        _apply(params, upd, group["lr"], 0.0)


class SGD(_Optax):
    """``optax.sgd`` with no momentum: ``p − lr·g``."""

    def __init__(self, params: Iterable, lr: float, max_grad_norm: Optional[float] = None):
        super().__init__(params, dict(lr=lr), max_grad_norm)

    def _update(self, group, params, grads):
        _apply(params, list(grads), group["lr"], 0.0)


def _apply(params: List[torch.Tensor], updates: List[torch.Tensor], lr: float, weight_decay: float) -> None:
    """updates (+ decay·p), scaled by −lr, added to the params in place."""
    if weight_decay:
        torch._foreach_add_(updates, torch._foreach_mul(params, weight_decay))
    torch._foreach_add_(params, torch._foreach_mul(updates, -lr))

