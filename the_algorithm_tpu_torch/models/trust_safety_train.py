"""Trust & Safety training recipe: k-fold, LR schedules, class weighting,
and in-training rescoring.

Counterpart of ``the_algorithm_tpu/models/trust_safety_train.py``
(``trust_and_safety_models/toxicity/train.py:39-355``): a stratified k-fold
loop over the labeled pool, a per-run LR schedule, pos-weighted BCE by
class imbalance, per-epoch rescoring of the fold's pool that up-weights the
examples the model gets wrong, and per-fold + out-of-fold AUC.

The schedules are optax's, written out as functions of the step in f32
(``warmup_cosine_decay_schedule``, ``join_schedules`` of two
``linear_schedule``\\ s, ``constant_schedule``). optax reads a schedule at the
count *before* the update, so step 0 uses ``sched(0)`` — 0 after a warmup
from 0, a zero first update; the port sets the Adam group's ``lr`` to
``sched(step)`` before each step of ``training/optimizers.Adam``
(``optax.adamw``). JAX draws each fold's parameters from
``PRNGKey(seed·1000 + fold)``, which torch cannot reproduce:
:func:`train_kfold` takes ``init_params(fold)`` (a state dict), and by
default redraws the model from a ``torch.Generator`` seeded the same way.
The batches, the numpy permutations, the rescoring and the AUCs
(``training/metrics.auc``) are JAX's. The text model's token table is read
through ``gather.table_read``: one ``row_gather`` launch a forward and one
``run_collapse_rows`` launch for its gradient, a step.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from the_algorithm_tpu_torch.training import metrics as tmetrics
from the_algorithm_tpu_torch.training.optimizers import Adam


@dataclasses.dataclass(frozen=True)
class RecipeConfig:
    """≡ the argparse surface of ``toxicity/train.py`` (subset that affects
    optimization; data plumbing is the caller's)."""

    folds: int = 5
    epochs: int = 3
    batch_size: int = 64
    learning_rate: float = 1e-3
    schedule: str = "cosine"  # "cosine" | "warmup_linear" | "constant"
    warmup_frac: float = 0.1
    weight_decay: float = 1e-4
    class_weighted: bool = True  # pos-weight BCE by per-head imbalance
    # in-training rescoring: after each epoch, re-weight the pool by the
    # current model's error on it (hard positives get up-weighted)
    rescore: bool = True
    rescore_gamma: float = 2.0
    seed: int = 0


_f32 = np.float32


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule`` (transition_begin 0), in f32."""
    if transition_steps <= 0:
        return lambda count: _f32(init_value)

    def schedule(count):
        count = min(max(int(count), 0), transition_steps)
        frac = _f32(1) - _f32(count) / _f32(transition_steps)
        return _f32(init_value - end_value) * frac + _f32(end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` (exponent 1), in f32."""

    def schedule(count):
        count = _f32(min(int(count), decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * count / _f32(decay_steps)))
        return _f32(init_value) * (_f32(1 - alpha) * cosine + _f32(alpha))

    return schedule


def join_schedules(schedules: Sequence[Callable], boundaries: Sequence[int]) -> Callable[[int], float]:
    """``optax.join_schedules``: schedule i+1 from boundary i on, its step
    counted from the boundary."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = out if step < boundary else s(step - boundary)
        return out

    return schedule


def make_schedule(cfg: RecipeConfig, total_steps: int) -> Callable[[int], float]:
    """≡ ``optim/schedulers.py`` — the per-run LR schedule (f32 values)."""
    warmup = max(int(total_steps * cfg.warmup_frac), 1)
    if cfg.schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps, end_value=0)
        decay_steps = max(total_steps, warmup + 1)
        return join_schedules([linear_schedule(0.0, cfg.learning_rate, warmup),
                               cosine_decay_schedule(cfg.learning_rate, decay_steps - warmup)], [warmup])
    if cfg.schedule == "warmup_linear":
        return join_schedules(
            [linear_schedule(0.0, cfg.learning_rate, warmup),
             linear_schedule(cfg.learning_rate, 0.0, max(total_steps - warmup, 1))],
            [warmup],
        )
    if cfg.schedule == "constant":
        return lambda step: _f32(cfg.learning_rate)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def class_pos_weights(labels: np.ndarray) -> np.ndarray:
    """[H] positive-class weights = neg/pos ratio per head, clipped —
    ≡ the class-imbalance weighting of ``optim/losses.py``."""
    labels = np.asarray(labels, np.float32)
    pos = labels.sum(axis=0)
    neg = labels.shape[0] - pos
    return np.clip(neg / np.maximum(pos, 1.0), 1.0, 100.0).astype(np.float32)


def weighted_bce(
    logits: torch.Tensor,  # [B, H]
    labels: torch.Tensor,  # [B, H]
    pos_weight: torch.Tensor,  # [H]
    sample_weight: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Per-head pos-weighted sigmoid cross entropy × per-example weights."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    per = -(labels * log_p * pos_weight[None, :] + (1.0 - labels) * log_not_p)
    return torch.mean(per * sample_weight[:, None])


def kfold_indices(
    n: int, folds: int, seed: int, stratify: Optional[np.ndarray] = None
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Stratified k-fold split (stratify on the first head's label when
    given, like the reference's StratifiedKFold over toxic labels)."""
    rng = np.random.default_rng(seed)
    order = np.arange(n)
    if stratify is not None:
        # shuffle within class then interleave so every fold sees the
        # class ratio
        strat = np.asarray(stratify).astype(np.int32)
        parts = [rng.permutation(order[strat == v]) for v in np.unique(strat)]
        order = np.concatenate([
            np.concatenate([p[i::folds] for p in parts])
            for i in range(folds)
        ])
        bounds = np.cumsum([
            sum(len(p[i::folds]) for p in parts) for i in range(folds)
        ])
        chunks = np.split(order, bounds[:-1])
    else:
        order = rng.permutation(order)
        chunks = np.array_split(order, folds)
    out = []
    for i in range(folds):
        val = chunks[i]
        train = np.concatenate([c for j, c in enumerate(chunks) if j != i])
        out.append((train, val))
    return out


@dataclasses.dataclass
class FoldResult:
    auc_per_head: np.ndarray  # [H]
    params: Dict[str, torch.Tensor]  # the fold's final state dict


@dataclasses.dataclass
class RecipeResult:
    folds: List[FoldResult]
    oof_auc_per_head: np.ndarray  # [H] out-of-fold AUC
    head_names: Sequence[str]

    @property
    def mean_auc(self) -> float:
        return float(np.mean([f.auc_per_head for f in self.folds]))


def _pad_batch(arrs, start, bs):
    """Slice [start:start+bs], wrapping — fixed shapes for one compile."""
    n = arrs[0].shape[0]
    idx = (np.arange(start, start + bs)) % n
    return [a[idx] for a in arrs], idx


def train_kfold(
    model: torch.nn.Module,
    tokens: np.ndarray,  # [N, L] int32
    mask: np.ndarray,  # [N, L] float32
    labels: np.ndarray,  # [N, H]
    cfg: RecipeConfig = RecipeConfig(),
    init_params: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None,
    on_step: Optional[Callable[[int, int, torch.nn.Module], None]] = None,
) -> RecipeResult:
    """The full recipe: per fold — schedule, class weights, epochs of
    steps, optional per-epoch rescoring — then out-of-fold AUC.

    ``model`` (a ``TextSafetyModel``) is the template: each fold trains a
    copy on the template's device, from ``init_params(fold)`` when given,
    else from ``model.reset_parameters`` drawn with a generator seeded
    ``cfg.seed · 1000 + fold``. ``on_step(fold, step, fold_model)`` is
    called after each step's backward pass, before the update.
    """
    tokens = np.asarray(tokens)
    mask = np.asarray(mask, np.float32)
    labels = np.asarray(labels, np.float32)
    n, H = labels.shape
    head_names = getattr(model, "heads", tuple(f"h{i}" for i in range(H)))
    dev = next(model.parameters()).device
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    splits = kfold_indices(n, cfg.folds, cfg.seed, stratify=labels[:, 0])
    oof_scores = np.zeros((n, H), np.float32)
    fold_results: List[FoldResult] = []

    def forward_probs(m, idx):
        with torch.no_grad():
            return torch.sigmoid(m(on(tokens[idx]), on(mask[idx]))).cpu().numpy()

    for fold, (tr, va) in enumerate(splits):
        m = copy.deepcopy(model)
        if init_params is not None:
            m.load_state_dict(init_params(fold))
        else:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed * 1000 + fold)
            m.reset_parameters(gen)
        m.train()
        steps_per_epoch = max(len(tr) // cfg.batch_size, 1)
        total = steps_per_epoch * cfg.epochs
        sched = make_schedule(cfg, total)
        opt = Adam(m.parameters(), lr=0.0, weight_decay=cfg.weight_decay)
        pos_w = on(class_pos_weights(labels[tr]) if cfg.class_weighted else np.ones(H, np.float32))

        sample_w = np.ones(len(tr), np.float32)
        perm = np.random.default_rng(cfg.seed + fold).permutation(len(tr))
        step = 0
        for epoch in range(cfg.epochs):
            for s in range(steps_per_epoch):
                (tok_b, msk_b, y_b, w_b), _ = _pad_batch(
                    [tokens[tr][perm], mask[tr][perm], labels[tr][perm], sample_w[perm]],
                    s * cfg.batch_size, cfg.batch_size,
                )
                opt.zero_grad(set_to_none=True)
                loss = weighted_bce(m(on(tok_b), on(msk_b)), on(y_b), pos_w, on(w_b))
                loss.backward()
                if on_step is not None:
                    on_step(fold, step, m)
                for group in opt.param_groups:
                    group["lr"] = float(sched(step))  # optax reads the count before the update
                opt.step()
                step += 1
            if cfg.rescore and epoch + 1 < cfg.epochs:
                # in-training rescoring: one forward over the fold's pool;
                # examples the current model gets wrong are up-weighted
                probs = forward_probs(m, tr)
                err = np.abs(labels[tr] - probs).mean(axis=1)
                sample_w = (1.0 + cfg.rescore_gamma * err).astype(np.float32)

        va_probs = forward_probs(m, va)
        oof_scores[va] = va_probs
        aucs = np.asarray([
            float(tmetrics.auc(torch.from_numpy(va_probs[:, h]), torch.from_numpy(labels[va][:, h])))
            for h in range(H)
        ])
        fold_results.append(FoldResult(auc_per_head=aucs, params=m.state_dict()))

    oof_auc = np.asarray([
        float(tmetrics.auc(torch.from_numpy(oof_scores[:, h]), torch.from_numpy(labels[:, h])))
        for h in range(H)
    ])
    return RecipeResult(folds=fold_results, oof_auc_per_head=oof_auc, head_names=head_names)
