"""MaskNet multi-task heavy ranker — the recap ranking model.

Counterpart of ``the_algorithm_tpu/models/masknet.py``: the forward, the
weighted head score, the multi-task loss and the partition rules.
Parallel MaskNet (Wang et al. 2021, arXiv:2102.07619): G instance-guided
mask blocks over one layer-normed input, fused into two wide products
F→G·A (mask aggregation) and F→G·D (hidden branches), a G-batched A→D mask
projection, per-block layer norms, then a shared trunk and multi-task
sigmoid heads. In the bf16 config the products run in bf16 (accumulating in
f32 on the card) and the layer-norm statistics and the heads in f32, as in
the JAX package. The products cast the f32 parameters to the compute type
inside the op, so a gradient flows back through the cast into the f32
parameter, as flax's does.

:func:`params_from_flax` turns the JAX package's flax params into this
module's ``state_dict``, so both compute the same function on the same
weights; :func:`params_to_flax` is its inverse, the names and layouts an
export writes.

Under :data:`PARTITION_RULES` (the JAX package's, verbatim) on a mesh, the
wide products ``mask_agg``, ``hidden`` and ``trunk_0`` keep this rank's
output columns (``P(None, 'model')`` on a flax kernel: dim 0 of the torch
weight). The forward multiplies by its columns and gathers them over
'model' before anything reads across columns (``hidden_ln``'s groups may be
cut), then adds the replicated bias; the gather's backward keeps this
rank's columns, and the product's input sums its cotangent over 'model'
(``core/mesh.gather_columns`` and ``sum_grad``). A whole weight takes the
single-device path, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.core.mesh import MODEL_AXIS, gather_columns, get_mesh, sum_grad
from the_algorithm_tpu_torch.core.partition import P

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class MaskNetConfig:
    num_features: int = 6000  # home-mixer/README.md:22-24
    num_heads: int = 15  # PredictedScoreFeature.scala head registry
    mask_blocks: int = 4
    block_dim: int = 512
    aggregation_dim: int = 128  # bottleneck inside the instance-guided mask
    head_hidden: Tuple[int, ...] = (256, 128)
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _device(device) -> torch.device:
    """The device to build on: the card unless the caller names another."""
    return resolve(device, "MaskNet")


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal (±2σ) of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # σ of the ±2σ truncation
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class GroupLayerNorm(nn.Module):
    """Layer norm over the last axis of [B, G, D] with a (G, D) affine —
    flax ``LayerNorm(reduction_axes=-1, feature_axes=(-2, -1))``. Statistics
    and affine run in f32; the result is cast to ``dtype``. Built on the card
    unless ``device`` names another."""

    FLAX_SCALE = True  # its weight is flax's ``scale``

    def __init__(self, groups: int, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        device = _device(device)
        self.weight = nn.Parameter(torch.ones(groups, dim, device=device))
        self.bias = nn.Parameter(torch.zeros(groups, dim, device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), eps=LN_EPS)
        return (y * self.weight + self.bias).to(self.dtype)


class MaskNet(nn.Module):
    """Parallel MaskNet with multi-task sigmoid heads: features [B, F] f32 →
    logits [B, H] f32. Parameters are f32; ``config.dtype`` sets the
    compute type of the products. Built on the card unless ``device`` names
    another; with no card and no ``device``, it raises."""

    FLAX_COLLECTION = "params"  # its JAX names: core/partition.flax_layout

    def __init__(
        self,
        config: MaskNetConfig,
        *,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = _device(device)
        self.config = config
        cfg = config
        Fdim, G, D, A = cfg.num_features, cfg.mask_blocks, cfg.block_dim, cfg.aggregation_dim
        dt = cfg.compute_dtype
        self.input_ln = nn.LayerNorm(Fdim, eps=LN_EPS, device=device)
        self.mask_agg = nn.Linear(Fdim, G * A, device=device)
        self.mask_proj = nn.Parameter(torch.empty(G, A, D, device=device))
        self.mask_proj_bias = nn.Parameter(torch.zeros(G, D, device=device))
        self.hidden = nn.Linear(Fdim, G * D, bias=False, device=device)
        self.hidden_ln = GroupLayerNorm(G, D, dt, device=device)
        self.out_ln = GroupLayerNorm(G, D, dt, device=device)
        widths = (G * D,) + tuple(cfg.head_hidden)
        self.trunk = nn.ModuleList(
            nn.Linear(widths[j], widths[j + 1], device=device) for j in range(len(cfg.head_hidden))
        )
        self.heads = nn.Linear(widths[-1], cfg.num_heads, device=device)

        # flax defaults: lecun-normal kernels (fan_in A per mask block, G is a
        # batch axis of mask_proj), zero biases, unit layer-norm scales
        for lin in [self.mask_agg, self.hidden, *self.trunk, self.heads]:
            _lecun_normal_(lin.weight, lin.in_features, generator)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)
        _lecun_normal_(self.mask_proj, A, generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        G, D, A = cfg.mask_blocks, cfg.block_dim, cfg.aggregation_dim
        x = self.input_ln(features.float()).to(dt)

        agg = F.relu(self._product(x, self.mask_agg, G * A))
        agg = agg.reshape(-1, G, A)
        mask = torch.einsum("bga,gad->bgd", agg, self.mask_proj.to(dt)) + self.mask_proj_bias.to(dt)

        hidden = self._product(x, self.hidden, G * D).reshape(-1, G, D)
        hidden = self.hidden_ln(hidden)
        h = F.relu(self.out_ln(mask * hidden)).reshape(-1, G * D)
        for lin in self.trunk:
            h = F.relu(self._product(h, lin, lin.out_features))
        return self.heads(h.float())

    def _product(self, x: torch.Tensor, lin: nn.Linear, width: int) -> torch.Tensor:
        """``lin(x)`` in the compute type; a weight holding this rank's
        block of its ``width`` output columns (:data:`PARTITION_RULES`)
        multiplies by them, gathers the columns over 'model', then adds the
        replicated bias."""
        dt = self.config.compute_dtype
        bias = None if lin.bias is None else lin.bias.to(dt)
        if lin.weight.shape[0] == width:
            return F.linear(x, lin.weight.to(dt), bias)
        mesh = get_mesh()
        y = gather_columns(F.linear(sum_grad(x, mesh, MODEL_AXIS), lin.weight.to(dt)), mesh, MODEL_AXIS)
        return y if bias is None else y + bias


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax params (a nested dict of arrays, with or
    without the top-level ``"params"`` key) → this module's ``state_dict``.

    A flax ``Dense`` kernel is [in, out]; a torch ``Linear`` weight is
    [out, in]. Layer norms map ``scale`` → ``weight``.
    """
    p = tree.get("params", tree)

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {
        "input_ln.weight": t(p["input_ln"]["scale"]),
        "input_ln.bias": t(p["input_ln"]["bias"]),
        "mask_agg.weight": t(p["mask_agg"]["kernel"]).T.contiguous(),
        "mask_agg.bias": t(p["mask_agg"]["bias"]),
        "mask_proj": t(p["mask_proj"]),
        "mask_proj_bias": t(p["mask_proj_bias"]),
        "hidden.weight": t(p["hidden"]["kernel"]).T.contiguous(),
        "hidden_ln.weight": t(p["hidden_ln"]["scale"]),
        "hidden_ln.bias": t(p["hidden_ln"]["bias"]),
        "out_ln.weight": t(p["out_ln"]["scale"]),
        "out_ln.bias": t(p["out_ln"]["bias"]),
        "heads.weight": t(p["heads"]["kernel"]).T.contiguous(),
        "heads.bias": t(p["heads"]["bias"]),
    }
    j = 0
    while f"trunk_{j}" in p:
        sd[f"trunk.{j}.weight"] = t(p[f"trunk_{j}"]["kernel"]).T.contiguous()
        sd[f"trunk.{j}.bias"] = t(p[f"trunk_{j}"]["bias"])
        j += 1
    return sd


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The inverse of :func:`params_from_flax`: this module's ``state_dict``
    → the JAX package's nested params ``{"params": {...}}`` of f32 numpy
    arrays, with the kernels transposed back to [in, out]."""

    def a(name: str, transpose: bool = False) -> np.ndarray:
        x = state_dict[name].detach().to("cpu", torch.float32)
        return (x.T if transpose else x).contiguous().numpy()

    p = {
        "input_ln": {"scale": a("input_ln.weight"), "bias": a("input_ln.bias")},
        "mask_agg": {"kernel": a("mask_agg.weight", True), "bias": a("mask_agg.bias")},
        "mask_proj": a("mask_proj"),
        "mask_proj_bias": a("mask_proj_bias"),
        "hidden": {"kernel": a("hidden.weight", True)},
        "hidden_ln": {"scale": a("hidden_ln.weight"), "bias": a("hidden_ln.bias")},
        "out_ln": {"scale": a("out_ln.weight"), "bias": a("out_ln.bias")},
        "heads": {"kernel": a("heads.weight", True), "bias": a("heads.bias")},
    }
    j = 0
    while f"trunk.{j}.weight" in state_dict:
        p[f"trunk_{j}"] = {"kernel": a(f"trunk.{j}.weight", True), "bias": a(f"trunk.{j}.bias")}
        j += 1
    return {"params": p}


# -- weighted multi-head score (NaviModelScorer.computeWeightedModelScore) ---

EPSILON = 1e-6


def weighted_model_score(probs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """≡ ``NaviModelScorer.computeWeightedModelScore:143-177``.

    combined = Σ w_h·p_h ; negative combined scores are shifted/rescaled into
    (0, ε] so they rank below every positive score but keep their order.
    """
    weights = weights.to(probs.device, probs.dtype)
    combined = torch.sum(probs * weights, dim=-1)
    pos_sum = torch.sum(torch.clamp(weights, min=0.0))
    neg_sum = torch.abs(torch.sum(torch.clamp(weights, max=0.0)))
    total = pos_sum + neg_sum
    rescaled_neg = (combined + neg_sum) / torch.clamp(total, min=1e-30) * EPSILON
    return torch.where(
        total == 0,
        torch.clamp(combined, min=0.0),
        torch.where(combined < 0, rescaled_neg, combined + EPSILON),
    )


def score_fn(model: MaskNet, weights: torch.Tensor) -> Callable[[np.ndarray], np.ndarray]:
    """The ranker's batched predict fn for the serving edge: features
    [B, F] → ``weighted_model_score`` of the sigmoid heads [B], numpy in and
    out, computed on the model's device."""
    device = next(model.parameters()).device
    w = weights.to(device)

    def predict(features: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(features, np.float32)).to(device)
        with torch.inference_mode():
            probs = torch.sigmoid(model(x))
            return weighted_model_score(probs, w).cpu().numpy()

    return predict


def predict_fn(model: MaskNet) -> Callable[[np.ndarray], np.ndarray]:
    """The per-request pipeline's predict fn (``home_mixer.MaskNetScorer``):
    features [B, F] → the sigmoid heads [B, H] f32, numpy in and out,
    computed on the model's device."""
    device = next(model.parameters()).device

    def predict(features: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(features, np.float32)).to(device)
        with torch.inference_mode():
            return torch.sigmoid(model(x)).cpu().numpy()

    return predict


def multi_task_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean per-head sigmoid cross-entropy (the standard multi-task recap loss)."""
    losses = optax_sigmoid_ce(logits, labels)
    if mask is not None:
        losses = losses * mask
        return torch.sum(losses) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(losses)


PARTITION_RULES = [
    # wide fused kernels shard over 'model' on the output dim; patterns are
    # anchored so future modules whose paths merely contain these names
    # don't accidentally match
    (r"(^|/)hidden/kernel$", P(None, "model")),
    (r"(^|/)mask_agg/kernel$", P(None, "model")),
    (r"(^|/)trunk_0/kernel$", P(None, "model")),
    (r".*", P()),
]


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-y·logσ(z) − (1−y)·logσ(−z), as the JAX package writes it (not
    ``binary_cross_entropy_with_logits``, whose formula rounds otherwise)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


# default head weights shaped like HomeGlobalParams.Scoring.ModelWeights —
# fav/reply/retweet positive, negative-feedback/report negative
DEFAULT_HEAD_NAMES: Sequence[str] = (
    "fav", "reply", "retweet", "reply_engaged_by_author",
    "good_click_convo", "good_click_profile", "good_profile_click",
    "video_quality_view", "bookmark", "share", "dwell",
    "open_link", "screenshot", "negative_feedback_v2", "report",
)
DEFAULT_HEAD_WEIGHTS = torch.tensor(
    [1.0, 13.5, 1.0, 75.0, 12.0, 12.0, 10.0, 0.005, 0.3, 1.0, 0.005,
     0.1, 1.0, -74.0, -369.0],
    dtype=torch.float32,
)
