"""MaskNet multi-task heavy ranker — the recap ranking model.

Counterpart of ``the_algorithm_tpu/models/masknet.py`` (forward and the
weighted head score; the loss and the partition rules come with training).
Parallel MaskNet (Wang et al. 2021, arXiv:2102.07619): G instance-guided
mask blocks over one layer-normed input, fused into two wide products
F→G·A (mask aggregation) and F→G·D (hidden branches), a G-batched A→D mask
projection, per-block layer norms, then a shared trunk and multi-task
sigmoid heads. In the bf16 config the products run in bf16 (accumulating in
f32 on the card) and the layer-norm statistics and the heads in f32, as in
the JAX package.

:func:`params_from_flax` turns the JAX package's flax params into this
module's ``state_dict``, so both compute the same function on the same
weights.
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

        agg = F.relu(F.linear(x, self.mask_agg.weight.to(dt), self.mask_agg.bias.to(dt)))
        agg = agg.reshape(-1, G, A)
        mask = torch.einsum("bga,gad->bgd", agg, self.mask_proj.to(dt)) + self.mask_proj_bias.to(dt)

        hidden = F.linear(x, self.hidden.weight.to(dt)).reshape(-1, G, D)
        hidden = self.hidden_ln(hidden)
        h = F.relu(self.out_ln(mask * hidden)).reshape(-1, G * D)
        for lin in self.trunk:
            h = F.relu(F.linear(h, lin.weight.to(dt), lin.bias.to(dt)))
        return self.heads(h.float())


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
