"""Pushservice ranking models: light-ranking MLP and ClemNet heavy ranker.

Counterpart of ``the_algorithm_tpu/models/push_rankers.py``
(``pushservice/src/main/python/models/``): the light ranker MLP
(``light_ranking/model_pools_mlp.py:18-32``) and the heavy ranker ClemNet
(``heavy_ranking/lib/layers.py``, ``lib/model.py``): blocks of channel-wise
dense + conv1d + batch norm + activation over a [B, F, C] tensor, then
multi-task heads.

Each model is an ``nn.Module`` called as ``model(x, train=False)``; its
parameters keep flax's layout and names (dense kernels [in, out], the
ChannelWiseDense kernel [C, F, O], the conv kernel as torch's [out, in, k]
from flax's [k, in, out]) and :func:`params_from_flax` carries a flax
``{"params", "batch_stats"}`` over. flax's ``BatchNorm`` is written out
(:class:`BatchNorm`): the biased batch variance E[x²] − E[x]² (clipped at
0), eps 1e-5, ``(x − mean)·(rsqrt(var + eps)·scale) + bias``, and running
stats ``ra = m·ra + (1 − m)·batch`` with m = 0.9999; ``torch.nn.BatchNorm``
takes momentum 1 − m and keeps the unbiased variance in ``running_var``.
``ChannelWiseDense`` stays a ``torch.einsum``: JAX computes it outside any
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from the_algorithm_tpu_torch.core.device import resolve

BN_MOMENTUM = 0.9999  # the reference's batch-norm momentum
BN_EPS = 1e-5  # flax nn.BatchNorm's default

ACTIVATIONS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "tanh": torch.tanh,
               "sigmoid": torch.sigmoid, "swish": F.silu, "silu": F.silu, "elu": F.elu}


def _lecun_normal(shape, fan_in, generator, device) -> torch.Tensor:
    """flax's default kernel init: a normal of variance 1/fan_in truncated at
    two standard deviations (drawn from ``generator``; JAX draws other
    numbers from its key)."""
    t = torch.empty(shape, device=device)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with kernel [in, out]."""

    def __init__(self, n_in: int, n_out: int, device, generator):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal((n_in, n_out), n_in, generator, device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9999)`` over ``axis`` of its input:
    statistics reduce over every other axis."""

    def __init__(self, features: int, axis: int, device, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.axis, self.momentum, self.eps = axis, momentum, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        axis = self.axis % x.dim()
        dims = tuple(d for d in range(x.dim()) if d != axis)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        if train:
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class LightRankingMLP(nn.Module):
    """≡ model_pools_mlp.py: BN → dense stack → linear head."""

    def __init__(self, num_features: int, hidden: Tuple[int, ...] = (200, 100), num_heads: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve(device, "LightRankingMLP")
        self.input_bn = BatchNorm(num_features, -1, dev)
        widths = (num_features,) + tuple(hidden)
        self.dense = nn.ModuleList(Dense(a, b, dev, generator) for a, b in zip(widths, widths[1:]))
        self.head = Dense(widths[-1], num_heads, dev, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.input_bn(x, train)
        for layer in self.dense:
            x = F.relu(layer(x))
        return self.head(x)


class ChannelWiseDense(nn.Module):
    """Per-channel dense: [B, F, C] → [B, O, C] with a [C, F, O] kernel
    (glorot uniform over fan_in F·C and fan_out O·C, as flax computes it)."""

    def __init__(self, num_features: int, channels: int, output_size: int, use_bias: bool = True,
                 device=None, generator=None):
        super().__init__()
        limit = math.sqrt(6.0 / (num_features * channels + output_size * channels))
        kernel = torch.empty((channels, num_features, output_size), device=device)
        self.kernel = nn.Parameter(nn.init.uniform_(kernel, -limit, limit, generator=generator))
        self.bias = nn.Parameter(torch.zeros((output_size, channels), device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.einsum("bfc,cfo->boc", x, self.kernel)
        return out if self.bias is None else out + self.bias[None]


@dataclasses.dataclass(frozen=True)
class ClemNetBlockParams:
    """≡ BlockParams: optional dense/conv/residual stages."""

    dense_size: Optional[int] = None
    conv_filters: Optional[int] = None
    conv_kernel: int = 3
    residual: bool = False
    activation: str = "relu"


class ClemNetBlock(nn.Module):
    """≡ lib/model.py Block2: Optional(ChannelWiseDense+BN+act) →
    Optional(Conv1D+BN+act) → Optional(residual), over [B, F, C]."""

    def __init__(self, params: ClemNetBlockParams, num_features: int, channels: int, device, generator):
        super().__init__()
        self.params = params
        self.act = ACTIVATIONS[params.activation]
        n, c = num_features, channels
        if params.dense_size:
            self.cw_dense = ChannelWiseDense(n, c, params.dense_size, device=device, generator=generator)
            self.dense_bn = BatchNorm(params.dense_size, 1, device)
            n = params.dense_size
        if params.conv_filters:
            k = params.conv_kernel
            # flax's [k, in, out] kernel, held as torch's [out, in, k]
            w = _lecun_normal((k, c, params.conv_filters), k * c, generator, device)
            self.conv_weight = nn.Parameter(w.permute(2, 1, 0).contiguous())
            self.conv_bias = nn.Parameter(torch.zeros(params.conv_filters, device=device))
            self.conv_bn = BatchNorm(n, 1, device)
            c = params.conv_filters
        self.out_shape = (n, c)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        inputs = x
        if self.params.dense_size:
            x = self.act(self.dense_bn(self.cw_dense(x), train))
        if self.params.conv_filters:
            k = self.params.conv_kernel
            pad = (k - 1) // 2, k - 1 - (k - 1) // 2  # flax's SAME at stride 1
            y = F.conv1d(F.pad(x.permute(0, 2, 1), pad), self.conv_weight, self.conv_bias)
            x = self.act(self.conv_bn(y.permute(0, 2, 1), train))
        if self.params.residual and inputs.shape == x.shape:
            x = x + inputs
        return x


DEFAULT_BLOCKS = (
    ClemNetBlockParams(dense_size=128, conv_filters=4),
    ClemNetBlockParams(dense_size=64, conv_filters=4, residual=True),
)


class ClemNet(nn.Module):
    """Residual block stack + flatten + multi-task heads over x [B, F] or
    [B, F, C]."""

    def __init__(self, num_features: int, blocks: Sequence[ClemNetBlockParams] = DEFAULT_BLOCKS,
                 num_heads: int = 3, channels: int = 1, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve(device, "ClemNet")
        self.blocks = nn.ModuleList()
        n, c = num_features, channels
        for bp in blocks:
            block = ClemNetBlock(bp, n, c, dev, generator)
            self.blocks.append(block)
            n, c = block.out_shape
        self.heads = Dense(n * c, num_heads, dev, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, :, None]
        for block in self.blocks:
            x = block(x, train)
        return self.heads(x.reshape(x.shape[0], -1))


def _bn_from_flax(bn: BatchNorm, p: Mapping, s: Mapping) -> None:
    bn.scale.copy_(_t(p["scale"])), bn.bias.copy_(_t(p["bias"]))
    bn.mean.copy_(_t(s["mean"])), bn.var.copy_(_t(s["var"]))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _dense_from_flax(d: Dense, p: Mapping) -> None:
    d.kernel.copy_(_t(p["kernel"])), d.bias.copy_(_t(p["bias"]))


@torch.no_grad()
def params_from_flax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax ``{"params", "batch_stats"}`` (numpy or JAX arrays) of the
    JAX package's twin into ``model`` in place; returns the model."""
    p, s = variables["params"], variables.get("batch_stats", {})
    if isinstance(model, LightRankingMLP):
        _bn_from_flax(model.input_bn, p["input_bn"], s["input_bn"])
        for i, d in enumerate(model.dense):
            _dense_from_flax(d, p[f"dense_{i}"])
        _dense_from_flax(model.head, p["head"])
        return model
    if isinstance(model, ClemNet):
        for i, block in enumerate(model.blocks):
            bp, bs = p[f"block_{i}"], s.get(f"block_{i}", {})
            if block.params.dense_size:
                block.cw_dense.kernel.copy_(_t(bp["cw_dense"]["kernel"]))
                if block.cw_dense.bias is not None:
                    block.cw_dense.bias.copy_(_t(bp["cw_dense"]["bias"]))
                _bn_from_flax(block.dense_bn, bp["dense_bn"], bs["dense_bn"])
            if block.params.conv_filters:
                block.conv_weight.copy_(_t(bp["conv"]["kernel"]).permute(2, 1, 0))
                block.conv_bias.copy_(_t(bp["conv"]["bias"]))
                _bn_from_flax(block.conv_bn, bp["conv_bn"], bs["conv_bn"])
        _dense_from_flax(model.heads, p["heads"])
        return model
    raise TypeError(f"no flax layout for {type(model).__name__}")


def batch_stats(model: nn.Module) -> dict:
    """The model's running stats as flax's ``batch_stats`` tree (numpy)."""
    host = lambda bn: {"mean": bn.mean.cpu().numpy(), "var": bn.var.cpu().numpy()}  # noqa: E731
    if isinstance(model, LightRankingMLP):
        return {"input_bn": host(model.input_bn)}
    out = {}
    for i, block in enumerate(model.blocks):
        b = {}
        if block.params.dense_size:
            b["dense_bn"] = host(block.dense_bn)
        if block.params.conv_filters:
            b["conv_bn"] = host(block.conv_bn)
        out[f"block_{i}"] = b
    return out
