"""Trust & Safety classifiers: pToxicity / pNSFW-text / pNSFW-media / pAbuse.

Counterpart of ``the_algorithm_tpu/models/trust_safety.py``
(``trust_and_safety_models/``): one compact text encoder (token embedding +
pre-LN transformer blocks, mean-pooled over valid tokens) shared by the
toxicity / nsfw / abuse heads, and a small stride-2 conv net over media.

As flax computes them:

- the token embedding (``nn.Embed``) is read through
  :func:`~the_algorithm_tpu_torch.ops.gather.table_read`: one
  ``row_gather`` launch a forward, and its gradient one
  ``run_collapse_rows`` launch;
- ``nn.MultiHeadDotProductAttention``: q/k/v kernels [dim, heads,
  head_dim], the output kernel [heads, head_dim, dim]; the query divided by
  √head_dim before the product; masked logits set to ``finfo(f32).min``
  (a text with no token gets uniform weights, not NaN); an f32 softmax —
  written out as einsums, not ``scaled_dot_product_attention``;
- ``nn.LayerNorm`` eps 1e-6, ``nn.gelu`` the tanh approximation;
- ``nn.Conv`` with SAME padding at stride 2 pads (0, 1) on an even side and
  (1, 1) on an odd one (``lax.padtype_to_pads``): padded explicitly, the
  [kh, kw, in, out] kernel held as [out, in, kh, kw], images NHWC in.

:func:`params_from_flax` carries a flax ``{"params"}`` tree over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops.gather import table_read
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

LN_EPS = 1e-6  # flax nn.LayerNorm's default
F32_MIN = float(np.finfo(np.float32).min)  # flax's masked attention logit


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 32768  # hashed-token vocabulary
    max_len: int = 128
    dim: int = 128
    heads: int = 4
    layers: int = 2
    mlp_ratio: int = 4


def _normal(shape, std, generator, device) -> torch.Tensor:
    return torch.empty(shape, device=device).normal_(0.0, std, generator=generator)


def _lecun(shape, fan_in, generator, device) -> torch.Tensor:
    """flax's default kernel init (lecun normal, truncated at 2σ)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape, device=device), 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, LN_EPS)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with kernel [in, out]."""

    def __init__(self, n_in: int, n_out: int, device, generator):
        super().__init__()
        self.kernel = nn.Parameter(_lecun((n_in, n_out), n_in, generator, device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class Attention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, key mask)."""

    def __init__(self, dim: int, heads: int, device, generator):
        super().__init__()
        hd = dim // heads
        for name in ("query", "key", "value"):
            self.register_parameter(f"{name}_kernel", nn.Parameter(_lecun((dim, heads, hd), dim, generator, device)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros((heads, hd), device=device)))
        self.out_kernel = nn.Parameter(_lecun((heads, hd, dim), dim, generator, device))
        self.out_bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, L, D], mask [B, L] (nonzero = a valid key) → [B, L, D]."""
        q = torch.einsum("bld,dhk->blhk", x, self.query_kernel) + self.query_bias
        k = torch.einsum("bld,dhk->blhk", x, self.key_kernel) + self.key_bias
        v = torch.einsum("bld,dhk->blhk", x, self.value_kernel) + self.value_bias
        q = q / np.float32(math.sqrt(q.shape[-1]))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask[:, None, None, :] != 0, logits, F32_MIN)
        w = torch.softmax(logits.float(), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return torch.einsum("bqhd,hdo->bqo", out, self.out_kernel) + self.out_bias


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, device, generator):
        super().__init__()
        self.ln1 = LayerNorm(dim, device)
        self.attn = Attention(dim, heads, device, generator)
        self.ln2 = LayerNorm(dim, device)
        self.mlp_up = Dense(dim, dim * mlp_ratio, device, generator)
        self.mlp_down = Dense(dim * mlp_ratio, dim, device, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        h = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(h)


class TextEncoder(nn.Module):
    """Token ids [B, L] (+ mask) → pooled [B, D] (mean over valid tokens)."""

    def __init__(self, config: TextEncoderConfig, device, generator):
        super().__init__()
        cfg = self.config = config
        # flax's default_embed_init: variance_scaling(1, fan_in, normal, out_axis=0)
        self.token_emb = nn.Parameter(_normal((cfg.vocab_size, cfg.dim), 1.0 / math.sqrt(cfg.dim), generator, device))
        self.pos_emb = nn.Parameter(_normal((cfg.max_len, cfg.dim), 0.02, generator, device))
        self.blocks = nn.ModuleList(TransformerBlock(cfg.dim, cfg.heads, cfg.mlp_ratio, device, generator)
                                    for _ in range(cfg.layers))
        self.final_ln = LayerNorm(cfg.dim, device)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = table_read(self.token_emb, tokens.to(torch.int32)) + self.pos_emb[None, : tokens.shape[1]]
        for block in self.blocks:
            x = block(x, mask)
        x = self.final_ln(x)
        denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
        return torch.sum(x * mask[:, :, None], dim=1) / denom


class TextSafetyModel(nn.Module):
    """Shared encoder + named binary heads (toxicity, nsfw, abuse)."""

    def __init__(self, config: TextEncoderConfig = TextEncoderConfig(),
                 heads: Tuple[str, ...] = ("toxicity", "nsfw", "abuse"), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config, self.heads = config, tuple(heads)
        self.device = resolve(device, "TextSafetyModel")
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter anew from ``generator``."""
        self.encoder = TextEncoder(self.config, self.device, generator)
        self.cls = Dense(self.config.dim, len(self.heads), self.device, generator)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.cls(self.encoder(tokens, mask))


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax's SAME padding of one spatial side: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class MediaSafetyModel(nn.Module):
    """Small conv net over [B, H, W, 3] media (≡ nsfw_media.py keras CNN)."""

    def __init__(self, widths: Tuple[int, ...] = (16, 32, 64), num_heads: int = 1, in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve(device, "MediaSafetyModel")
        self.widths = tuple(widths)
        self.conv_weight = nn.ParameterList()
        self.conv_bias = nn.ParameterList()
        c = in_channels
        for w in self.widths:
            k = _lecun((3, 3, c, w), 9 * c, generator, dev)
            self.conv_weight.append(nn.Parameter(k.permute(3, 2, 0, 1).contiguous()))
            self.conv_bias.append(nn.Parameter(torch.zeros(w, device=dev)))
            c = w
        self.head = Dense(c, num_heads, dev, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)  # NHWC → NCHW
        for w, b in zip(self.conv_weight, self.conv_bias):
            (ht, hb), (wl, wr) = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
            x = F.relu(F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, b, stride=2))
        return self.head(x.mean(dim=(2, 3)))


def tokenize_text(text: str, config: TextEncoderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash-token text → (ids [L] int32, mask [L] f32) through the port's
    earlybird tokenizer: ids are the tokens mod the vocabulary, 0 on pads."""
    from the_algorithm_tpu_torch.search.earlybird import tokenize

    toks = np.asarray(tokenize(text, config.max_len))
    valid = toks != int(PAD_ID)
    ids = np.where(valid, toks % config.vocab_size, 0).astype(np.int32)
    return torch.from_numpy(ids), torch.from_numpy(valid.astype(np.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


@torch.no_grad()
def params_from_flax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load the JAX twin's flax ``{"params"}`` (numpy or JAX arrays) into
    ``model`` in place; returns the model."""
    p = variables["params"]

    def dense(d, q):
        d.kernel.copy_(_t(q["kernel"])), d.bias.copy_(_t(q["bias"]))

    def ln(n, q):
        n.scale.copy_(_t(q["scale"])), n.bias.copy_(_t(q["bias"]))

    if isinstance(model, TextSafetyModel):
        e, pe = model.encoder, p["encoder"]
        e.token_emb.copy_(_t(pe["token_emb"]["embedding"]))
        e.pos_emb.copy_(_t(pe["pos_emb"]))
        for i, block in enumerate(e.blocks):
            pb = pe[f"block_{i}"]
            ln(block.ln1, pb["ln1"]), ln(block.ln2, pb["ln2"])
            for name in ("query", "key", "value", "out"):
                getattr(block.attn, f"{name}_kernel").copy_(_t(pb["attn"][name]["kernel"]))
                getattr(block.attn, f"{name}_bias").copy_(_t(pb["attn"][name]["bias"]))
            dense(block.mlp_up, pb["mlp_up"]), dense(block.mlp_down, pb["mlp_down"])
        ln(e.final_ln, pe["final_ln"])
        dense(model.cls, p["cls"])
        return model
    if isinstance(model, MediaSafetyModel):
        for i, (w, b) in enumerate(zip(model.conv_weight, model.conv_bias)):
            w.copy_(_t(p[f"conv_{i}"]["kernel"]).permute(3, 2, 0, 1))
            b.copy_(_t(p[f"conv_{i}"]["bias"]))
        dense(model.head, p["head"])
        return model
    raise TypeError(f"no flax layout for {type(model).__name__}")
