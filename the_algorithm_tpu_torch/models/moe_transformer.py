"""DeepSeek-V3 decoder layers (Moonlight-16B-A3B's): latent attention with
decoupled RoPE, RMSNorm, a SwiGLU dense layer and routed + shared experts.

Phoenix's second block kind (:class:`~the_algorithm_tpu_torch.models.phoenix.PhoenixConfig`
with a ``decoder``) runs its history through a stack of these layers. The
JAX package has no counterpart; the published layer
(``modeling_deepseek.py`` of the Hugging Face checkpoints, the
DeepSeek-V3 report) is the source, held to the plain f32 reference in
``tests/phoenix_moonlight_reference.py``. A layer over [B, L, D]:

    h = x + o_proj(MLA(rmsnorm(x)))
    y = h + FFN(rmsnorm(h))
    FFN = SwiGLU in the first ``first_k_dense_replace`` layers;
          shared(x) + Σ_{e ∈ top-k} w_e · expert_e(x) in the others

- MLA: q = q_proj(x) split per head into nope and rope parts (``q_lora_rank``
  null: no q compression); kv_a_proj_with_mqa(x) = the 512-wide latent and
  a 64-wide rope key shared by every head; RMSNorm on the latent, then
  kv_b_proj to each head's nope key and value. RoPE (θ = ``rope_theta``, no
  scaling) rotates the pairs (2i, 2i+1) of the rope parts by position ·
  θ^(-2i/d): the checkpoint's de-interleave-then-rotate-half, whose
  permutation of q's and k's rope parts alike leaves every q·k unchanged.
  Softmax scale 1/√(nope + rope). Positions are the history's slots.
- Router: f32 logits of the bf16 normed hidden state, sigmoid scores; the
  top-k of score + ``e_score_correction_bias`` chooses the experts (the bias
  chooses only: ``noaux_tc`` with one group); the chosen unbiased scores,
  normalised (``norm_topk_prob``) and × ``routed_scaling_factor``, weight
  them.
- Routed experts: :mod:`~the_algorithm_tpu_torch.ops.expert_gemm` (one
  dispatch, two grouped-GEMM launches, one combine a layer). Shared experts:
  one SwiGLU ``n_shared_experts`` times the expert width.

Precision: parameters in the compute type (bf16: the checkpoint's dtype)
except the norms' weights and the correction bias (f32). Norms, router and
softmax statistics in f32; products in bf16 with f32 accumulation, each
rounded to bf16 (SwiGLU of the routed experts on the f32 sums; the routed
combine, shared expert and residual summed in f32 and rounded once).

Departures from the published layer:

- the attention logits are masked by a key mask too: a left-padded history's
  padding is never attended to by a valid token. A query that may attend to
  no key (a padding slot) attends uniformly (every logit the same fill,
  ``MASK_NEG``): finite, and read by no valid token;
- the softmax scale is folded into q before the product (one bf16 rounding,
  where the checkpoint rounds the scaled logits);
- every slot, padding included, goes through the experts (the batch's
  shapes are fixed);
- no token embedding and no LM head (Phoenix's tables and action head take
  their place), no MTP layer (``num_nextn_predict_layers`` 0), no KV cache:
  the whole history is encoded in one pass.

Spans (``core/metrics.span``): ``phoenix.attention`` a layer's MLA,
``phoenix.moe.route``, ``phoenix.moe.dispatch``, ``phoenix.moe.experts``
(shared and routed), ``phoenix.moe.combine``. Each MoE layer keeps the
last forward's per-expert slot counts as a device tensor
(:attr:`MoE.last_counts`) and, while a caller sets ``route_log`` to a list,
appends its chosen experts [T, k].
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from the_algorithm_tpu_torch.core.metrics import span
from the_algorithm_tpu_torch.ops import expert_gemm

MASK_NEG = -1e9  # the fill of a masked attention logit (Phoenix's additive mask value)


@dataclasses.dataclass(frozen=True)
class MoEDecoderConfig:
    """The DeepSeek-V3 keys of the stack (Moonlight-16B-A3B's published
    values by default). Hidden size, heads and layers are
    ``PhoenixConfig.d_model``, ``n_heads`` and ``n_layers``."""

    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True


def _weight(shape, dtype, device, generator) -> nn.Parameter:
    """A [.., out, in] weight, normal of variance 1/in (lecun scale)."""
    w = torch.empty(shape, dtype=dtype, device=device)
    nn.init.normal_(w, std=1.0 / math.sqrt(shape[-1]), generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """A bias-free projection held in the compute type, [out, in]."""

    def __init__(self, d_in: int, d_out: int, dtype, device, generator):
        super().__init__()
        self.weight = _weight((d_out, d_in), dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)


class RMSNorm(nn.Module):
    """RMSNorm in f32 (f32 weight), rounded to the input's type."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight, self.eps).to(x.dtype)


def rope_tables(length: int, dim: int, theta: float, device) -> torch.Tensor:
    """[2, length, dim / 2] f32: cos and sin of position · θ^(-2i/dim)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.stack([ang.cos(), ang.sin()])


def apply_rope(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (2i, 2i+1) of ``x`` [B, L, H, d] by ``rope``'s
    angles at each slot, in f32, rounded to ``x``'s type."""
    cos, sin = rope[0][None, :, None, :], rope[1][None, :, None, :]
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).flatten(-2).to(x.dtype)


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))`` with library products (the dense
    layer and the shared experts)."""

    def __init__(self, d: int, width: int, dtype, device, generator):
        super().__init__()
        self.gate_proj = Linear(d, width, dtype, device, generator)
        self.up_proj = Linear(d, width, dtype, device, generator)
        self.down_proj = Linear(width, d, dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MLA(nn.Module):
    """Multi-head latent attention with decoupled RoPE (``q_lora_rank``
    null), causal over the history's valid slots."""

    def __init__(self, d: int, n_heads: int, c: MoEDecoderConfig, dtype, device, generator):
        super().__init__()
        self.n_heads, self.c = n_heads, c
        self.qk_dim = c.qk_nope_head_dim + c.qk_rope_head_dim
        self.q_proj = Linear(d, n_heads * self.qk_dim, dtype, device, generator)
        self.kv_a_proj_with_mqa = Linear(d, c.kv_lora_rank + c.qk_rope_head_dim, dtype, device, generator)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, device)
        self.kv_b_proj = Linear(c.kv_lora_rank, n_heads * (c.qk_nope_head_dim + c.v_head_dim), dtype, device,
                                generator)
        self.o_proj = Linear(n_heads * c.v_head_dim, d, dtype, device, generator)

    def forward(self, x: torch.Tensor, rope: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        """x [B, L, D] normed; ``allowed`` [B, 1, L, L] bool (query, key)."""
        B, L, _ = x.shape
        H, c = self.n_heads, self.c
        nope, rp = c.qk_nope_head_dim, c.qk_rope_head_dim
        q = self.q_proj(x).view(B, L, H, self.qk_dim)
        kv = self.kv_a_proj_with_mqa(x)
        latent, k_pe = kv.split([c.kv_lora_rank, rp], dim=-1)
        kvb = self.kv_b_proj(self.kv_a_layernorm(latent)).view(B, L, H, nope + c.v_head_dim)
        k_nope, v = kvb.split([nope, c.v_head_dim], dim=-1)
        q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], rope)], dim=-1) * (1.0 / math.sqrt(self.qk_dim))
        k_pe = apply_rope(k_pe[:, :, None, :], rope).expand(B, L, H, rp)
        k = torch.cat([k_nope, k_pe], dim=-1)
        logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))  # [B, H, L, L]
        logits.masked_fill_(~allowed, MASK_NEG)
        w = torch.softmax(logits, dim=-1)  # f32 inside, rounded to the compute type
        o = torch.matmul(w, v.transpose(1, 2))  # [B, H, L, v]
        return self.o_proj(o.transpose(1, 2).reshape(B, L, H * c.v_head_dim))


class MoE(nn.Module):
    """Sigmoid-routed experts (``noaux_tc``, one group) plus shared experts,
    over flattened tokens; returns ``residual + FFN(x)``."""

    def __init__(self, d: int, c: MoEDecoderConfig, dtype, device, generator):
        super().__init__()
        E, I = c.n_routed_experts, c.moe_intermediate_size
        self.c = c
        self.gate = nn.Module()
        self.gate.weight = _weight((E, d), dtype, device, generator)
        self.gate.e_score_correction_bias = nn.Parameter(torch.zeros(E, device=device))
        self.experts = nn.Module()
        self.experts.gate_proj = _weight((E, I, d), dtype, device, generator)
        self.experts.up_proj = _weight((E, I, d), dtype, device, generator)
        self.experts.down_proj = _weight((E, d, I), dtype, device, generator)
        self.shared_experts = SwiGLU(d, I * c.n_shared_experts, dtype, device, generator)
        self.last_counts: Optional[torch.Tensor] = None  # [E] slots an expert, the last forward's
        self.route_log: Optional[List[torch.Tensor]] = None  # a caller's list: each forward's [T, k] experts

    def route(self, x: torch.Tensor):
        """(experts [T, k], weights [T, k] f32) of tokens x [T, D]."""
        c = self.c
        scores = torch.sigmoid(F.linear(x.float(), self.gate.weight.float()))
        idx = torch.topk(scores + self.gate.e_score_correction_bias, c.num_experts_per_tok, dim=-1,
                         sorted=False).indices
        w = scores.gather(1, idx)
        if c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * c.routed_scaling_factor

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """x [T, D] normed, residual [T, D] → residual + FFN(x)."""
        with span("phoenix.moe.route"):
            idx, w = self.route(x)
        if self.route_log is not None:
            self.route_log.append(idx)
        with span("phoenix.moe.dispatch"):
            d = expert_gemm.dispatch(idx, self.c.n_routed_experts)
            self.last_counts = d.counts
        with span("phoenix.moe.experts"):
            shared = self.shared_experts(x)
            e = self.experts
            y = expert_gemm.expert_down(expert_gemm.expert_swiglu(x, e.gate_proj, e.up_proj, d), e.down_proj, d)
        with span("phoenix.moe.combine"):
            return expert_gemm.moe_combine(y, w, shared, residual)


class DecoderLayer(nn.Module):
    """One pre-norm DeepSeek-V3 layer: MLA, then a SwiGLU or MoE FFN."""

    def __init__(self, d: int, n_heads: int, c: MoEDecoderConfig, dense: bool, dtype, device, generator):
        super().__init__()
        self.input_layernorm = RMSNorm(d, c.rms_norm_eps, device)
        self.self_attn = MLA(d, n_heads, c, dtype, device, generator)
        self.post_attention_layernorm = RMSNorm(d, c.rms_norm_eps, device)
        self.mlp = (SwiGLU(d, c.intermediate_size, dtype, device, generator) if dense
                    else MoE(d, c, dtype, device, generator))

    def forward(self, x: torch.Tensor, rope: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        with span("phoenix.attention"):
            h = x + self.self_attn(self.input_layernorm(x), rope, allowed)
        hn = self.post_attention_layernorm(h)
        if isinstance(self.mlp, SwiGLU):
            return h + self.mlp(hn)
        B, L, D = h.shape
        return self.mlp(hn.reshape(B * L, D), h.reshape(B * L, D)).view(B, L, D)


def allowed_keys(valid: torch.Tensor) -> torch.Tensor:
    """[B, 1, L, L] bool: query i may attend to key j ≤ i that is valid."""
    L = valid.shape[1]
    causal = torch.ones((L, L), dtype=torch.bool, device=valid.device).tril()
    return causal[None, None] & valid[:, None, None, :]
