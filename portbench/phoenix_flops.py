"""The Phoenix cell's arithmetic: the model FLOPs of a batch and the grouped
expert GEMM's FLOPs and bytes, from shapes and counts alone.

Imports nothing of the port. ``cfg`` is the configuration file's mapping
(the published keys and Phoenix's sizes). A multiply-add counts 2 FLOPs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA's data sheet, H100 SXM at its 700 W limit: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def token_flops(cfg) -> Tuple[float, float]:
    """(FLOPs a history token spends in every layer's projections and FFN
    summed over the stack, FLOPs a pair of (query, key) spends in one
    layer's attention)."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rp, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    proj = 2 * (D * H * (nope + rp) + D * (r + rp) + r * H * (nope + dv) + H * dv * D)
    dense = 2 * 3 * D * cfg["intermediate_size"]
    I, E, k = cfg["moe_intermediate_size"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    routed = 2 * D * E + k * 2 * 3 * D * I + 2 * 3 * D * I * cfg["n_shared_experts"]
    n_dense = cfg["first_k_dense_replace"]
    per_token = cfg["num_hidden_layers"] * proj + n_dense * dense + (cfg["num_hidden_layers"] - n_dense) * routed
    return float(per_token), float(2 * H * (nope + rp + dv))


def model_flops(cfg, valid_history: Sequence[int], valid_candidates: Sequence[int]) -> float:
    """The model FLOPs of a batch, over valid history tokens and valid
    candidates only: the stack's projections, causal attention over valid
    keys (n(n+1)/2 pairs a layer), the dense layer, the router, the k routed
    experts as routed and the shared experts; the readout (the history's
    keys and values, each candidate's query, cross attention over the valid
    history, head and action head)."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    per_token, per_pair = token_flops(cfg)
    total = 0.0
    for n, c in zip(valid_history, valid_candidates):
        total += n * per_token + cfg["num_hidden_layers"] * per_pair * n * (n + 1) / 2
        total += 2 * 2 * D * D * n  # xk, xv
        total += c * (2 * cfg["num_bool_features"] * D + 2 * D * D + 2 * 2 * D * n + 2 * D * D
                      + 2 * D * cfg["num_actions"])  # bool_proj, xq, cross attention, head_mlp, action_head
    return total


def expert_gemm(cfg, counts: Sequence[Sequence[int]]) -> Tuple[float, float]:
    """(FLOPs, bytes) of the grouped expert GEMM's two launches over the
    layers whose per-expert slot counts are ``counts``: every routed slot's
    gate, up and down products; bytes as each input is read once and each
    output written once: the weights of every expert that has a slot, each
    slot's token row in and its SwiGLU row out (gate/up), that row in and
    its output row out (down), all bf16."""
    D, I = cfg["hidden_size"], cfg["moe_intermediate_size"]
    flops = nbytes = 0.0
    for layer in counts:
        slots = sum(layer)
        flops += slots * 2 * 3 * D * I
        nbytes += sum(1 for c in layer if c) * 3 * D * I * BF16_BYTES + slots * 2 * (D + I) * BF16_BYTES
    return flops, nbytes


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card takes for the work: the larger of the FLOPs
    over the bf16 peak and the bytes over HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
