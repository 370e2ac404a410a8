"""Plain reference of Phoenix over Moonlight-16B-A3B's decoder stack, in f32.

Plain ``torch`` in float32, written from the published layer (DeepSeek-V3's
``modeling_deepseek.py``, Moonlight-16B-A3B's ``config.json``) and Phoenix's
tables and readout. It imports nothing of JAX, of the JAX package or of the
port. Two copies are held equal by a test: ``tests/phoenix_moonlight_reference.py``
and ``portbench/reference/phoenix_moonlight.py``. The caller turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32``, ``torch.backends.cudnn.allow_tf32``).

``params`` maps the model's parameter names (the port's ``state_dict``
names) to tensors of any dtype; each is widened to f32 where it is used,
one layer (one expert) at a time, so the whole model at its published widths
runs on one card beside its bf16 weights. ``cfg`` holds the published keys
(``hidden_size``, ``num_attention_heads``, ``num_hidden_layers``,
``intermediate_size``, ``moe_intermediate_size``, ``n_routed_experts``,
``n_shared_experts``, ``num_experts_per_tok``, ``first_k_dense_replace``,
``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``rope_theta``, ``rms_norm_eps``, ``routed_scaling_factor``,
``norm_topk_prob``) and Phoenix's ``author_buckets``.

A layer over the history [B, L, D] (left-padded, ``valid`` [B, L]):

    h = x + o_proj(MLA(rmsnorm(x)))
    y = h + FFN(rmsnorm(h))
    FFN = SwiGLU in the first first_k_dense_replace layers,
          shared(x) + Σ_{e ∈ top-k} w_e · expert_e(x) after them

MLA: q = q_proj(x) per head [nope | rope]; kv_a_proj_with_mqa(x) = [latent |
k_rope], the rope key shared by the heads; kv_b_proj(rmsnorm(latent)) per
head [k_nope | v]; RoPE on q's and k's rope parts as the checkpoint applies
it (pairs de-interleaved, then rotate-half), θ = rope_theta; logits q·k /
√(nope + rope); a logit whose key is padding or later than its query is
replaced by -1e9 (a row with no such key attends uniformly). Router:
sigmoid of the f32 logits; experts chosen by top-k of score +
e_score_correction_bias; weights the chosen unbiased scores over their sum
(+1e-20), × routed_scaling_factor. The stack ends in an RMSNorm. Phoenix:
tokens are action + author (hash mod buckets) + age-bucket rows; candidate
tokens are author rows + bool_proj, LayerNorm'd (eps 1e-6); they
cross-attend into the history (additive -1e9 on padding keys, scale
1/√(D/H)); + the query; head_ln, head_mlp, tanh-GELU, action_head.

Routing near ties. Given the program's chosen experts (``routes``: one
[B·L, k] tensor a routed layer), the reference continues with the program's
set for every token, so that later layers compare like with like; a valid
token whose set holds an expert whose biased score (the reference's own)
lies more than ``tau`` below the reference's k-th best biased score counts
in ``route_far``. ``TAU`` is five bf16 steps of a score at 1 (2^-7 each):
the program's router reads the bf16 rounding of a hidden state that has
been through as many layers of bf16 products and roundings as the layer's
depth, and on an NVIDIA H100 its chosen experts lay up to 0.021 below
the reference's k-th best biased score where the two chose otherwise (16
pool batches of Moonlight's 26 routed layers; 0.067-0.081 with the routed
experts' inputs in fp8 e4m3).
"""

import math

import torch
import torch.nn.functional as F

MASK_NEG = -1e9
LN_EPS = 1e-6  # Phoenix's LayerNorms (flax's default)
AGE_BUCKET_BOUNDS_S = (60, 300, 900, 3600, 4 * 3600, 24 * 3600, 7 * 86400)
TAU = 5 * 2.0 ** -7


def _w(params, name):
    return params[name].float()


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * weight


def layer_norm(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).pow(2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def rope(x, theta):
    """The checkpoint's rotary embedding of x [..., L, d] at positions 0..L-1."""
    L, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    freqs = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


def attention(params, pre, cfg, x, valid):
    B, L, _ = x.shape
    H = cfg["num_attention_heads"]
    nope, rp, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ _w(params, pre + "q_proj.weight").T).view(B, L, H, nope + rp).transpose(1, 2)
    kv = x @ _w(params, pre + "kv_a_proj_with_mqa.weight").T
    latent, k_pe = kv[..., :r], kv[..., r:]
    latent = rms_norm(latent, _w(params, pre + "kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kvb = (latent @ _w(params, pre + "kv_b_proj.weight").T).view(B, L, H, nope + dv).transpose(1, 2)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])], dim=-1)
    k_pe = rope(k_pe[:, None], cfg["rope_theta"]).expand(B, H, L, rp)
    k = torch.cat([k_nope, k_pe], dim=-1)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    out = []
    for b in range(B):  # one request at a time: [H, L, L] logits
        logits = q[b] @ k[b].transpose(-1, -2) / math.sqrt(nope + rp)
        logits = torch.where(causal & valid[b][None, :], logits, torch.full_like(logits, MASK_NEG))
        out.append(torch.softmax(logits, dim=-1) @ v[b])
    o = torch.stack(out).transpose(1, 2).reshape(B, L, H * dv)
    return o @ _w(params, pre + "o_proj.weight").T


def moe(params, pre, cfg, x, valid, routes, tau):
    """x [T, D] normed, valid [T] → (FFN(x), far, gap, differ): far the valid
    tokens whose set holds an expert more than ``tau`` below the k-th best
    biased score, gap the largest such shortfall, differ the valid tokens
    whose set is not the reference's own."""
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    scores = torch.sigmoid(x @ _w(params, pre + "gate.weight").T)
    biased = scores + _w(params, pre + "gate.e_score_correction_bias")
    best = torch.topk(biased, k, dim=-1)
    far = gap = differ = 0
    chosen = best.indices
    if routes is not None:
        chosen = routes.reshape(-1, k).long().to(x.device)
        short = (best.values[:, -1:] - biased.gather(1, chosen)).amax(dim=1)
        far = int(((short > tau) & valid).sum())
        gap = float(torch.where(valid, short, torch.zeros_like(short)).max().clamp(min=0.0))
        own = torch.zeros_like(biased, dtype=torch.bool).scatter_(1, best.indices, True)
        differ = int((~own.gather(1, chosen).all(dim=1) & valid).sum())
    w = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    gate, up, down = (params[pre + "experts." + n] for n in ("gate_proj", "up_proj", "down_proj"))
    for e in range(E):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            h = swiglu(x[tok], gate[e].float(), up[e].float(), down[e].float())
            y.index_add_(0, tok, h * w[tok, slot, None])
    shared = swiglu(x, *(_w(params, pre + f"shared_experts.{n}.weight") for n in ("gate_proj", "up_proj", "down_proj")))
    return y + shared, far, gap, differ


def forward(params, cfg, seq, cands, routes=None, tau=TAU):
    """``seq`` (action_ids, author_hashes, age_s, valid) [B, L] and ``cands``
    (author_hashes, bool_features, valid) [B, C] → a dict: ``logits``
    [B, C, A] f32, and with ``routes`` the routing readings ``route_far``,
    ``route_gap`` and ``route_differ`` summed (gap: the largest) over the
    routed layers."""
    action_ids, author_hashes, age_s, valid = seq
    c_authors, c_bools = cands[0], cands[1]
    D, H, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["rms_norm_eps"]
    B, L = action_ids.shape
    author = params["author_emb.embedding"]
    bounds = torch.tensor(AGE_BUCKET_BOUNDS_S, dtype=torch.int64, device=age_s.device)
    x = (_w(params, "action_emb.embedding")[action_ids.long()]
         + author[torch.remainder(author_hashes.long(), cfg["author_buckets"])].float()
         + _w(params, "age_emb.embedding")[torch.searchsorted(bounds, age_s.long(), right=False)])
    readings = {"route_far": 0, "route_gap": 0.0, "route_differ": 0}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        h = x + attention(params, pre + "self_attn.", cfg, rms_norm(x, _w(params, pre + "input_layernorm.weight"), eps),
                          valid)
        hn = rms_norm(h, _w(params, pre + "post_attention_layernorm.weight"), eps)
        if i < cfg["first_k_dense_replace"]:
            x = h + swiglu(hn, *(_w(params, pre + f"mlp.{n}.weight") for n in ("gate_proj", "up_proj", "down_proj")))
            continue
        r = None if routes is None else routes[i - cfg["first_k_dense_replace"]]
        y, far, gap, differ = moe(params, pre + "mlp.", cfg, hn.reshape(B * L, D), valid.reshape(-1), r, tau)
        x = h + y.view(B, L, D)
        readings["route_far"] += far
        readings["route_differ"] += differ
        readings["route_gap"] = max(readings["route_gap"], gap)
    x = rms_norm(x, _w(params, "norm.weight"), eps)

    cq = author[torch.remainder(c_authors.long(), cfg["author_buckets"])].float()
    cq = cq + c_bools.float() @ _w(params, "bool_proj.weight").T + _w(params, "bool_proj.bias")
    cq = layer_norm(cq, _w(params, "cand_ln.scale"), _w(params, "cand_ln.bias"))
    dh = D // H
    q = (cq @ _w(params, "xq.weight").T).unflatten(-1, (H, dh)).transpose(1, 2)
    k = (x @ _w(params, "xk.weight").T).unflatten(-1, (H, dh)).transpose(1, 2)
    v = (x @ _w(params, "xv.weight").T).unflatten(-1, (H, dh)).transpose(1, 2)
    out = []
    for b in range(B):
        logits = q[b] @ k[b].transpose(-1, -2) / math.sqrt(dh) + torch.where(valid[b], 0.0, MASK_NEG)
        out.append(torch.softmax(logits, dim=-1) @ v[b])
    r = torch.stack(out).transpose(1, 2).reshape(B, -1, D) + cq
    h = layer_norm(r, _w(params, "head_ln.scale"), _w(params, "head_ln.bias"))
    h = F.gelu(h @ _w(params, "head_mlp.weight").T + _w(params, "head_mlp.bias"), approximate="tanh")
    readings["logits"] = h @ _w(params, "action_head.weight").T + _w(params, "action_head.bias")
    return readings
