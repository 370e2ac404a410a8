"""Phoenix: user-action-sequence transformer scorer ("predict next actions").

Counterpart of ``the_algorithm_tpu/models/phoenix.py``: a causal pre-LN
transformer encodes the viewer's aggregated action history (each token
embeds action, author hash and age bucket); every candidate forms a query
token (author hash + bool-feature projection) that cross-attends into the
encoded history; a shared f32 head gives ``NUM_ACTIONS`` logits per
candidate. Reference: home-mixer's ``PhoenixScorer.scala`` and
``util/PhoenixUtils.scala:34-100`` (MaxCandidates=1400).

The forward is the flax model's, operation for operation:

- products run in the compute type (bf16 by default; f32 parameters cast
  inside the op), the layer norms' statistics and affine in f32 with
  flax's eps 1e-6, and ``action_head`` in f32;
- ``nn.gelu`` is the tanh approximation;
- the attention keeps the JAX package's additive masks (-1e9 for an
  invalid key, another -1e9 above the diagonal) with the logits cast to f32
  before ``/ sqrt(d) + mask`` and an f32 softmax, written out as einsums:
  a library attention with a boolean mask gives other values on the
  left-padded history rows, where every key is masked;
- the qkv product splits as ``reshape(L, 3H, D/H)`` then thirds along the
  head axis;
- ``author_emb`` (65,536 × 256 f32 at full width) is shared by the history
  and the candidate tokens and read once a forward, both token sets of
  every request together, through
  :func:`~the_algorithm_tpu_torch.ops.gather.table_read` (one ``row_gather``
  launch on the card; its gradient one ``run_collapse_rows`` launch). The
  small action, age and position tables are plain indexing.
  ``nn.Embed(dtype=bf16)`` casts the f32 table and then reads it; reading
  f32 rows and then casting gives the same bits.

The forward takes one request (``seq`` [L], ``cands`` [C] → [C, A], as
serving calls it) or a batch (a leading axis: [B, L], [B, C] → [B, C, A]),
the counterpart of ``jax.vmap(lambda s, c: model.apply(p, s, c))``: each
request's masks are its own, and a batch of one gives the unbatched call's
bits.

Gradients, where they part from ``jax.grad``'s:

- in bf16, flax forms a table's cotangent in bf16 (the rows of the cast
  table), summing repeated ids in bf16 before the cast back to the f32
  parameter. Here the rows are read in f32 and cast after the read, so the
  cotangent reaching the table is f32 and repeated ids sum in f32:
  ``author_emb``'s in slot order through ``run_collapse_rows``, the action
  and age tables' through ``index_put_(accumulate=True)`` (on the card a
  sort and one thread a run, in sorted order: no float atomics), and the
  position table's over the batch as one reduction. The forward bits are
  the same; the gradient is as near the f32 one as JAX's or nearer
  (tests/test_torch_phoenix_training.py holds the bound). In f32 the two
  agree to f32 rounding.
- an all-padding history attends uniformly on both sides (-1e9 plus a
  product rounds to -1e9 in f32), and its gradient flows through the same
  softmax: finite and equal.

:func:`params_from_flax` turns the JAX package's flax params into this
module's ``state_dict`` and :func:`params_to_flax` is its inverse, bit for
bit. :func:`aggregate_history` is a host copy.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.core.metrics import span
from the_algorithm_tpu_torch.models.moe_transformer import (DecoderLayer, MoE, MoEDecoderConfig, RMSNorm,
                                                            allowed_keys, rope_tables)
from the_algorithm_tpu_torch.ops.gather import table_read

LN_EPS = 1e-6  # flax nn.LayerNorm's default
MASK_NEG = -1e9  # the additive mask of an invalid (or future) key


class ActionName(enum.IntEnum):
    """≡ com.x.user_action_sequence.ActionName (subset used by the Phoenix
    head registry, ``PhoenixPredictedScoreFeature.scala``)."""

    PAD = 0
    SERVER_TWEET_FAV = 1
    SERVER_TWEET_REPLY = 2
    SERVER_TWEET_RETWEET = 3
    SERVER_TWEET_QUOTE = 4
    CLIENT_TWEET_CLICK = 5
    CLIENT_TWEET_PHOTO_EXPAND = 6
    CLIENT_TWEET_CLICK_PROFILE = 7
    CLIENT_TWEET_VIDEO_QUALITY_VIEW = 8
    CLIENT_TWEET_SHARE = 9
    CLIENT_TWEET_SHARE_VIA_COPY_LINK = 10
    CLIENT_TWEET_CLICK_SEND_VIA_DIRECT_MESSAGE = 11
    CLIENT_TWEET_RECAP_DWELLED = 12
    CLIENT_TWEET_OPEN_LINK = 13
    CLIENT_TWEET_TAKE_SCREENSHOT = 14
    CLIENT_TWEET_BOOKMARK = 15
    CLIENT_TWEET_NOT_INTERESTED_IN = 16
    CLIENT_TWEET_BLOCK_AUTHOR = 17
    CLIENT_TWEET_MUTE_AUTHOR = 18
    CLIENT_TWEET_REPORT = 19
    SERVER_USER_FOLLOW = 20
    CLIENT_TWEET_VIDEO_WATCH_TIME = 21
    IMPRESSION = 22


NUM_ACTIONS = len(ActionName)


class UserActionSequence(NamedTuple):
    """Fixed-length aggregated action history (newest-last, left-padded)."""

    action_ids: torch.Tensor  # [L] int32 (ActionName)
    author_hashes: torch.Tensor  # [L] int32 in [0, author_buckets)
    age_s: torch.Tensor  # [L] int32 seconds before `now`
    valid: torch.Tensor  # [L] bool

    def to(self, device) -> "UserActionSequence":
        return UserActionSequence(*(t.to(device) for t in self))


class CandidateFeatures(NamedTuple):
    """≡ TweetInfo + TweetBoolFeatures (PhoenixUtils.getTweetInfoFromCandidates)."""

    author_hashes: torch.Tensor  # [C] int32
    bool_features: torch.Tensor  # [C, NUM_BOOL_FEATURES] float32 {0,1}
    valid: torch.Tensor  # [C] bool

    def to(self, device) -> "CandidateFeatures":
        return CandidateFeatures(*(t.to(device) for t in self))


BOOL_FEATURES = ("is_retweet", "is_reply", "is_quote", "is_for_you", "is_promoted")
NUM_BOOL_FEATURES = len(BOOL_FEATURES)

AGE_BUCKET_BOUNDS_S = (60, 300, 900, 3600, 4 * 3600, 24 * 3600, 7 * 86400)


@dataclasses.dataclass(frozen=True)
class PhoenixConfig:
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    mlp_ratio: int = 4  # the JAX package's Block widens by 4 whatever this says
    max_history: int = 256  # reference aggregates to maxLength=1024
    author_buckets: int = 1 << 16
    dtype: str = "bfloat16"
    # None: the JAX package's pre-LN GELU blocks over learned positions. A
    # MoEDecoderConfig: n_layers DeepSeek-V3 layers (moe_transformer.py), RoPE
    # over the history's slots, parameters held in the compute type
    decoder: Optional[MoEDecoderConfig] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal (±2σ) of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # σ of the ±2σ truncation
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense`` in a compute type: inputs, kernel and bias cast to
    ``dtype``, the product rounded to it, then the bias added in it. The
    weight is torch's [out, in] (the flax kernel transposed)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype: torch.dtype, device, generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        _lecun_normal_(self.weight, d_in, generator)
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics and affine in f32
    (eps 1e-6), f32 out."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, LN_EPS)


class Embed(nn.Module):
    """flax ``nn.Embed``: an f32 ``embedding`` table read in the compute type."""

    def __init__(self, n: int, dim: int, device, generator):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, dim, device=device))
        # flax's default_embed_init: variance_scaling(1, fan_in, normal, out_axis=0)
        nn.init.normal_(self.embedding, std=1.0 / math.sqrt(dim), generator=generator)


def _key_mask(valid: torch.Tensor) -> torch.Tensor:
    """[B, 1, 1, L] additive f32 mask from ``valid`` [B, L]: 0 for a valid
    key, -1e9 for an invalid one."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid[:, None, None, :], zero, zero + MASK_NEG)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, dtype) -> torch.Tensor:
    """The JAX package's ``_attend`` over a batch: q [B, Tq, H, d], k and v
    [B, Tk, H, d], an additive f32 mask broadcast to [B, H, Tq, Tk] →
    [B, Tq, H, d]."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / np.float32(np.sqrt(d)) + mask
    w = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class Block(nn.Module):
    """One pre-LN transformer block over [B, L, D] (flax ``Block`` under
    ``vmap``; its params
    keep the flax names: ``LayerNorm_0``, ``qkv``, ``proj``, ``LayerNorm_1``,
    ``mlp_up``, ``mlp_down``)."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype, causal: bool, device, generator):
        super().__init__()
        D = d_model
        self.n_heads, self.dtype, self.causal = n_heads, dtype, causal
        self.LayerNorm_0 = LayerNorm(D, device)
        self.qkv = Dense(D, 3 * D, False, dtype, device, generator)
        self.proj = Dense(D, D, False, dtype, device, generator)
        self.LayerNorm_1 = LayerNorm(D, device)
        self.mlp_up = Dense(D, 4 * D, True, dtype, device, generator)
        self.mlp_down = Dense(4 * D, D, True, dtype, device, generator)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H, dt = self.n_heads, self.dtype
        h = self.LayerNorm_0(x).to(dt)
        qkv = self.qkv(h).reshape(B, L, 3 * H, D // H)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
        mask = _key_mask(valid)
        if self.causal:
            causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            mask = mask + torch.where(causal[None], zero, zero + MASK_NEG)
        a = _attend(q, k, v, mask, dt).reshape(B, L, D)
        x = x + self.proj(a)
        h = self.LayerNorm_1(x).to(dt)
        h = F.gelu(self.mlp_up(h), approximate="tanh")
        return x + self.mlp_down(h)


class PhoenixModel(nn.Module):
    """History encoder + candidate cross-attention readout → action logits
    [C, NUM_ACTIONS] f32. Built on the card unless ``device`` names another.

    Without ``config.decoder``: the JAX package's model, parameters f32,
    products in ``config.dtype``. With one: the history runs through
    ``n_layers`` DeepSeek-V3 layers (:mod:`~the_algorithm_tpu_torch.models.
    moe_transformer`; RoPE in place of ``pos_emb``, a final RMSNorm in place
    of ``enc_ln``), every product's parameters held in the compute type
    (the tables, norms and ``action_head`` stay f32), the same readout at
    ``d_model`` with ``n_heads`` heads, in ``phoenix.*`` spans. That kind
    serves: its routed experts' kernels have no backward."""

    def __init__(self, config: PhoenixConfig = PhoenixConfig(), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve(device, "PhoenixModel")
        self.config = cfg = config
        D, dt = cfg.d_model, cfg.compute_dtype
        self.action_emb = Embed(NUM_ACTIONS, D, device, generator)
        self.author_emb = Embed(cfg.author_buckets, D, device, generator)
        self.age_emb = Embed(len(AGE_BUCKET_BOUNDS_S) + 1, D, device, generator)
        if cfg.decoder is None:
            self.pos_emb = nn.Parameter(torch.empty(cfg.max_history, D, device=device))
            nn.init.normal_(self.pos_emb, std=0.02, generator=generator)
            for i in range(cfg.n_layers):
                setattr(self, f"enc_{i}", Block(D, cfg.n_heads, dt, True, device, generator))
            self.enc_ln = LayerNorm(D, device)
        else:
            c = cfg.decoder
            self.layers = nn.ModuleList(
                DecoderLayer(D, cfg.n_heads, c, i < c.first_k_dense_replace, dt, device, generator)
                for i in range(cfg.n_layers))
            self.norm = RMSNorm(D, c.rms_norm_eps, device)
            self.register_buffer("rope", rope_tables(cfg.max_history, c.qk_rope_head_dim, c.rope_theta, device),
                                 persistent=False)
        self.bool_proj = Dense(NUM_BOOL_FEATURES, D, True, dt, device, generator)
        self.cand_ln = LayerNorm(D, device)
        self.xq = Dense(D, D, False, dt, device, generator)
        self.xk = Dense(D, D, False, dt, device, generator)
        self.xv = Dense(D, D, False, dt, device, generator)
        self.head_ln = LayerNorm(D, device)
        self.head_mlp = Dense(D, D, True, dt, device, generator)
        self.action_head = Dense(D, NUM_ACTIONS, True, torch.float32, device, generator)
        if cfg.decoder is not None:
            for m in (self.bool_proj, self.xq, self.xk, self.xv, self.head_mlp):
                m.to(dt)
        self.register_buffer("age_bounds", torch.tensor(AGE_BUCKET_BOUNDS_S, dtype=torch.int32, device=device),
                             persistent=False)

    def moe_layers(self) -> List[MoE]:
        """The routed layers of the decoder kind, in order (none otherwise)."""
        return [m for m in self.modules() if isinstance(m, MoE)]

    def forward(self, seq: UserActionSequence, cands: CandidateFeatures) -> torch.Tensor:
        """Action logits f32: [C, NUM_ACTIONS] for one request (``seq`` [L],
        ``cands`` [C]), [B, C, NUM_ACTIONS] for a batch ([B, L], [B, C])."""
        if seq.action_ids.dim() == 2:
            return self._forward(seq, cands)
        return self._forward(UserActionSequence(*(t[None] for t in seq)),
                             CandidateFeatures(*(t[None] for t in cands)))[0]

    def _forward(self, seq: UserActionSequence, cands: CandidateFeatures) -> torch.Tensor:
        cfg = self.config
        if cfg.decoder is not None:
            with span("phoenix.forward"):
                return self._forward_decoder(seq, cands)
        dt = cfg.compute_dtype
        auth_cand, x = self._tokens(seq, cands)
        x = x + self.pos_emb.to(dt)
        for i in range(cfg.n_layers):
            x = getattr(self, f"enc_{i}")(x, seq.valid)
        x = self.enc_ln(x).to(dt)  # [B, L, D]
        return self._readout(x, auth_cand, cands, seq.valid)

    def _forward_decoder(self, seq: UserActionSequence, cands: CandidateFeatures) -> torch.Tensor:
        L = seq.action_ids.shape[1]
        auth_cand, x = self._tokens(seq, cands)
        rope, allowed = self.rope[:, :L], allowed_keys(seq.valid)
        for layer in self.layers:
            x = layer(x, rope, allowed)
        x = self.norm(x)
        with span("phoenix.readout"):
            return self._readout(x, auth_cand, cands, seq.valid)

    def _tokens(self, seq: UserActionSequence, cands: CandidateFeatures):
        """(candidate author rows, history tokens without positions), in the
        compute type."""
        cfg = self.config
        dt = cfg.compute_dtype
        L = seq.action_ids.shape[1]
        # one author_emb read for both token sets of every request (% is floor-mod, as in JAX)
        hashes = torch.cat([seq.author_hashes, cands.author_hashes], dim=1).to(torch.int32)
        auth = table_read(self.author_emb.embedding, torch.remainder(hashes, cfg.author_buckets)).to(dt)
        auth_hist, auth_cand = auth[:, :L], auth[:, L:]
        age_bucket = torch.searchsorted(self.age_bounds, seq.age_s.to(torch.int32).contiguous(), right=False)
        x = (self.action_emb.embedding[seq.action_ids.long()].to(dt) + auth_hist
             + self.age_emb.embedding[age_bucket].to(dt))
        return auth_cand, x

    def _readout(self, x: torch.Tensor, auth_cand: torch.Tensor, cands: CandidateFeatures,
                 valid: torch.Tensor) -> torch.Tensor:
        """Candidate query tokens cross-attend into the encoded history x
        [B, L, D]; the head → [B, C, NUM_ACTIONS] f32."""
        cfg = self.config
        dt, D, H = cfg.compute_dtype, cfg.d_model, cfg.n_heads
        B, L = valid.shape
        # candidate query tokens
        cq = auth_cand + self.bool_proj(cands.bool_features.to(dt))
        cq = self.cand_ln(cq).to(dt)  # [B, C, D]

        # cross attention: candidates read the encoded history
        q = self.xq(cq).reshape(B, -1, H, D // H)
        k = self.xk(x).reshape(B, L, H, D // H)
        v = self.xv(x).reshape(B, L, H, D // H)
        r = _attend(q, k, v, _key_mask(valid), dt).reshape(B, -1, D)
        r = r + cq
        h = F.gelu(self.head_mlp(self.head_ln(r).to(dt)), approximate="tanh")
        return self.action_head(h.float())  # [B, C, NUM_ACTIONS]


def predict_next_actions(model: PhoenixModel, seq: UserActionSequence, cands: CandidateFeatures) -> torch.Tensor:
    """[C, NUM_ACTIONS] per-candidate action probabilities (masked rows 0);
    [B, C, NUM_ACTIONS] for a batch."""
    probs = torch.sigmoid(model(seq, cands))
    return probs * cands.valid[..., None]


def scorer_predict_fn(model: PhoenixModel) -> Callable:
    """The :class:`~the_algorithm_tpu_torch.mixers.phoenix_scorer.PhoenixScorer`
    predict fn over ``model``: (authors [C], bool features [C, NB], valid [C]
    numpy, the query's :class:`UserActionSequence`) → [C, NUM_ACTIONS]
    probabilities as numpy, computed on the model's device."""
    device = model.author_emb.embedding.device

    def predict(authors, bools, valid, user_actions) -> np.ndarray:
        cands = CandidateFeatures(torch.from_numpy(np.asarray(authors, np.int32)),
                                  torch.from_numpy(np.asarray(bools, np.float32)),
                                  torch.from_numpy(np.asarray(valid, bool))).to(device)
        with torch.inference_mode():
            return predict_next_actions(model, user_actions.to(device), cands).cpu().numpy()

    return predict


def multi_action_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy over valid candidates × actions, in the JAX
    package's formula; logits and labels [..., C, A], valid [..., C] (a
    batch's mean is over all its valid candidates, as the JAX formula over
    the batch's rows flattened)."""
    ce = torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    ce = ce * valid[..., None]
    return torch.sum(ce) / torch.clamp(torch.sum(valid) * logits.shape[-1], min=1.0)


# -- flax params ---------------------------------------------------------------


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's Phoenix params (a nested dict of arrays, with or
    without the top-level ``"params"`` key) → this module's ``state_dict``:
    a ``kernel`` becomes the transposed ``weight``, every other leaf keeps
    its flax path as its name."""
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (name,))
            elif name == "kernel":
                out[".".join(path + ("weight",))] = torch.from_numpy(np.array(v, np.float32).T.copy())
            else:
                out[".".join(path + (name,))] = torch.from_numpy(np.array(v, np.float32))

    walk(tree, ())
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """Inverse of :func:`params_from_flax`: the flax tree, numpy leaves."""
    tree: Dict[str, Dict] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            node["kernel"] = a.T.copy()
        else:
            node[leaf] = a.copy()
    return {"params": tree}


# -- history assembly (host side) ---------------------------------------------

WINDOW_MS = 5 * 60 * 1000  # UserActionsQueryFeatureHydrator windowTimeMs


def aggregate_history(
    events: Sequence[Tuple[int, int, int]],  # (ts_ms, action_id, author_hash)
    *,
    now_ms: int,
    max_length: int,
    exclude_dwells: bool = False,
) -> Dict[str, np.ndarray]:
    """Raw events → aggregated fixed-length arrays.

    ≡ AggregationProcessor(AggregationConfig(windowTimeMs=5min, maxLength,
    AggregationAlgorithmV1)): events of the same (action, author) inside one
    5-minute window collapse to one aggregated action; newest `max_length`
    kept, newest-last; optional dwell exclusion (the dense variant's
    ``filterDwells``).
    """
    dwells = {
        int(ActionName.CLIENT_TWEET_RECAP_DWELLED),
    }
    seen = set()
    agg = []
    for ts_ms, action_id, author in sorted(events):
        if exclude_dwells and action_id in dwells:
            continue
        key = (ts_ms // WINDOW_MS, action_id, author)
        if key in seen:
            continue
        seen.add(key)
        agg.append((ts_ms, action_id, author))
    agg = agg[-max_length:]
    L = max_length
    action_ids = np.zeros(L, np.int32)
    author_hashes = np.zeros(L, np.int32)
    age_s = np.zeros(L, np.int32)
    valid = np.zeros(L, bool)
    off = L - len(agg)
    for i, (ts_ms, action_id, author) in enumerate(agg):
        action_ids[off + i] = action_id
        author_hashes[off + i] = author
        age_s[off + i] = max(0, (now_ms - ts_ms) // 1000)
        valid[off + i] = True
    return {
        "action_ids": action_ids,
        "author_hashes": author_hashes,
        "age_s": age_s,
        "valid": valid,
    }
