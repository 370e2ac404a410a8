"""Batches of Phoenix ranking requests through the port's Phoenix over
Moonlight-16B-A3B's decoder stack.

The configuration file gives the published DeepSeek-V3 keys and Phoenix's
sizes; :func:`phoenix_config` turns them into the port's ``PhoenixConfig``
and refuses a key whose value the port does not implement. The mix file
gives ``requests_per_batch`` (B), ``min_valid_history``,
``candidates_per_request`` (C), ``pool_batches`` (distinct batches drawn at
set-up and cycled), ``in_flight``, ``slice_batches`` (the traced slice) and
``warm_seconds`` (the pipeline run before the window, part of set-up).
Each batch goes through ``phoenix.predict_next_actions`` and its
[B, C, NUM_ACTIONS] probabilities are copied to pinned host memory; a
request counts as answered once they are on the host (reported as
``sann_queries_per_s``, the benchmark's queries/s: a query here is one
ranking request).

``correct``: once the window has closed, every pool batch's last answer in
the window against the plain f32 reference (``reference/phoenix_moonlight.py``)
on the card, by ``compare_phoenix.phoenix``. The program runs each pool
batch once more with its routes recorded, and the reference follows them
(near ties beyond its tolerance count in ``route_far``).
"""

from __future__ import annotations

import collections
import contextlib
import time
import types

import torch

from portbench import compare, compare_phoenix, harness, phoenix_flops
from portbench.generators import phoenix_world
from portbench.reference import phoenix_moonlight as ref_phoenix

SPANS = ("phoenix.batch", "phoenix.forward", "phoenix.attention", "phoenix.moe.route", "phoenix.moe.dispatch",
         "phoenix.moe.experts", "phoenix.moe.combine", "phoenix.readout")
DECODER_KEYS = ("intermediate_size", "moe_intermediate_size", "n_routed_experts", "n_shared_experts",
                "num_experts_per_tok", "first_k_dense_replace", "kv_lora_rank", "qk_nope_head_dim",
                "qk_rope_head_dim", "v_head_dim", "rope_theta", "rms_norm_eps", "routed_scaling_factor",
                "norm_topk_prob")
# published keys of which the port implements one value
FIXED = {"attention_bias": False, "ep_size": 1, "hidden_act": "silu", "model_type": "deepseek_v3",
         "moe_layer_freq": 1, "n_group": 1, "num_nextn_predict_layers": 0, "q_lora_rank": None,
         "scoring_func": "sigmoid", "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
         "vocab_size": 0, "dtype": "bfloat16"}


class _Done:
    """A finished batch on a CPU run (no stream to wait on)."""

    def synchronize(self):
        pass


class State:
    pass


def phoenix_config(config):
    """The port's ``PhoenixConfig`` of the configuration file; raises on a
    key whose value the port does not implement."""
    from the_algorithm_tpu_torch.models import phoenix
    from the_algorithm_tpu_torch.models.moe_transformer import MoEDecoderConfig

    for key, want in FIXED.items():
        if config[key] != want:
            raise harness.Refused(f"{key} = {config[key]!r}: the port implements {want!r}")
    if config["num_key_value_heads"] != config["num_attention_heads"]:
        raise harness.Refused("MLA gives every head its own key and value")
    if config["max_history"] > config["max_position_embeddings"]:
        raise harness.Refused("the history is longer than the model's positions")
    if (config["num_actions"], config["num_bool_features"]) != (phoenix.NUM_ACTIONS, phoenix.NUM_BOOL_FEATURES):
        raise harness.Refused("Phoenix's action and bool-feature counts differ from the port's")
    decoder = MoEDecoderConfig(**{k: config[k] for k in DECODER_KEYS})
    return phoenix.PhoenixConfig(d_model=config["hidden_size"], n_layers=config["num_hidden_layers"],
                                 n_heads=config["num_attention_heads"], max_history=config["max_history"],
                                 author_buckets=config["author_buckets"], dtype=config["dtype"], decoder=decoder)


def setup(ctx) -> State:
    from the_algorithm_tpu_torch.models import phoenix

    dev, c, t = ctx.device, ctx.config, ctx.traffic
    cfg = phoenix_config(c)
    B, C, P = t["requests_per_batch"], t["candidates_per_request"], t["pool_batches"]
    if C > c["max_candidates"]:
        raise harness.Refused(f"{C} candidates a request, more than Phoenix's {c['max_candidates']}")
    lap = harness.Laps()
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    s = State()
    s.device, s.config, s.B, s.P = dev, c, B, P
    s.in_flight, s.slice_batches = t["in_flight"], t["slice_batches"]
    s.model = phoenix.PhoenixModel(cfg, device=dev)
    phoenix_world.fill_weights(s.model.named_parameters(), gen)
    lap(f"{sum(p.numel() for p in s.model.parameters()):,} parameters drawn")
    s.pool = [phoenix_world.draw_batch(B, cfg.max_history, C, t["min_valid_history"], cfg.author_buckets,
                                       c["num_bool_features"], gen, dev) for _ in range(P)]
    s.seqs = [phoenix.UserActionSequence(b.action_ids, b.author_hashes, b.age_s, b.valid) for b in s.pool]
    s.cands = [phoenix.CandidateFeatures(b.cand_authors, b.cand_bools, b.cand_valid) for b in s.pool]
    pin = dev.type == "cuda"
    s.host = [torch.empty((B, C, phoenix.NUM_ACTIONS), dtype=torch.float32, pin_memory=pin) for _ in range(P)]
    s.model_flops = [phoenix_flops.model_flops(c, b.valid.sum(1).tolist(), b.cand_valid.sum(1).tolist())
                     for b in s.pool]
    s.traced = False
    s.gemm_work = []
    for i in range(P):  # every batch once (the kernels compile); its per-expert slot counts
        dispatch(s, i).synchronize()
        counts = [layer.last_counts.tolist() for layer in s.model.moe_layers()]
        s.gemm_work.append(phoenix_flops.expert_gemm(c, counts))
    lap(f"{P} x {B} requests drawn, each batch once")
    _pipeline(s, lambda n: n < 2 * P)
    lap(f"{2 * P} batches warm")
    until = time.perf_counter() + t["warm_seconds"]  # the card at its power cap's steady clock
    lap(f"{_pipeline(s, lambda n: time.perf_counter() < until)} batches more, the card's clock settled")
    return s


def dispatch(s: State, i: int):
    """Batch ``i`` of the pool: the ranking call, its probabilities copied to
    the host; returns what to wait on."""
    from the_algorithm_tpu_torch.models import phoenix

    span = torch.profiler.record_function("phoenix.batch") if s.traced else contextlib.nullcontext()
    with span, torch.inference_mode():
        probs = phoenix.predict_next_actions(s.model, s.seqs[i], s.cands[i])
        cuda = s.device.type == "cuda"
        s.host[i].copy_(probs, non_blocking=cuda)
        if not cuda:
            return _Done()
        ev = torch.cuda.Event()
        ev.record()
        return ev


def _pipeline(s: State, more) -> int:
    """Batches in pool order, ``in_flight`` dispatched ahead, while
    ``more(batches dispatched)``; returns the batches answered."""
    pending, n, done = collections.deque(), 0, 0
    while more(n):
        pending.append(dispatch(s, n % s.P))
        n += 1
        if len(pending) >= s.in_flight:
            pending.popleft().synchronize()
            done += 1
    while pending:
        pending.popleft().synchronize()
        done += 1
    return done


def window(s: State, seconds: float) -> dict:
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    done = _pipeline(s, lambda n: time.perf_counter() < deadline)
    elapsed = time.perf_counter() - t0
    return {"attempted": done * s.B, "failed": 0,
            "metrics": {"sann_queries_per_s": {"value": done * s.B / elapsed, "unit": "queries/s"}}}


def trace_slice(s: State) -> dict:
    """``slice_batches`` batches as the window runs them, each in a
    ``phoenix.batch`` span; the facts the readers need: the batches' model
    FLOPs, the grouped GEMM's FLOPs, bytes and launches."""
    from the_algorithm_tpu_torch import _build
    from the_algorithm_tpu_torch.ops import expert_gemm

    def launched():
        return _build.launches(expert_gemm.expert_swiglu) + _build.launches(expert_gemm.expert_down)

    before = launched()
    s.traced = True
    try:
        n = _pipeline(s, lambda k: k < s.slice_batches)
    finally:
        s.traced = False
    batches = [k % s.P for k in range(n)]
    return {"batches": n, "model_flops": sum(s.model_flops[i] for i in batches),
            "expert_gemm_flops": sum(s.gemm_work[i][0] for i in batches),
            "expert_gemm_bytes": sum(s.gemm_work[i][1] for i in batches),
            "expert_gemm_launches": launched() - before}


def release(s: State) -> None:
    """Nothing: the check runs the model again, and the pool and the
    weights are the reference's inputs."""


def _rerun(s: State, i: int):
    """Pool batch ``i`` through the program once more: (logits, each routed
    layer's chosen experts)."""
    layers = s.model.moe_layers()
    for layer in layers:
        layer.route_log = []
    try:
        with torch.inference_mode():
            logits = s.model(s.seqs[i], s.cands[i])
        return logits, [layer.route_log[0] for layer in layers]
    finally:
        for layer in layers:
            layer.route_log = None


def _readings(s: State, answers) -> dict:
    """Each pool batch's program run against the reference on the same
    weights and inputs; ``answers(i, logits)`` the probabilities the
    program served for it."""
    params = dict(s.model.state_dict())
    readings = []
    for i, b in enumerate(s.pool):
        logits, routes = _rerun(s, i)
        with torch.no_grad():
            ref = ref_phoenix.forward(params, s.config, tuple(s.seqs[i]), tuple(s.cands[i]), routes=routes)
        harness.note(f"pool batch {i}: {ref['route_differ']} valid tokens routed otherwise than the reference's own "
                     f"top-k over the routed layers, the widest {ref['route_gap']!r} below its k-th best")
        readings.append(compare_phoenix.phoenix(logits, answers(i, logits), ref, b.cand_valid))
    return compare.merge(readings)


def check(s: State) -> dict:
    """Every pool batch's last answer in the window, and the logits of the
    run whose routes the reference follows, against the f32 reference."""
    return _readings(s, lambda i, logits: s.host[i])


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 with one scale a matrix (its largest
    magnitude at 448), back in its own type."""
    amax = t.float().abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class _Fp8Torch:
    """``torch`` as MLA's products see it under the control: ``matmul``
    rounds both inputs to fp8 e4m3 first."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def matmul(a, b):
        return torch.matmul(_fp8(a), _fp8(b))


@contextlib.contextmanager
def _fp8_products():
    """Every bf16 product of the forward with its inputs rounded to fp8
    e4m3 (one scale a matrix): the decoder's projections, MLA's attention,
    the dense layer, the shared and routed experts, and the readout's
    projections and attention. Norms, router, softmax and the f32 action
    head keep their precision."""
    from the_algorithm_tpu_torch.models import moe_transformer as mt
    from the_algorithm_tpu_torch.models import phoenix

    eg, linear, dense, attend = mt.expert_gemm, mt.Linear.forward, phoenix.Dense.forward, phoenix._attend

    def dense_fp8(self, x):
        if self.dtype != torch.bfloat16:
            return dense(self, x)
        y = torch.nn.functional.linear(_fp8(x.to(self.dtype)), _fp8(self.weight.to(self.dtype)))
        return y if self.bias is None else y + self.bias.to(self.dtype)

    mt.expert_gemm = types.SimpleNamespace(
        dispatch=eg.dispatch, moe_combine=eg.moe_combine,
        expert_swiglu=lambda x, wg, wu, d: eg.expert_swiglu(_fp8(x), _fp8(wg), _fp8(wu), d),
        expert_down=lambda h, wd, d: eg.expert_down(_fp8(h), _fp8(wd), d))
    mt.Linear.forward = lambda self, x: torch.nn.functional.linear(_fp8(x), _fp8(self.weight))
    mt.torch = _Fp8Torch()
    phoenix.Dense.forward = dense_fp8
    phoenix._attend = lambda q, k, v, mask, dtype: attend(_fp8(q), _fp8(k), _fp8(v), mask, dtype)
    try:
        yield
    finally:
        mt.expert_gemm, mt.Linear.forward, mt.torch = eg, linear, torch
        phoenix.Dense.forward, phoenix._attend = dense, attend


def control(s: State) -> dict:
    """The control's numbers: the same forward with every bf16 product's
    inputs rounded to fp8 e4m3 (:func:`_fp8_products`), one precision below
    the configuration's bf16."""
    with _fp8_products():
        return _readings(s, lambda i, logits: torch.sigmoid(logits) * s.pool[i].cand_valid[..., None])
