"""Phoenix's decoder kind (DeepSeek-V3 layers, Moonlight-16B-A3B's at full
size) against the plain f32 reference, at a small size on the CPU (the
routed experts through their plain versions).

The small stack: hidden 128, 4 heads, kv_lora 32, rope 16, nope 32, v 32,
8 routed experts top-2 plus 1 shared, 1 dense + 2 routed layers. The
reference follows the port's routes (its near-tie rule); in f32 the port
then agrees to f32 rounding, in bf16 within ``BF16_BOUND``. This file
imports no JAX.
"""

import dataclasses
import filecmp
import json
import math
import os
import subprocess
import sys

import phoenix_moonlight_reference as ref
import pytest
import torch
import torch_port_util  # noqa: F401  (one CPU thread a worker)
from torch.profiler import ProfilerActivity, profile

from the_algorithm_tpu_torch.core import metrics
from the_algorithm_tpu_torch.mixers.phoenix_scorer import PhoenixScorer
from the_algorithm_tpu_torch.models import moe_transformer as mt
from the_algorithm_tpu_torch.models import phoenix
from the_algorithm_tpu_torch.ops import expert_gemm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = mt.MoEDecoderConfig(intermediate_size=256, moe_intermediate_size=64, n_routed_experts=8, n_shared_experts=1,
                            num_experts_per_tok=2, first_k_dense_replace=1, kv_lora_rank=32, qk_nope_head_dim=32,
                            qk_rope_head_dim=16, v_head_dim=32)
D, H, LAYERS, L, C, BUCKETS = 128, 4, 3, 32, 12, 512
# bf16 products and roundings through 3 layers and the readout, against f32:
# the largest logit gap over the RMS logit read 0.009-0.03 on these seeds
BF16_BOUND = 0.06
SPANS = ("phoenix.forward", "phoenix.attention", "phoenix.moe.route", "phoenix.moe.dispatch", "phoenix.moe.experts",
         "phoenix.moe.combine", "phoenix.readout")


def _config(dtype, decoder=SMALL, layers=LAYERS, d=D, heads=H, history=L):
    return phoenix.PhoenixConfig(d_model=d, n_layers=layers, n_heads=heads, max_history=history,
                                 author_buckets=BUCKETS, dtype=dtype, decoder=decoder)


def _model(dtype, seed=0):
    m = phoenix.PhoenixModel(_config(dtype), device="cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in m.moe_layers():
            layer.gate.e_score_correction_bias.uniform_(-0.05, 0.05, generator=torch.Generator().manual_seed(seed))
    return m


def _ref_cfg():
    return dict(dataclasses.asdict(SMALL), hidden_size=D, num_attention_heads=H, num_hidden_layers=LAYERS,
                author_buckets=BUCKETS)


def _batch(seed, lengths=(L, 20, 5), history=L):
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    valid = torch.arange(history)[None, :] >= history - torch.tensor(lengths)[:, None]
    seq = phoenix.UserActionSequence(
        (torch.randint(1, phoenix.NUM_ACTIONS, (B, history), generator=g) * valid).to(torch.int32),
        torch.randint(0, BUCKETS, (B, history), generator=g, dtype=torch.int32),
        torch.randint(0, 14 * 86400, (B, history), generator=g, dtype=torch.int32), valid)
    cands = phoenix.CandidateFeatures(torch.randint(0, BUCKETS, (B, C), generator=g, dtype=torch.int32),
                                      torch.randint(0, 2, (B, C, phoenix.NUM_BOOL_FEATURES), generator=g).float(),
                                      torch.ones((B, C), dtype=torch.bool))
    return seq, cands


def _run(model, seq, cands):
    """(logits, each routed layer's experts) of one forward."""
    layers = model.moe_layers()
    for layer in layers:
        layer.route_log = []
    with torch.no_grad():
        logits = model(seq, cands)
    routes = [layer.route_log[0] for layer in layers]
    for layer in layers:
        layer.route_log = None
    return logits, routes


def _gap(logits, want):
    return float((logits - want).abs().max() / want.pow(2).mean().sqrt())


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_port_matches_the_reference(seed):
    model, (seq, cands) = _model("float32", seed), _batch(seed + 10)
    logits, routes = _run(model, seq, cands)
    r = ref.forward(dict(model.state_dict()), _ref_cfg(), tuple(seq), tuple(cands), routes=routes)
    assert r["route_far"] == 0 and r["route_differ"] == 0
    assert float((logits - r["logits"]).abs().max() / r["logits"].abs().max()) <= 1e-5
    own = ref.forward(dict(model.state_dict()), _ref_cfg(), tuple(seq), tuple(cands))  # its own routes: the same
    assert torch.equal(own["logits"], r["logits"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_port_within_its_bound_of_the_reference(seed):
    model, (seq, cands) = _model("bfloat16", seed), _batch(seed + 20)
    assert model.layers[1].mlp.experts.gate_proj.dtype == torch.bfloat16
    assert model.layers[1].mlp.gate.e_score_correction_bias.dtype == torch.float32
    logits, routes = _run(model, seq, cands)
    r = ref.forward(dict(model.state_dict()), _ref_cfg(), tuple(seq), tuple(cands), routes=routes)
    assert r["route_far"] == 0
    assert _gap(logits, r["logits"]) <= BF16_BOUND


def test_the_router_rule():
    """The correction bias chooses and does not weigh; the chosen unbiased
    scores are normalised and scaled."""
    moe = mt.MoE(8, dataclasses.replace(SMALL, n_routed_experts=4, num_experts_per_tok=2,
                                        routed_scaling_factor=2.5), torch.float32, "cpu", None)
    with torch.no_grad():
        moe.gate.weight.copy_(torch.eye(4, 8))
        moe.gate.e_score_correction_bias.copy_(torch.tensor([0.0, 0.0, 0.0, 1.0]))
    x = torch.tensor([[3.0, 2.0, 1.0, 0.0, 9.0, 9.0, 9.0, 9.0]])  # logits 3, 2, 1, 0
    idx, w = moe.route(x)
    assert sorted(idx[0].tolist()) == [0, 3]  # expert 3 only through its bias
    s = torch.sigmoid(torch.tensor([3.0, 0.0]))
    want = dict(zip([0, 3], (s / s.sum() * 2.5).tolist()))
    assert {e: v for e, v in zip(idx[0].tolist(), w[0].tolist())} == pytest.approx(want, rel=1e-6)
    unnormed = mt.MoE(8, dataclasses.replace(SMALL, n_routed_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
                                             routed_scaling_factor=2.5), torch.float32, "cpu", None)
    unnormed.load_state_dict(moe.state_dict())
    _, w2 = unnormed.route(x)
    assert sorted(w2[0].tolist()) == pytest.approx(sorted((torch.sigmoid(torch.tensor([3.0, 0.0])) * 2.5).tolist()))


def test_left_padding_and_an_all_padding_history():
    """A request's answer does not depend on how far its history is
    padded (RoPE sees relative positions only); an all-padding history
    gives finite logits, as the reference's."""
    model = _model("float32", 3)
    seq, cands = _batch(4, lengths=(9,))
    short = phoenix.UserActionSequence(*(t[:, L - 16:] for t in seq))  # the same 9 tokens, 7 slots of padding
    with torch.no_grad():
        a, b = model(seq, cands), model(short, cands)
    assert float((a - b).abs().max() / a.abs().max()) <= 1e-5
    empty = phoenix.UserActionSequence(seq.action_ids * 0, seq.author_hashes, seq.age_s, seq.valid & False)
    logits, routes = _run(model, empty, cands)
    assert bool(torch.isfinite(logits).all())
    r = ref.forward(dict(model.state_dict()), _ref_cfg(), tuple(empty), tuple(cands), routes=routes)
    assert float((logits - r["logits"]).abs().max() / r["logits"].abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_batch_of_one_equals_the_unbatched_call(dtype):
    model = _model(dtype, 5)
    seq, cands = _batch(6, lengths=(17,))
    with torch.no_grad():
        batched = model(seq, cands)[0]
        single = model(phoenix.UserActionSequence(*(t[0] for t in seq)),
                       phoenix.CandidateFeatures(*(t[0] for t in cands)))
    assert torch.equal(batched, single)


def test_serving_entry_points():
    model = _model("bfloat16", 7)
    seq, cands = _batch(8, lengths=(11,))
    one_seq = phoenix.UserActionSequence(*(t[0] for t in seq))
    with torch.no_grad():
        want = phoenix.predict_next_actions(model, one_seq, phoenix.CandidateFeatures(*(t[0] for t in cands)))
    got = phoenix.scorer_predict_fn(model)(cands.author_hashes[0].numpy(), cands.bool_features[0].numpy(),
                                           cands.valid[0].numpy(), one_seq)
    assert torch.equal(torch.from_numpy(got), want)

    class Query:
        features = {"user_actions": one_seq}

    class Cand:
        def __init__(self, i):
            self.features, self.score = {"author_id": int(cands.author_hashes[0, i])}, None

    scored = [Cand(i) for i in range(C)]
    PhoenixScorer(phoenix.scorer_predict_fn(model)).score(Query(), scored, None)
    assert all(c.score is not None and math.isfinite(c.score) for c in scored)


def _dispatch_case(seed, T=40, E=6, k=2, d=24, inner=20):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=g)
    # uneven groups, experts 1 and 4 empty
    scores = torch.rand(T, E, generator=g) + torch.tensor([2.0, -9.0, 0.0, 1.0, -9.0, 0.5])
    idx = torch.topk(scores, k, dim=-1).indices
    w = torch.rand(T, k, generator=g)
    wg, wu = torch.randn(E, inner, d, generator=g), torch.randn(E, inner, d, generator=g)
    wd = torch.randn(E, d, inner, generator=g)
    return x, idx, w, wg, wu, wd


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_gemm_plain_matches_per_expert_matmuls(seed):
    x, idx, w, wg, wu, wd = _dispatch_case(seed)
    T, k = idx.shape
    E = wg.shape[0]
    d = expert_gemm.dispatch(idx, E)
    counts, bm = d.counts.tolist(), expert_gemm.TILES.bm
    assert counts[1] == counts[4] == 0 and sum(counts) == T * k
    assert d.tiles.tolist() == [0] + torch.cumsum(torch.tensor([-(-c // bm) for c in counts]), 0).tolist()
    assert expert_gemm.max_tiles(T * k, E) >= d.tiles[-1]
    shared, res = torch.randn(T, x.shape[1]), torch.randn(T, x.shape[1])
    y = expert_gemm.expert_down(expert_gemm.expert_swiglu(x, wg, wu, d), wd, d)
    out = expert_gemm.moe_combine(y, w, shared, res)
    want = res + shared
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(wg[e] @ x[t]) * (wu[e] @ x[t])
            want[t] += w[t, j] * (wd[e] @ h)
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-4)


def test_the_two_reference_copies_are_equal():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "phoenix_moonlight_reference.py"),
                       os.path.join(ROOT, "portbench", "reference", "phoenix_moonlight.py"), shallow=False)


@pytest.mark.parametrize("module", ["phoenix_moonlight_reference", "portbench.reference.phoenix_moonlight"])
def test_a_reference_copy_imports_neither_the_port_nor_jax(module):
    code = f"import {module}, sys, json; print(json.dumps(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] in ("the_algorithm_tpu_torch", "the_algorithm_tpu", "jax",
                                                          "jaxlib", "flax", "triton")]


def test_spans_open_under_a_profiler_only_and_the_counter_sums_to_k_tokens(monkeypatch):
    model = _model("bfloat16", 9)
    seq, cands = _batch(10)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(seq, cands)
    names = {e.name for e in prof.events()}
    assert set(SPANS) <= names
    tokens = seq.valid.numel()
    for layer in model.moe_layers():
        assert layer.last_counts.shape == (SMALL.n_routed_experts,)
        assert int(layer.last_counts.sum()) == SMALL.num_experts_per_tok * tokens
    opened = []
    monkeypatch.setattr(metrics, "record_function", lambda name: opened.append(name))
    with torch.no_grad():
        model(seq, cands)
    assert opened == []


def test_moonlight_builds_every_layer_and_expert_at_its_published_widths():
    """The full configuration on the meta device: 27 layers (1 dense, 26
    routed), 64 routed + 2 shared experts each, every width as published,
    the stack in bf16."""
    cfg = phoenix.PhoenixConfig(d_model=2048, n_layers=27, n_heads=16, max_history=1024,
                                decoder=mt.MoEDecoderConfig())
    m = phoenix.PhoenixModel(cfg, device="meta")
    assert len(m.layers) == 27 and isinstance(m.layers[0].mlp, mt.SwiGLU) and len(m.moe_layers()) == 26
    a = m.layers[1].self_attn
    assert tuple(a.q_proj.weight.shape) == (16 * 192, 2048)
    assert tuple(a.kv_a_proj_with_mqa.weight.shape) == (512 + 64, 2048)
    assert tuple(a.kv_b_proj.weight.shape) == (16 * 256, 512)
    assert tuple(a.o_proj.weight.shape) == (2048, 16 * 128)
    e = m.layers[1].mlp
    assert tuple(e.experts.gate_proj.shape) == (64, 1408, 2048) and tuple(e.experts.down_proj.shape) == (64, 2048, 1408)
    assert tuple(e.shared_experts.gate_proj.weight.shape) == (2816, 2048)
    assert tuple(m.layers[0].mlp.gate_proj.weight.shape) == (11264, 2048)
    stack = sum(p.numel() for p in m.layers.parameters())
    assert 15.2e9 < stack < 15.4e9  # ~30.6 GB in bf16
    assert {p.dtype for n, p in m.layers.named_parameters() if p.dim() >= 2} == {torch.bfloat16}
