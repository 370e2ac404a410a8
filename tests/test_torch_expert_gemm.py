"""The grouped expert GEMM's kernels against their plain versions on the
card, at Moonlight-16B-A3B's widths and at small uneven ones, with uneven
and empty groups; the launches of a decoder-kind forward.

These tests need an NVIDIA GPU and skip elsewhere. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_expert_gemm.py
"""

import dataclasses

import pytest
import torch
from torch_port_util import cuda_device  # noqa: F401

from the_algorithm_tpu_torch import _build
from the_algorithm_tpu_torch.models import moe_transformer as mt
from the_algorithm_tpu_torch.models import phoenix
from the_algorithm_tpu_torch.ops import expert_gemm

pytestmark = pytest.mark.gpu

# (tokens, experts, k, hidden, expert width): the cell's batch and widths;
# widths that fit no tile evenly; depths below one k-step (the prologue's
# second stage wholly past K) with more tiles than the card has SMs
SHAPES = [(16384, 64, 6, 2048, 1408), (300, 8, 2, 200, 72), (20000, 8, 2, 40, 24)]


def _case(dev, T, E, k, d, inner, seed):
    """Routing with uneven groups and two empty experts; bf16 operands of
    the layer's scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    skew = torch.linspace(0.0, 3.0, E, device=dev)
    skew[[1, E // 2]] = -100.0  # never chosen
    idx = torch.topk(torch.rand(T, E, generator=g, device=dev) * 4 + skew, k, dim=-1).indices
    x = torch.randn(T, d, generator=g, device=dev).to(torch.bfloat16)
    wg = (torch.randn(E, inner, d, generator=g, device=dev) / d ** 0.5).to(torch.bfloat16)
    wu = (torch.randn(E, inner, d, generator=g, device=dev) / d ** 0.5).to(torch.bfloat16)
    wd = (torch.randn(E, d, inner, generator=g, device=dev) / inner ** 0.5).to(torch.bfloat16)
    w = torch.rand(T, k, generator=g, device=dev)
    return idx, x, wg, wu, wd, w


def _close(got, want):
    """Both sum in f32 and round once to bf16, in other orders: within a
    bf16 step of the result's scale."""
    tol = 2.0 ** -7 * float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("T, E, k, d, inner", SHAPES)
def test_grouped_gemm_matches_its_plain_version(cuda_device, T, E, k, d, inner):
    idx, x, wg, wu, wd, w = _case(cuda_device, T, E, k, d, inner, seed=T)
    disp = expert_gemm.dispatch(idx, E)
    counts = disp.counts.tolist()
    assert counts[1] == counts[E // 2] == 0 and sum(counts) == T * k and len(set(counts)) > 2
    before = (_build.launches(expert_gemm.expert_swiglu), _build.launches(expert_gemm.expert_down))
    with torch.no_grad():
        h = expert_gemm.expert_swiglu(x, wg, wu, disp)
        y = expert_gemm.expert_down(h, wd, disp)
    torch.cuda.synchronize()
    assert (_build.launches(expert_gemm.expert_swiglu), _build.launches(expert_gemm.expert_down)) == (
        before[0] + 1, before[1] + 1)
    _close(h, expert_gemm.expert_swiglu_plain(x, wg, wu, disp))
    _close(y, expert_gemm.expert_down_plain(h, wd, disp))  # the same rows in, so the down product alone
    shared, res = torch.randn_like(x), torch.randn_like(x)
    out = expert_gemm.moe_combine(y, w, shared, res)
    torch.cuda.synchronize()
    _close(out, expert_gemm.moe_combine_plain(y, w, shared, res))


def test_a_decoder_forward_launches_each_kernel_once_a_routed_layer(cuda_device):
    cfg = phoenix.PhoenixConfig(d_model=256, n_layers=4, n_heads=4, max_history=64, author_buckets=1024,
                                decoder=dataclasses.replace(mt.MoEDecoderConfig(), n_routed_experts=16,
                                                            moe_intermediate_size=128, intermediate_size=512))
    model = phoenix.PhoenixModel(cfg, device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(0))
    B, L, C = 2, 64, 40
    seq = phoenix.UserActionSequence(torch.ones((B, L), dtype=torch.int32, device=cuda_device),
                                     torch.arange(B * L, dtype=torch.int32, device=cuda_device).view(B, L),
                                     torch.zeros((B, L), dtype=torch.int32, device=cuda_device),
                                     torch.ones((B, L), dtype=torch.bool, device=cuda_device))
    cands = phoenix.CandidateFeatures(torch.arange(B * C, dtype=torch.int32, device=cuda_device).view(B, C),
                                      torch.zeros((B, C, phoenix.NUM_BOOL_FEATURES), device=cuda_device),
                                      torch.ones((B, C), dtype=torch.bool, device=cuda_device))
    wrappers = (expert_gemm.expert_swiglu, expert_gemm.expert_down, expert_gemm.moe_combine)
    before = [_build.launches(f) for f in wrappers]
    with torch.inference_mode():
        probs = phoenix.predict_next_actions(model, seq, cands)
    torch.cuda.synchronize()
    routed = len(model.moe_layers())
    assert routed == 3 and [_build.launches(f) - b for f, b in zip(wrappers, before)] == [routed] * 3
    assert bool(torch.isfinite(probs).all())
    for layer in model.moe_layers():
        assert int(layer.last_counts.sum()) == cfg.decoder.num_experts_per_tok * B * L
