"""``graph/tweepcred.py`` against the JAX package's: PageRank at a fixed
number of iterations (threshold 0) and to convergence (the same iteration
count), its deterministic in-edge sum (a negative destination wraps, one
past the end drops, as JAX's scatter), and the reputation helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.graph import tweepcred as jtc
from the_algorithm_tpu_torch.graph import tweepcred as tc

N, D = 400, 12


def _graph(seed, dangling=0.1):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N, (N, D)).astype(np.int32)
    dst[rng.random((N, D)) < 0.3] = PAD_ID
    dst[rng.random(N) < dangling] = PAD_ID  # nodes with no out-edge
    w = rng.random((N, D)).astype(np.float32)
    prior = rng.random(N).astype(np.float32)
    return dst, w, prior


def _both(dst, w, prior, params):
    got, it = tc.weighted_pagerank(tc.OutEdges(torch.from_numpy(dst), torch.from_numpy(w)), torch.from_numpy(prior),
                                   tc.PageRankParams(**params))
    want = jax.jit(lambda d, x, p: jtc.weighted_pagerank(jtc.OutEdges(d, x), p, jtc.PageRankParams(**params)))(
        jnp.asarray(dst), jnp.asarray(w), jnp.asarray(prior))
    return got.numpy(), it, np.asarray(want)


def test_pagerank_fixed_iterations_matches_jax():
    dst, w, prior = _graph(0)
    for iters in (1, 5, 12):
        got, it, want = _both(dst, w, prior, dict(threshold=0.0, max_iterations=iters))
        assert it == iters
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
        assert abs(float(got.sum()) - 1.0) < 1e-4


def test_pagerank_converges_in_jax_iteration_count():
    dst, w, prior = _graph(1)
    for threshold in (1e-3, 1e-5):
        got, it, want = _both(dst, w, prior, dict(threshold=threshold, max_iterations=50))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
        # JAX's loop ran while diff > threshold: replay its count in float64-free numpy
        pr, n, diff = prior / prior.sum(), 0, np.inf
        valid = dst != PAD_ID
        wn = np.where(valid, w, 0) / np.maximum(np.where(valid, w, 0).sum(1, keepdims=True), 1e-30)
        while diff > np.float32(threshold) and n < 50:
            new = np.zeros(N, np.float32)
            np.add.at(new, dst[valid], (pr[:, None] * wn)[valid])
            dm = pr[~valid.any(1) | (np.where(valid, w, 0).sum(1) <= 0)].sum()
            new = 0.15 * (prior / prior.sum()) + 0.85 * (new + dm * prior / prior.sum())
            diff, pr, n = np.abs(new - pr).sum(), new, n + 1
        assert it == n and 1 < it < 50


def test_in_edge_sum_wraps_and_drops_as_jax_scatter():
    dst, w, prior = _graph(2, dangling=0.0)
    dst[0, :3] = [-1, -N, N + 5]  # -1 → N-1, -N → 0, N+5 dropped
    got, _, want = _both(dst, w, prior, dict(threshold=0.0, max_iterations=3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_reputation_helpers_match_jax():
    rng = np.random.default_rng(3)
    pr = np.r_[np.float32([0.0, 1e-21, 1e-20]), rng.random(64).astype(np.float32) * 1e-3,
               # 130 + 5.21 ln(x) at half-way points: round half to even on both
               np.exp((np.float32([70.5, 71.5, 0.5]) - 130.0) / 5.21).astype(np.float32)]
    np.testing.assert_array_equal(tc.scaled_reputation(torch.from_numpy(pr)).numpy(),
                                  np.asarray(jtc.scaled_reputation(jnp.asarray(pr))))
    mass = rng.random(64).astype(np.float32)
    followers = rng.integers(0, 5000, 64).astype(np.int32)
    followings = rng.integers(0, 9000, 64).astype(np.int32)
    np.testing.assert_allclose(
        tc.adjust_post_calculation(*(torch.from_numpy(a) for a in (mass, followers, followings))).numpy(),
        np.asarray(jtc.adjust_post_calculation(*(jnp.asarray(a) for a in (mass, followers, followings)))), rtol=1e-6)
    flags = [rng.random(64) < p for p in (0.1, 0.05)]
    age = rng.integers(0, 1000, 64).astype(np.int32)
    device, restricted = rng.random(64) < 0.5, rng.random(64) < 0.1
    args = (flags[0], flags[1], age, device, restricted)
    np.testing.assert_allclose(tc.user_mass_prior(*(torch.from_numpy(a) for a in args)).numpy(),
                               np.asarray(jtc.user_mass_prior(*(jnp.asarray(a) for a in args))), rtol=1e-6)
