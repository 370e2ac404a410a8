"""Tweepcred: weighted PageRank → user reputation [0, 100].

Counterpart of ``the_algorithm_tpu/graph/tweepcred.py``
(``src/scala/com/twitter/graph/batch/job/tweepcred/``:
``WeightedPageRank.doPageRank:163`` — power iteration, damping via reset
probability, convergence threshold 0.001 —, ``UserMass.scala`` prior mass
heuristics, ``Reputation.scaledReputation`` and
``Reputation.adjustReputationsPostCalculation``).

The power iteration runs over a fixed-width weighted out-edge adjacency
[N, D]. Its in-edge sum is deterministic: the edges' destinations are sorted
once (stable) before the loop, and each iteration collapses the permuted
contributions with one run-collapse launch over the sorted [1, N·D] row and
writes each destination's total once — no float atomic. The JAX package's
``while diff > threshold`` runs on the device; here the test runs on the
host, one read of the f32 difference an iteration, and
:func:`weighted_pagerank` returns the iterations it took beside pr.
``torch.round`` rounds half to even, as ``jnp.round``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from the_algorithm_tpu_torch.ops.seg_scan import run_collapse_sorted
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


@dataclasses.dataclass(frozen=True)
class PageRankParams:
    """≡ WeightedPageRank args (defaults from the job)."""

    reset_prob: float = 0.15  # RESET_PROB default
    threshold: float = 0.001  # convergence: total L1 diff
    max_iterations: int = 20


class OutEdges(NamedTuple):
    """Weighted out-adjacency [N, D] (PAD_ID padded), weights ≥ 0."""

    dst: torch.Tensor  # int32
    weight: torch.Tensor  # float32


class InEdgeSum:
    """new[v] = Σ contributions of the edges into v, for a fixed edge set:
    the stable sort of the destinations and each run's last slot, found
    once; each call one run-collapse launch and one write of the totals."""

    def __init__(self, dst: torch.Tensor, valid: torch.Tensor, num_nodes: int):
        d = torch.where(dst < 0, dst + num_nodes, dst)  # JAX's scatter: a negative id wraps, one outside drops
        inside = valid & (d >= 0) & (d < num_nodes)
        flat = torch.where(inside, d, PAD_ID).reshape(1, -1).to(torch.int32)
        self.sorted, self.order = torch.sort(flat, dim=-1, stable=True)
        s = self.sorted[0]
        last = torch.ones_like(s, dtype=torch.bool)
        last[:-1] = s[:-1] != s[1:]
        self.ends = torch.nonzero(last & (s != PAD_ID))[:, 0]  # one host sync, before the loop
        self.rows = s[self.ends].long()
        self.num_nodes = num_nodes

    def __call__(self, contrib: torch.Tensor) -> torch.Tensor:
        vals = torch.take_along_dim(contrib.reshape(1, -1), self.order, dim=-1)
        _, sums = run_collapse_sorted(self.sorted, vals)
        out = torch.zeros(self.num_nodes, dtype=torch.float32, device=contrib.device)
        return out.index_put_((self.rows,), sums[0, self.ends])


def weighted_pagerank(
    edges: OutEdges,
    prior_mass: torch.Tensor,  # [N] user-mass prior
    params: PageRankParams = PageRankParams(),
):
    """Power iteration: pr ← reset·prior + (1-reset)·WT·pr (+ dangling mass).

    Out-edge weights are row-normalized; dangling nodes redistribute via the
    prior (the reference folds them into reset mass). Returns (pr [N],
    iterations).
    """
    N = edges.dst.shape[0]
    valid = edges.dst != PAD_ID
    w = torch.where(valid, edges.weight, 0.0)
    row_sum = w.sum(1)
    w_norm = w / torch.clamp(row_sum[:, None], min=1e-30)
    dangling = row_sum <= 0
    prior = prior_mass / torch.clamp(prior_mass.sum(), min=1e-30)
    in_sum = InEdgeSum(edges.dst, valid, N)
    threshold = float(np.float32(params.threshold))  # compared in f32, as JAX's
    pr, diff, it = prior, float("inf"), 0
    while diff > threshold and it < params.max_iterations:
        new = in_sum(torch.where(valid, pr[:, None] * w_norm, 0.0))
        dangling_mass = torch.where(dangling, pr, 0.0).sum()
        new = params.reset_prob * prior + (1 - params.reset_prob) * (new + dangling_mass * prior)
        diff = float(torch.abs(new - pr).sum())
        pr, it = new, it + 1
    return pr, it


def scaled_reputation(pagerank: torch.Tensor) -> torch.Tensor:
    """≡ ``Reputation.scaledReputation``: 130 + 5.21·ln(pr), clipped [0,100]."""
    raw = torch.where(pagerank < 1e-20, 1e-20, pagerank)
    e = torch.clamp(torch.round(130.0 + 5.21 * torch.log(raw)), 0.0, 100.0)
    return torch.where(pagerank < 1e-20, 0.0, e)


def adjust_post_calculation(
    mass: torch.Tensor,  # [N] pagerank mass
    num_followers: torch.Tensor,  # [N] int
    num_followings: torch.Tensor,  # [N] int
) -> torch.Tensor:
    """≡ ``Reputation.adjustReputationsPostCalculation``: downweight
    low-follower/high-following accounts (follow-spam heuristic)."""
    thresh_friends = 2500
    ratio_thresh = 0.6
    c = 3.0
    max_div = 50.0
    ratio = (1.0 + num_followings) / (1.0 + num_followers)
    loglog = torch.log(torch.log(torch.clamp(num_followings.float(), min=3.0)))
    div = torch.clamp(torch.exp(c * (ratio - ratio_thresh) * loglog), 1.0, max_div)
    return torch.where(num_followings > thresh_friends, mass / div, mass)


def user_mass_prior(
    is_suspended: torch.Tensor,
    is_verified: torch.Tensor,
    account_age_days: torch.Tensor,
    has_valid_device: torch.Tensor,
    is_restricted: torch.Tensor,
) -> torch.Tensor:
    """≡ ``UserMass.getUserMass`` heuristics (device/age weights, restricted
    multiplier, suspended → 0, verified → full mass)."""
    device_w = 0.5
    age_w = 0.2
    restricted_mult = 0.1
    age_factor = torch.clamp(account_age_days.float() / 365.0, 0.0, 1.0)
    mass = 1.0 + device_w * has_valid_device.float() + age_w * age_factor
    mass = torch.where(is_verified, 100.0, mass)
    mass = torch.where(is_restricted, mass * restricted_mult, mass)
    return torch.where(is_suspended, 0.0, mass)
