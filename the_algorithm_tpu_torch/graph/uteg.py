"""UTEG: user-tweet engagement-graph collaborative filtering.

Counterpart of ``the_algorithm_tpu/graph/uteg.py``
(``src/scala/com/twitter/recos/user_tweet_entity_graph/``, GraphJet): an
in-memory bipartite user↔tweet graph over the last 24-48h of engagements; a
query seeds from the user's weighted follow/RealGraph circle, traverses the
seeds' recent engagements, and aggregates per-tweet weighted counts → "liked
by people you follow" candidates with social proof.

The left index (user → recent engaged tweets) is a fixed-width ring-buffered
table on the device. :func:`recommend` is batched like the port's retrieval
— R queries of S seeds at once, what ``jax.vmap`` of the JAX function
computes: one :func:`~the_algorithm_tpu_torch.ops.gather.row_gather` launch
fetches the seeds' rows of all three tables, the entries dedup through
:func:`~the_algorithm_tpu_torch.ops.retrieval._dedup_sum` (the run-collapse
kernel, two value arrays), and a top-K ranks them in ``lax.top_k``'s order.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.retrieval import PerQuery, _dedup_sum, _per_query, top_k
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


class EngagementType(enum.IntEnum):
    """≡ UTEG edge types (tweet side)."""

    CLICK = 0
    FAVORITE = 1
    RETWEET = 2
    REPLY = 3
    TWEET = 4  # original-tweet authorship
    QUOTE = 5


DEFAULT_TYPE_WEIGHTS = np.array(
    [0.25, 1.0, 1.0, 1.0, 1.0, 1.0], np.float32
)  # click discounted, engagement types equal (UTEG config defaults)


def _tables_from_numpy(arrays, device, what):
    dev = resolve(device, what)
    return [torch.from_numpy(np.array(a, np.int32)).to(dev) for a in arrays]


class EngagementGraph(NamedTuple):
    """Left index: user → last-W engaged tweets (ring buffer, newest first)."""

    tweet_ids: torch.Tensor  # [U, W] int32 PAD_ID padded
    engagement_type: torch.Tensor  # [U, W] int32
    timestamps: torch.Tensor  # [U, W] int32

    @classmethod
    def from_numpy(cls, tweet_ids, engagement_type, timestamps, device=None) -> "EngagementGraph":
        """The graph from the JAX package's arrays (as numpy), on ``device``
        (default: the card)."""
        return cls(*_tables_from_numpy((tweet_ids, engagement_type, timestamps), device, "EngagementGraph"))


def init_graph(num_users: int, width: int = 64, device=None) -> EngagementGraph:
    """An empty graph on ``device`` (default: the card)."""
    dev = resolve(device, "EngagementGraph")
    return EngagementGraph(
        torch.full((num_users, width), PAD_ID, dtype=torch.int32, device=dev),
        torch.zeros((num_users, width), dtype=torch.int32, device=dev),
        torch.zeros((num_users, width), dtype=torch.int32, device=dev),
    )


def _on(x, dev, dtype) -> torch.Tensor:
    """``x`` (a tensor, array or sequence) as a flat tensor on ``dev``."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.to(dev, dtype).reshape(-1)


def ring_append(tables: Sequence[torch.Tensor], rows, values: Sequence) -> Tuple[torch.Tensor, ...]:
    """Push events onto the front of ring-buffer rows, newest first.

    ``tables`` are aligned [N, W]; event i puts ``values[j][i]`` at the
    front of row ``rows[i]`` of table j, shifting that row right by one and
    dropping its oldest entry. The result equals the JAX package's per-event
    loop (``uteg.py:73-79``) in one pass: a row that gets c events in the
    batch keeps its old entries c places further right, and its events fill
    the first c places, the batch's last event first. Rows index as numpy
    does (a negative row counts from the end; one outside [-N, N) raises).
    The events move to the tables' device; returns new tables.
    """
    N, W = tables[0].shape
    dev = tables[0].device
    r = _on(rows, dev, torch.int64)
    if r.numel() and not bool(((r >= -N) & (r < N)).all()):
        raise IndexError(f"event row outside [-{N}, {N})")
    r = torch.where(r < 0, r + N, r)
    n = r.numel()
    sorted_r, order = torch.sort(r, stable=True)
    counts = torch.bincount(r, minlength=N)  # [N] events per row
    start = torch.cumsum(counts, 0) - counts  # first event of each row in sorted order
    rank = counts[sorted_r] - 1 - (torch.arange(n, device=dev) - start[sorted_r])  # 0 = newest
    keep = rank < W
    src = torch.arange(W, device=dev)[None, :] - counts[:, None]  # old slot that lands in each slot
    out = []
    for table, vals in zip(tables, values):
        shifted = torch.gather(table, 1, src.clamp(min=0))  # slots with src < 0 are all overwritten below
        v = _on(vals, dev, table.dtype)
        shifted[sorted_r[keep], rank[keep]] = v[order[keep]]
        out.append(shifted)
    return tuple(out)


def record_engagements(
    graph: EngagementGraph,
    user_ids,
    tweet_ids,
    types,
    timestamps,
) -> EngagementGraph:
    """Batch append (the Kafka/recos-injector feed), on the graph's device."""
    return EngagementGraph(*ring_append(graph, user_ids, (tweet_ids, types, timestamps)))


def safe_rows(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The row each id reads: a PAD id reads row 0 (its entries are masked
    later), an out-of-range one the row JAX's gather reads."""
    return jax_rows(torch.where(ids != PAD_ID, ids, 0), num_rows)


def engagement_entries(
    graph: EngagementGraph,
    seed_ids: torch.Tensor,  # [R, S]
    seed_weights: torch.Tensor,  # [R, S]
    *,
    type_weights: Optional[torch.Tensor] = None,
    min_timestamp: Optional[PerQuery] = None,
    exclude_types=(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The traversal's entries before dedup, flat per query: (tweet ids,
    seed weight · type weight, 1.0 per valid entry), each [R, S·W]; entries
    filtered out are PAD_ID / 0."""
    if type_weights is None:
        type_weights = torch.from_numpy(DEFAULT_TYPE_WEIGHTS).to(seed_weights.device)
    valid_seed = seed_ids != PAD_ID
    rows_t, rows_e, rows_ts = row_gather(
        safe_rows(seed_ids, graph.tweet_ids.shape[0]), graph.tweet_ids, graph.engagement_type, graph.timestamps
    )  # [R, S, W] each
    valid = (rows_t != PAD_ID) & valid_seed[..., None]
    if min_timestamp is not None:
        valid &= rows_ts >= _per_query(min_timestamp, 3)
    for et in exclude_types:
        valid &= rows_e != int(et)
    w = seed_weights[..., None] * type_weights[jax_rows(rows_e, type_weights.shape[0])]
    R = seed_ids.shape[0]
    return (torch.where(valid, rows_t, PAD_ID).reshape(R, -1),
            torch.where(valid, w, 0.0).reshape(R, -1),
            valid.float().reshape(R, -1))


def rank_deduped(uniq: torch.Tensor, scores: torch.Tensor, proof: torch.Tensor, *, max_results: int,
                 min_proof) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K of deduped [R, W] rows whose proof reaches ``min_proof`` →
    (ids, scores, proof), each [R, min(max_results, W)]; slots past the
    last hit are PAD_ID / -inf / 0."""
    ok = (uniq != PAD_ID) & (proof >= min_proof)
    top_s, idx = top_k(torch.where(ok, scores, -torch.inf), min(max_results, scores.shape[-1]))
    found = torch.isfinite(top_s)
    return (torch.where(found, torch.gather(uniq, 1, idx), PAD_ID), top_s,
            torch.where(found, torch.gather(proof, 1, idx), 0.0))


def recommend(
    graph: EngagementGraph,
    seed_ids: torch.Tensor,  # [R, S] int32 (each user's follows / RealGraph top-K)
    seed_weights: torch.Tensor,  # [R, S] float32 (RealGraph edge weights)
    *,
    max_results: int,
    type_weights: Optional[torch.Tensor] = None,
    min_timestamp: Optional[PerQuery] = None,
    min_social_proof: int = 1,
    exclude_types=(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Left-seeded traversal + weighted aggregation for R queries.

    Returns (tweet_ids, scores, social_proof_counts), each [R, X] with
    X = min(max_results, S·W): score(t) = Σ_{seed s engaged t}
    seed_weight(s) · type_weight(engagement); social proof counts the
    seeds' engagements of t (≥ min_social_proof kept), which is the number
    of distinct seeds engaging t unless a seed repeats or engaged t twice.
    ``min_timestamp`` is one value for all queries or a [R] tensor.
    """
    entries = engagement_entries(graph, seed_ids, seed_weights, type_weights=type_weights,
                                 min_timestamp=min_timestamp, exclude_types=exclude_types)
    uniq, scores, proof = _dedup_sum(*entries)
    return rank_deduped(uniq, scores, proof, max_results=max_results, min_proof=min_social_proof)
