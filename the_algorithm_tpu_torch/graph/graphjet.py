"""GraphJet graph family: UTG / UVG related-tweets + UUG user recs.

Counterpart of ``the_algorithm_tpu/graph/graphjet.py``
(``src/scala/com/twitter/recos/{user_tweet_graph,user_video_graph,
user_user_graph}/``): UTEG's siblings. UTG/UVG answer tweet-based queries —
"tweets co-engaged with this tweet" via a two-hop traversal (tweet →
engaging users → their other tweets) with cosine-normalized co-engagement
counts; UVG is the same over a video-tweet mask; UUG records user→user
interactions and answers "users my circle engaged".

Both sides of the bipartite graph are fixed-width ring-buffered tables on
the device (left: user → engaged tweets, the UTEG graph; right: tweet →
engaging users). Queries are batched: :func:`related_tweets` takes B source
tweets, each hop one :func:`~the_algorithm_tpu_torch.ops.gather.row_gather`
launch, the co-occurrences dedup through the run-collapse kernel, and a
top-K ranks them in ``lax.top_k``'s order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.graph.uteg import (
    EngagementGraph, _tables_from_numpy, rank_deduped, ring_append, safe_rows)
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.retrieval import PerQuery, _dedup_sum, _per_query
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


class RightIndex(NamedTuple):
    """Right side of the bipartite graph: tweet → last-W engaging users."""

    user_ids: torch.Tensor  # [T, W] int32, PAD_ID padded (newest first)
    timestamps: torch.Tensor  # [T, W] int32

    @classmethod
    def from_numpy(cls, user_ids, timestamps, device=None) -> "RightIndex":
        """The index from the JAX package's arrays (as numpy), on ``device``
        (default: the card)."""
        return cls(*_tables_from_numpy((user_ids, timestamps), device, "RightIndex"))


def init_right_index(num_tweets: int, width: int = 128, device=None) -> RightIndex:
    """An empty right index on ``device`` (default: the card)."""
    dev = resolve(device, "RightIndex")
    return RightIndex(
        torch.full((num_tweets, width), PAD_ID, dtype=torch.int32, device=dev),
        torch.zeros((num_tweets, width), dtype=torch.int32, device=dev),
    )


def record_right(index: RightIndex, tweet_ids, user_ids, timestamps) -> RightIndex:
    """Batch append (mirrors ``uteg.record_engagements``)."""
    return RightIndex(*ring_append(index, tweet_ids, (user_ids, timestamps)))


def degree(rows: torch.Tensor) -> torch.Tensor:
    """#real entries per ring-buffer row."""
    return (rows != PAD_ID).sum(-1)


def cooccurrence_entries(
    left: EngagementGraph,
    right: RightIndex,
    source_tweet_ids: torch.Tensor,  # [B]
    *,
    min_timestamp: Optional[PerQuery] = None,
    candidate_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two hops before dedup: (candidate tweet ids [B, Wr·Wl], 1.0 per
    valid entry [B, Wr·Wl], the sources' engaging users [B, Wr])."""
    src_rows = jax_rows(source_tweet_ids, right.user_ids.shape[0])
    users, u_ts = row_gather(src_rows, right.user_ids, right.timestamps)  # [B, Wr]
    u_valid = users != PAD_ID
    if min_timestamp is not None:
        u_valid &= u_ts >= _per_query(min_timestamp, 2)
    safe_u = jax_rows(torch.where(u_valid, users, 0), left.tweet_ids.shape[0])
    rows_t, rows_ts = row_gather(safe_u, left.tweet_ids, left.timestamps)  # [B, Wr, Wl]
    valid = (rows_t != PAD_ID) & u_valid[..., None]
    if min_timestamp is not None:
        valid &= rows_ts >= _per_query(min_timestamp, 3)
    valid &= rows_t != source_tweet_ids[:, None, None]  # don't return the source
    if candidate_mask is not None:
        safe_t = jax_rows(torch.where(valid, rows_t, 0), candidate_mask.shape[0])
        valid &= candidate_mask[safe_t]
    B = source_tweet_ids.shape[0]
    return torch.where(valid, rows_t, PAD_ID).reshape(B, -1), valid.float().reshape(B, -1), users


def related_tweets(
    left: EngagementGraph,  # user → tweets
    right: RightIndex,  # tweet → users
    source_tweet_ids: torch.Tensor,  # [B] int32
    *,
    max_results: int,
    min_cooccurrence: int = 1,
    min_timestamp: Optional[PerQuery] = None,
    candidate_mask: Optional[torch.Tensor] = None,  # [T] bool (UVG: is_video)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-hop co-engagement similarity (≡ UTG ``relatedTweets``) for B
    source tweets: what ``jax.vmap`` of the JAX function (its
    ``related_tweets_batch``) computes.

    score(c) = cooc(source, c) / √(deg(source)·deg(c)) — cosine over the
    binary engagement incidence; returns (tweet_ids, scores,
    cooccurrence_counts), each [B, min(max_results, Wr·Wl)].
    ``candidate_mask`` restricts candidates (UVG = UTG with a video-tweet
    mask). The JAX function sums the co-occurrence twice and drops one; here
    it is summed once, and deg(c) is read from one degree per right-index
    row instead of a gathered row per candidate: the same numbers.
    """
    flat, ones, users = cooccurrence_entries(
        left, right, source_tweet_ids, min_timestamp=min_timestamp, candidate_mask=candidate_mask)
    uniq, cooc = _dedup_sum(flat, ones)
    deg_src = torch.clamp(degree(users), min=1).float()  # [B]
    deg_all = degree(right.user_ids)  # [T]
    deg_cand = torch.clamp(deg_all[safe_rows(uniq, deg_all.shape[0])], min=1).float()
    score = cooc / torch.sqrt(deg_src[:, None] * deg_cand)
    return rank_deduped(uniq, score, cooc, max_results=max_results, min_proof=min_cooccurrence)


related_tweets_batch = related_tweets


# -- UUG ----------------------------------------------------------------------


class UserUserGraph(NamedTuple):
    """user → recently-engaged users (follows/favs/mentions of authors)."""

    user_ids: torch.Tensor  # [U, W] int32 PAD_ID padded
    interaction_type: torch.Tensor  # [U, W] int32
    timestamps: torch.Tensor  # [U, W] int32

    @classmethod
    def from_numpy(cls, user_ids, interaction_type, timestamps, device=None) -> "UserUserGraph":
        """The graph from the JAX package's arrays (as numpy), on ``device``
        (default: the card)."""
        return cls(*_tables_from_numpy((user_ids, interaction_type, timestamps), device, "UserUserGraph"))


def init_user_user(num_users: int, width: int = 64, device=None) -> UserUserGraph:
    """An empty graph on ``device`` (default: the card)."""
    dev = resolve(device, "UserUserGraph")
    return UserUserGraph(
        torch.full((num_users, width), PAD_ID, dtype=torch.int32, device=dev),
        torch.zeros((num_users, width), dtype=torch.int32, device=dev),
        torch.zeros((num_users, width), dtype=torch.int32, device=dev),
    )


def record_user_user(graph: UserUserGraph, src_users, dst_users, types, timestamps) -> UserUserGraph:
    return UserUserGraph(*ring_append(graph, src_users, (dst_users, types, timestamps)))


def recommend_users(
    graph: UserUserGraph,
    seed_ids: torch.Tensor,  # [R, S] each query user's circle
    seed_weights: torch.Tensor,  # [R, S]
    *,
    max_results: int,
    exclude_ids: Optional[torch.Tensor] = None,  # [R, E] or [E]: already-followed users
    min_social_proof: int = 1,
    min_timestamp: Optional[PerQuery] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """"Users my circle engaged" (≡ ``UserUserGraph`` query path) for R
    queries: score(u) = Σ_{seed s→u} weight(s), social proof = the seeds'
    interactions with u. Each [R, min(max_results, S·W)]."""
    valid_seed = seed_ids != PAD_ID
    rows_u, rows_ts = row_gather(
        safe_rows(seed_ids, graph.user_ids.shape[0]), graph.user_ids, graph.timestamps)  # [R, S, W]
    valid = (rows_u != PAD_ID) & valid_seed[..., None]
    if min_timestamp is not None:
        valid &= rows_ts >= _per_query(min_timestamp, 3)
    # never recommend the seeds themselves
    valid &= ~(rows_u[..., None] == seed_ids[:, None, None, :]).any(-1)
    R = seed_ids.shape[0]
    if exclude_ids is not None:
        exclude_ids = exclude_ids.expand(R, -1) if exclude_ids.dim() == 1 else exclude_ids
        valid &= ~(rows_u[..., None] == exclude_ids[:, None, None, :]).any(-1)
    w = torch.where(valid, seed_weights[..., None], 0.0)
    uniq, scores, proof = _dedup_sum(torch.where(valid, rows_u, PAD_ID).reshape(R, -1),
                                     w.reshape(R, -1), valid.float().reshape(R, -1))
    return rank_deduped(uniq, scores, proof, max_results=max_results, min_proof=min_social_proof)
