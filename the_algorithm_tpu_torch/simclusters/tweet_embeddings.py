"""Realtime tweet SimClusters embeddings + cluster→tweet index build.

Counterpart of ``the_algorithm_tpu/simclusters/tweet_embeddings.py`` (the
Summingbird/Storm ``TweetJob.scala:33-110``): on each fav event the faver's
InterestedIn vector is added into the tweet's embedding under an
8-hour-half-life decay (``ThriftDecayedValueMonoid.scala``), keeping
tweet→top-400-clusters, and the cluster→top-1600-tweets index is rebuilt
from that table. Constants from ``summingbird/common/Configs.scala:36-69``;
filters: no self-favs, tweet age < 3 days (``TweetJob.scala:53-58``).

The JAX package folds events with a ``lax.scan``, one event per step.
:func:`apply_fav_events` applies them in rounds instead: an event's round is
its occurrence rank among the batch's events on the same tweet, so a round
touches each tweet at most once and runs vectorised over its tweets, and
the events on one tweet still compose in stream order (decay, then
``sparse.add`` with truncation). The rounds number the largest multiplicity
of a tweet in the batch. :func:`build_cluster_index` sorts on (cluster
ascending, score descending) with one stable sort of a combined int64 key,
equal to JAX's ``lax.sort(num_keys=2)``, which on the CPU keeps tied
entries in input order (``tests/test_torch_tweet_embeddings.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops import sparse
from the_algorithm_tpu_torch.ops.gather import jax_rows
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding

SECONDS_PER_HOUR = 3600


@dataclasses.dataclass(frozen=True)
class TweetEmbeddingConfig:
    """≡ ``summingbird/common/Configs.scala:36-69`` defaults (prod values)."""

    clusters_per_tweet: int = 400  # topKClustersPerTweet
    tweets_per_cluster: int = 1600  # topKTweetsPerCluster
    half_life_s: int = 8 * SECONDS_PER_HOUR  # HalfLife = 8.hours
    min_favorite_count: int = 8  # MinFavoriteCount
    max_tweet_age_s: int = 3 * 24 * SECONDS_PER_HOUR  # age < 3 days
    clusters_per_user_contribution: int = 25  # faver's top clusters used


class TweetEmbeddingState(NamedTuple):
    """Sparse tweet→cluster table with per-tweet decay timestamps."""

    cluster_ids: torch.Tensor  # [T, Kt] int32, PAD_ID padded
    scores: torch.Tensor  # [T, Kt] f32, valid at time last_ts[t]
    last_ts: torch.Tensor  # [T] int32 — last decay reference time
    fav_count: torch.Tensor  # [T] int32
    created_ts: torch.Tensor  # [T] int32
    author: torch.Tensor  # [T] int32 — for the self-fav filter


def init_state(num_tweets: int, clusters_per_tweet: int, created_ts, author, device=None) -> TweetEmbeddingState:
    """An empty table of ``num_tweets`` rows on ``device`` (default: the card)."""
    dev = resolve(device, "TweetEmbeddingState")
    T, Kt = num_tweets, clusters_per_tweet
    created = torch.as_tensor(np.asarray(created_ts), dtype=torch.int32).to(dev)
    return TweetEmbeddingState(
        cluster_ids=torch.full((T, Kt), PAD_ID, dtype=torch.int32, device=dev),
        scores=torch.zeros((T, Kt), dtype=torch.float32, device=dev),
        last_ts=created.clone(),
        fav_count=torch.zeros((T,), dtype=torch.int32, device=dev),
        created_ts=created,
        author=torch.as_tensor(np.asarray(author), dtype=torch.int32).to(dev),
    )


def _decay_factor(dt_s: torch.Tensor, half_life_s: float) -> torch.Tensor:
    return torch.exp2(-torch.clamp(dt_s, min=0).float() / half_life_s)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fold_rounds(keys: np.ndarray) -> tuple:
    """Events grouped into rounds by their occurrence rank per key, stream
    order kept: (event order [E] by (rank, position), first slot of each
    round [rounds + 1])."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    start = np.r_[True, sorted_keys[1:] != sorted_keys[:-1]] if len(keys) else np.zeros(0, bool)
    pos = np.arange(len(keys))
    rank = np.empty(len(keys), np.int64)
    rank[order] = pos - np.maximum.accumulate(np.where(start, pos, 0))
    by_round = np.argsort(rank, kind="stable")
    return by_round, np.searchsorted(rank[by_round], np.arange(int(rank.max(initial=-1)) + 2))


def apply_fav_events(
    state: TweetEmbeddingState,
    user_interests: SparseEmbedding,  # [U, K] per-user InterestedIn table
    user_ids,  # [B] int, numpy or tensor
    tweet_ids,  # [B] int
    timestamps,  # [B] int32, non-decreasing (stream order)
    config: TweetEmbeddingConfig,
) -> TweetEmbeddingState:
    """Fold a batch of fav events into a copy of the tweet table
    (``TweetJob.generate``): each event decays its tweet's row to the event
    time and merge-adds the faver's top clusters, in stream order per tweet.

    Ids outside the tables read :func:`jax_rows`' row, as JAX's gathers do;
    a tweet id outside [0, T) after wrapping writes nothing (JAX's scatter
    drops it). The event plan (rounds) is made on the host from the ids.
    """
    dev = state.cluster_ids.device
    T, Kt = state.cluster_ids.shape
    U = user_interests.ids.shape[0]
    Kc = min(config.clusters_per_user_contribution, user_interests.capacity)
    u_raw, t_raw, ts_h = (_host(a).astype(np.int64) for a in (user_ids, tweet_ids, timestamps))
    t_read = np.clip(np.where(t_raw < 0, t_raw + T, t_raw), 0, T - 1)
    in_range = (t_raw >= -T) & (t_raw < T)
    order, offsets = _fold_rounds(t_read)
    # one upload: (raw user, read user, read tweet, writes, timestamp) per event, in round order
    u_read = np.clip(np.where(u_raw < 0, u_raw + U, u_raw), 0, U - 1)
    ev = torch.from_numpy(np.stack([u_raw, u_read, t_read, in_range, ts_h])[:, order]).to(dev)
    contrib_ids = user_interests.ids[:, :Kc]
    contrib_scores = user_interests.scores[:, :Kc]
    ids, scores = state.cluster_ids.clone(), state.scores.clone()
    last_ts, fav_count = state.last_ts.clone(), state.fav_count.clone()
    for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist()):
        uq, ur, t, writes, ts = ev[:, a:b]
        ts = ts.to(torch.int32)
        # filters (TweetJob.scala:53-58): no self-fav, age < 3 days
        do_apply = ((ts - state.created_ts[t]) < config.max_tweet_age_s) & (state.author[t] != uq)
        do_apply &= writes.bool()
        old = SparseEmbedding(ids[t], scores[t])
        decayed = sparse.scale(old, _decay_factor(ts - last_ts[t], config.half_life_s)[:, None])
        merged = sparse.add(decayed, SparseEmbedding(contrib_ids[ur], contrib_scores[ur]), Kt)
        ids[t] = torch.where(do_apply[:, None], merged.ids, old.ids)
        scores[t] = torch.where(do_apply[:, None], merged.scores, old.scores)
        last_ts[t] = torch.where(do_apply, ts, last_ts[t])
        fav_count[t] += do_apply.to(torch.int32)
    return state._replace(cluster_ids=ids, scores=scores, last_ts=last_ts, fav_count=fav_count)


def tweet_embedding_at(state: TweetEmbeddingState, tweet_id, now, half_life_s: float) -> SparseEmbedding:
    """Read one tweet's embedding decayed to ``now`` (read-time decay)."""
    t = jax_rows(torch.as_tensor(tweet_id, device=state.last_ts.device), state.last_ts.shape[0])
    decay = _decay_factor(now - state.last_ts[t], half_life_s)
    return SparseEmbedding(state.cluster_ids[t], state.scores[t] * decay[..., None])


def build_cluster_index(
    state: TweetEmbeddingState,
    num_clusters: int,
    config: TweetEmbeddingConfig,
    now,
) -> ClusterTweetIndex:
    """Build cluster→top-M tweets from the tweet table in one sorted pass.

    ≡ the ClusterTopKTweetsNode maintained by the streaming job
    (``TweetJob.scala:84-99``). Flatten all (cluster, tweet, score) entries,
    decay to ``now``, drop tweets with < MinFavoriteCount favs, sort by
    (cluster asc, score desc; equal pairs in input order), rank each entry
    within its cluster run, and place ranks < M into the [C, M] index.
    """
    T, Kt = state.cluster_ids.shape
    M, C = config.tweets_per_cluster, num_clusters
    dev = state.cluster_ids.device

    decay = _decay_factor(now - state.last_ts, config.half_life_s)  # [T]
    eligible = state.fav_count >= config.min_favorite_count  # [T]
    scores = state.scores * decay[:, None]
    valid = (state.cluster_ids != PAD_ID) & eligible[:, None] & (scores > 0)

    flat_c = torch.where(valid, state.cluster_ids, C).reshape(-1).to(torch.int64)
    flat_s = torch.where(valid, scores, 0.0).reshape(-1)
    # one stable sort of (cluster · 2³² + the score's descending image): the
    # scores kept are positive floats, whose bits order as integers
    key = flat_c * (1 << 32) + (0x7FFFFFFF - flat_s.view(torch.int32).to(torch.int64))
    key, perm = torch.sort(key, stable=True)
    c_sorted = key >> 32
    s_sorted = flat_s[perm]
    t_sorted = (perm // Kt).to(torch.int32)
    rank = torch.arange(key.shape[0], device=dev) - torch.searchsorted(c_sorted, c_sorted)
    ok = (c_sorted < C) & (rank < M) & (s_sorted > 0)
    # rejected entries all land in one spare slot past the index
    slot = torch.where(ok, c_sorted * M + rank, C * M)

    def place(fill, values):
        out = torch.full((C * M + 1,), fill, dtype=values.dtype, device=dev)
        out[slot] = values
        return out[:-1].reshape(C, M)

    return ClusterTweetIndex(place(PAD_ID, t_sorted), place(0.0, s_sorted),
                             place(0, state.created_ts[t_sorted.long()]))
