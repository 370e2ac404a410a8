"""Offline cluster→tweet index generation from engagement event logs.

Counterpart of ``the_algorithm_tpu/simclusters/index_generation.py`` (the
scio/BigQuery jobs ``simclusters_index_generation/
EngagementEventBasedClusterToTweetIndexGenerationJob.scala`` and its
video-view variant): read a window of engagement events, join each with the
engaging user's InterestedIn embedding, weight by event type and time decay,
sum per (tweet, cluster), keep each tweet's top clusters, and emit the
cluster → top-M tweets index the SANN scan serves.

The job on the device:

1. the join: one ``row_gather`` launch reads both InterestedIn tables at the
   events' users (K·4-byte rows);
2. the sum by key: the composite key ``tweet · C + cluster`` in true int64,
   one stable sort, dense int32 run indices (``cumsum(is_start) − 1``,
   sorted already) and one ``run_collapse_sorted`` launch over the
   [1, E·K] row, each run's total summed directly;
3. the two truncations (top-Kt clusters a tweet, top-M tweets a cluster):
   each one stable sort of an int64 key, the group above an order-preserving
   32-bit image of the score, descending. Equal scores keep the lower
   (tweet, cluster) key first, and −0.0 ranks equal to +0.0, as ``lax.sort``
   of ``(group, −score)`` orders them.

Where the JAX job goes wrong (ROADMAP §3, fault 11): its int64 key is int32
(``jax_enable_x64`` is off), so the keys wrap once T·C ≥ 2³¹ (its index
comes back empty at bench.py's C past ~14,768 tweets); and it takes each
run's total as a difference of two f32 prefix sums, whose rounding grows with
the prefix. The port's keys are int64 and its run sums are f32 sums of the
run's own terms.

Tweet ids outside [0, T) are dropped (JAX drops those at or past T).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.seg_scan import run_collapse_sorted
from the_algorithm_tpu_torch.ops.segment import ranked, run_rank
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


@dataclasses.dataclass(frozen=True)
class IndexGenerationConfig:
    """≡ the job's config knobs (event weights from the BQ SQL templates)."""

    num_clusters: int
    num_tweets: int
    clusters_per_tweet: int = 20  # tweet-embedding truncation
    tweets_per_cluster: int = 400  # index row width (prod M=400)
    half_life_s: float = 8 * 3600.0
    min_engagements: int = 1  # ≡ minFavoriteCount gate for the batch job
    # per-event-type weights (fav, retweet, reply, video_view, push_open …)
    event_weights: tuple = (1.0, 1.0, 1.0, 0.5, 0.5)


class EventLog(NamedTuple):
    """A window of engagement events, [E] each."""

    user_rows: torch.Tensor  # int32 row into the InterestedIn table
    tweet_ids: torch.Tensor  # int32 dense tweet ids < num_tweets
    event_type: torch.Tensor  # int32 index into event_weights
    timestamps: torch.Tensor  # int32 seconds

    def to(self, device) -> "EventLog":
        return EventLog(*(t.to(device) for t in self))


def _sum_by_key(key: torch.Tensor, contrib: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sorted keys, each run's total at its last slot, 0 elsewhere, is_end)
    of [n] int64 keys and f32 values: one stable sort and one run collapse
    over the dense int32 run indices."""
    key_s, order = torch.sort(key, stable=True)
    val_s = contrib[order]
    is_start = torch.ones_like(key_s, dtype=torch.bool)
    is_start[1:] = key_s[1:] != key_s[:-1]
    run_idx = torch.cumsum(is_start, dim=0, dtype=torch.int32) - 1
    rep, total = run_collapse_sorted(run_idx[None].contiguous(), val_s[None].contiguous())
    return key_s, total[0], rep[0] != PAD_ID


def generate_cluster_to_tweet_index(
    events: EventLog,
    interested_in_ids: torch.Tensor,  # [U, K] int32 users' InterestedIn clusters
    interested_in_scores: torch.Tensor,  # [U, K] float32
    config: IndexGenerationConfig,
    now,
) -> ClusterTweetIndex:
    """The batch job on the tables' device → a [C, M] index (PAD_ID / 0 in
    empty slots, timestamps 0). Raises before building anything when E·K
    slots do not fit int32 run indices."""
    C, T, M = config.num_clusters, config.num_tweets, config.tweets_per_cluster
    U, K = interested_in_ids.shape
    E = events.user_rows.shape[0]
    if E * K >= 2**31:
        raise ValueError(f"{E} events x {K} clusters = {E * K} slots: the run indices are int32")
    dev = interested_in_ids.device
    ev = events.to(dev)

    # 1. the join: every event expands to its user's K (cluster, score) entries
    u_ids, u_scores = row_gather(jax_rows(ev.user_rows, U).to(torch.int32),
                                 interested_in_ids.to(torch.int32).contiguous(),
                                 interested_in_scores.to(torch.float32).contiguous())
    age = torch.clamp(now - ev.timestamps, min=0).to(torch.float32)
    decay = torch.exp2(-age / config.half_life_s)
    w_table = torch.tensor(config.event_weights, dtype=torch.float32, device=dev)
    w = (w_table[jax_rows(ev.event_type, len(config.event_weights))] * decay)[:, None]
    inside = (ev.tweet_ids >= 0) & (ev.tweet_ids < T)
    valid = (u_ids != PAD_ID) & inside[:, None]
    contrib = torch.where(valid, u_scores * w, 0.0)

    # 2. the sum by (tweet, cluster): int64 keys, one sort, one run collapse
    pad_key = T * C
    key = torch.where(valid, ev.tweet_ids.to(torch.int64)[:, None] * C + u_ids.to(torch.int64), pad_key)
    key_s, run_sum, is_end = _sum_by_key(key.reshape(-1), contrib.reshape(-1))
    run_tweet = torch.div(key_s, C, rounding_mode="floor")
    run_cluster = key_s - run_tweet * C

    # 3. the engagement gate (≡ minFavoriteCount) counts events, not slots:
    # an integer count, exact in any order
    tweet_eng = torch.zeros(T + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(inside, ev.tweet_ids, T).to(torch.int64), torch.ones(E, dtype=torch.int32, device=dev))
    gated = is_end & (key_s < pad_key) & (tweet_eng[run_tweet.clamp(0, T - 1)] >= config.min_engagements)

    # 4. top-Kt clusters a tweet: sort by (tweet, score desc)
    p1 = ranked(torch.where(gated, run_tweet, T), run_sum)
    st, sc, ssum = torch.where(gated, run_tweet, T)[p1], run_cluster[p1], run_sum[p1]
    keep = (st < T) & (run_rank(st) < config.clusters_per_tweet) & (ssum > 0)

    # 5. the cluster → top-M index: sort the kept entries by (cluster, score desc)
    p2 = ranked(torch.where(keep, sc, C), ssum)
    cc, ct, cs = torch.where(keep, sc, C)[p2], st[p2], ssum[p2]
    rank_c = run_rank(cc)
    ok = (cc < C) & (rank_c < M) & (cs > 0)
    slot = torch.where(ok, cc * M + rank_c, C * M)  # a spare slot takes the rest
    tweet_ids = torch.full((C * M + 1,), PAD_ID, dtype=torch.int32, device=dev)
    scores = torch.zeros(C * M + 1, dtype=torch.float32, device=dev)
    tweet_ids.index_put_((slot,), ct.to(torch.int32))
    scores.index_put_((slot,), cs)
    return ClusterTweetIndex(tweet_ids[:-1].view(C, M), scores[:-1].view(C, M),
                             torch.zeros((C, M), dtype=torch.int32, device=dev))


def sums_by_key_float64(events: EventLog, interested_in_ids, interested_in_scores, config: IndexGenerationConfig,
                        now: int, device="cpu") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The per-(tweet, cluster) sums in float64: (sorted int64 keys
    ``tweet · C + cluster``, their sums, the engagement count of each key's
    tweet). The weights and decays are float64 as in
    :func:`generate_cluster_to_tweet_index_reference`; the keys sort on
    ``device``, and each key's terms are summed in numpy, in slot order."""
    C, T = config.num_clusters, config.num_tweets
    u = host_array(events.user_rows).astype(np.int64)
    t = host_array(events.tweet_ids).astype(np.int64)
    ty = host_array(events.event_type).astype(np.int64)
    ts = host_array(events.timestamps).astype(np.int64)
    ids, sc = host_array(interested_in_ids), host_array(interested_in_scores).astype(np.float64)
    w = np.asarray(config.event_weights, np.float64)[ty] * 2.0 ** (-np.maximum(now - ts, 0) / config.half_life_s)
    inside = (t >= 0) & (t < T)
    valid = (ids[u] != PAD_ID) & inside[:, None]
    keys = (t[:, None] * C + ids[u].astype(np.int64))[valid]
    vals = (sc[u] * w[:, None])[valid]
    if not len(keys):
        return keys, vals, keys
    key_s, order = torch.sort(torch.from_numpy(keys).to(device), stable=True)
    key_s, order = host_array(key_s), host_array(order)
    start = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
    eng = np.bincount(t[inside], minlength=T)
    return key_s[start], np.add.reduceat(vals[order], start), eng[key_s[start] // C]


def _np_run_rank(group: np.ndarray) -> np.ndarray:
    """Rank within runs of equal values of a sorted array."""
    idx = np.arange(group.shape[0])
    start = np.ones(group.shape[0], bool)
    start[1:] = group[1:] != group[:-1]
    return idx - np.maximum.accumulate(np.where(start, idx, 0))


def _boundaries(group: np.ndarray, score: np.ndarray, rank: np.ndarray, cut: int, size: int):
    """For each group id in [0, size): the score at rank ``cut - 1`` (the last
    kept) and at ``cut`` (the first dropped), NaN where there is none."""
    last, first_out = np.full(size, np.nan), np.full(size, np.nan)
    last[group[rank == cut - 1]] = score[rank == cut - 1]
    first_out[group[rank == cut]] = score[rank == cut]
    return last, first_out


def _near(score: np.ndarray, last: np.ndarray, first_out: np.ndarray, rtol: float) -> np.ndarray:
    """Whether a score may fall on either side of a cut whose last kept and
    first dropped scores lie within 2·rtol of each other."""
    tied = np.abs(last - first_out) <= 2 * rtol * np.abs(last)
    return tied & (np.minimum(np.abs(score - last), np.abs(score - first_out)) <= 2 * rtol * np.abs(score))


def _stable_order(*keys: np.ndarray, device="cpu") -> np.ndarray:
    """``np.lexsort(keys)`` (the last key primary) as stable torch sorts on
    ``device``, one a key from the least significant."""
    order = torch.arange(keys[0].shape[0], device=device)
    for k in keys:
        order = order[torch.sort(torch.from_numpy(k).to(device)[order], stable=True).indices]
    return host_array(order)


def _searchsorted(sorted_keys: np.ndarray, keys: np.ndarray, device="cpu") -> np.ndarray:
    """``np.searchsorted`` on ``device``, clipped into range."""
    if not len(sorted_keys):
        return np.zeros(keys.shape, np.int64)
    pos = torch.searchsorted(torch.from_numpy(sorted_keys).to(device), torch.from_numpy(keys).to(device))
    return host_array(pos.clamp_(0, len(sorted_keys) - 1))


def _setxor(a: np.ndarray, b: np.ndarray, device="cpu") -> np.ndarray:
    """``np.setxor1d`` of two arrays of distinct keys, sorted on ``device``."""
    both = torch.sort(torch.from_numpy(np.concatenate([a, b])).to(device)).values
    _, counts = torch.unique_consecutive(both, return_counts=True)
    keys = torch.unique_consecutive(both)
    return host_array(keys[counts == 1])


def compare_with_float64(index: ClusterTweetIndex, events: EventLog, interested_in_ids, interested_in_scores,
                         config: IndexGenerationConfig, now: int, rtol: float = 1e-5, device="cpu") -> dict:
    """Hold an index to the job run in float64 (vectorized numpy): the
    float64 sum of each (tweet, cluster), the top-Kt cut of each tweet and
    the top-M cut of each cluster, ties by (tweet, cluster) key. Returns
    counts the caller bounds: ``entries``; ``unknown`` (entries whose key
    no event made); ``max_rel_err`` of the scores against their sums;
    ``near_tie`` and ``far`` entries kept on one side only (near: within
    2·rtol of a cut whose two sides lie that close); ``out_of_order``
    neighbours in a row whose sums rise by more than 2·rtol. The sums run in
    numpy; the float64 sorts and searches on ``device``."""
    C, T, M, Kt = config.num_clusters, config.num_tweets, config.tweets_per_cluster, config.clusters_per_tweet
    keys, sums, eng = sums_by_key_float64(events, interested_in_ids, interested_in_scores, config, now, device)
    gated = (eng >= config.min_engagements) & (sums > 0)
    k, s = keys[gated], sums[gated]  # ascending keys: (tweet, cluster) order
    t, c = k // C, k % C
    o = _stable_order(-s, t, device=device)  # each tweet's clusters by score, then key
    rank_t = np.empty_like(o)
    rank_t[o] = _np_run_rank(t[o])
    t_last, t_out = _boundaries(t[o], s[o], rank_t[o], Kt, T)
    near = _near(s, t_last[t], t_out[t], rtol)
    kept = np.flatnonzero(rank_t < Kt)
    o2 = kept[_stable_order(-s[kept], c[kept], device=device)]  # each cluster's tweets by score, then tweet
    rank_c = _np_run_rank(c[o2])
    c_last, c_out = _boundaries(c[o2], s[o2], rank_c, M, C)
    near[o2] |= _near(s[o2], c_last[c[o2]], c_out[c[o2]], rtol)
    want = np.sort(k[o2[rank_c < M]])

    ids, got_s = host_array(index.tweet_ids).reshape(-1), host_array(index.scores).reshape(-1)
    slot = np.flatnonzero(ids != PAD_ID)  # a row's entries fill its first slots
    got_k = ids[slot].astype(np.int64) * C + slot // M
    pos = _searchsorted(k, got_k, device)
    known = (k[pos] == got_k) if len(k) else np.zeros(got_k.shape, bool)
    s64 = np.where(known, s[pos] if len(k) else 0.0, np.nan)
    apart = _setxor(want, got_k, device)
    at = _searchsorted(k, apart, device)
    tie = (k[at] == apart) & near[at] if len(k) else np.zeros(apart.shape, bool)
    nxt = (slot[1:] == slot[:-1] + 1) & (slot[1:] // M == slot[:-1] // M)  # neighbours in a row
    rises = nxt & (s64[1:] > s64[:-1] * (1 + 2 * rtol))
    err = np.abs(got_s[slot] - s64) / np.abs(s64)
    return {"entries": int(slot.shape[0]), "unknown": int((~known).sum()),
            "max_rel_err": float(np.nanmax(err)) if known.any() else 0.0,
            "near_tie": int(tie.sum()), "far": int((~tie).sum()), "out_of_order": int(rises.sum())}


def generate_cluster_to_tweet_index_reference(
    events: EventLog,
    interested_in_ids,
    interested_in_scores,
    config: IndexGenerationConfig,
    now: int,
):
    """Literal dict-of-dicts oracle (the BQ SQL semantics) for parity tests.

    A copy of the JAX package's oracle, so that a machine without JAX can
    hold the port against it; a test asserts that both give the same index.
    """
    u_ids = host_array(interested_in_ids)
    u_sc = host_array(interested_in_scores)
    users, tweets = host_array(events.user_rows), host_array(events.tweet_ids)
    types, stamps = host_array(events.event_type), host_array(events.timestamps)
    acc: dict = {}
    eng: dict = {}
    for e in range(len(users)):
        u = int(users[e])
        t = int(tweets[e])
        ty = int(types[e])
        ts = int(stamps[e])
        w = config.event_weights[ty] * 2.0 ** (-max(now - ts, 0) / config.half_life_s)
        eng[t] = eng.get(t, 0) + 1
        for k in range(u_ids.shape[1]):
            c = int(u_ids[u, k])
            if c == int(PAD_ID):
                continue
            acc.setdefault(t, {})
            acc[t][c] = acc[t].get(c, 0.0) + float(u_sc[u, k]) * w
    index: dict = {}
    for t, clusters in acc.items():
        if eng.get(t, 0) < config.min_engagements:
            continue
        top = sorted(clusters.items(), key=lambda kv: -kv[1])[: config.clusters_per_tweet]
        for c, s in top:
            if s > 0:
                index.setdefault(c, []).append((t, s))
    for c in index:
        index[c] = sorted(index[c], key=lambda p: -p[1])[: config.tweets_per_cluster]
    return index
