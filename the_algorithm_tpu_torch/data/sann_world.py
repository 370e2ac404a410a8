"""The seeded SimClusters world that ``bench.py`` measures retrieval on.

Numpy builders that reproduce ``bench.py``'s ``build_corpus``,
``build_index`` (``bench.py:98-138``) and its query draw
(``bench.py:822-831``) draw for draw, from the same seeds and in the same
order, so the port is measured on the very data the JAX package was. The
sizes are arguments; :data:`PROD` holds the bench's production shape.

:func:`build_index_job_world` adds the offline index job's inputs at those
widths (port-only): users' InterestedIn rows drawn as :func:`draw_queries`
draws queries, tweets each of a community, and user → tweet engagement
events, mostly within the user's community; :data:`INDEX_JOB` holds the
card's counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np

from the_algorithm_tpu_torch.ops.sparse import PAD_ID


@dataclasses.dataclass(frozen=True)
class WorldShape:
    n_comm: int  # communities; they partition the clusters
    cpc: int  # clusters per community
    M: int  # tweets per cluster row of the index
    N: int  # scan clusters per query
    X: int  # results per query
    T: int  # tweet corpus
    KT: int  # clusters per tweet embedding
    Q: int  # query batch
    n_pool: int = 256  # distinct KT-subsets per community

    @property
    def C(self) -> int:
        return self.n_comm * self.cpc


# bench.py:57-66 — C = 145,408 clusters, M=400, N=50, X=200, T=2M, KT=32, Q=256
PROD = WorldShape(n_comm=512, cpc=284, M=400, N=50, X=200, T=2_000_000, KT=32, Q=256)


def build_corpus(shape: WorldShape, seed: int = 0):
    """Sparse tweet embeddings clustered into communities.

    Returns (ids [T, KT] int32, scores [T, KT] f32, tweet_comm [T],
    comm_clusters [n_comm, cpc] int32).
    """
    s = shape
    rng = np.random.default_rng(seed)
    comm_clusters = rng.permutation(s.C).reshape(s.n_comm, s.cpc).astype(np.int32)
    keys = np.argsort(rng.random((s.n_comm, s.n_pool, s.cpc)), axis=-1)[..., : s.KT]
    pools = np.take_along_axis(
        np.broadcast_to(comm_clusters[:, None, :], (s.n_comm, s.n_pool, s.cpc)),
        keys, axis=-1,
    )  # [n_comm, n_pool, KT]
    tweet_comm = rng.integers(0, s.n_comm, s.T)
    pick = rng.integers(0, s.n_pool, s.T)
    ids = pools[tweet_comm, pick]  # [T, KT] distinct per tweet
    scores = rng.uniform(0.1, 1.0, size=(s.T, s.KT)).astype(np.float32)
    return ids.astype(np.int32), scores, tweet_comm, comm_clusters


def build_index(shape: WorldShape, tweet_ids: np.ndarray, tweet_scores: np.ndarray):
    """cluster → top-M rows from the tweet table: (ids, scores, ts), each [C, M]."""
    s = shape
    flat_c = tweet_ids.reshape(-1)
    flat_s = tweet_scores.reshape(-1)
    flat_t = np.repeat(np.arange(s.T, dtype=np.int32), s.KT)
    order = np.lexsort((-flat_s, flat_c))
    fc, fs, ft = flat_c[order], flat_s[order], flat_t[order]
    idx_ids = np.full((s.C, s.M), PAD_ID, np.int32)
    idx_scores = np.zeros((s.C, s.M), np.float32)
    start = np.searchsorted(fc, np.arange(s.C))
    rank = np.arange(fc.shape[0], dtype=np.int64) - start[fc]
    keep = rank < s.M
    idx_ids[fc[keep], rank[keep]] = ft[keep]
    idx_scores[fc[keep], rank[keep]] = fs[keep]
    ts = np.zeros((s.C, s.M), np.int32)
    return idx_ids, idx_scores, ts


def draw_queries(
    shape: WorldShape, comm_clusters: np.ndarray, seed: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Community-flavored user embeddings: (ids [Q, N] int32, scores [Q, N] f32)."""
    s = shape
    rng = np.random.default_rng(seed)
    q_comm = rng.integers(0, comm_clusters.shape[0], s.Q)
    q_ids = np.empty((s.Q, s.N), np.int64)
    for q in range(s.Q):
        q_ids[q] = rng.choice(comm_clusters[q_comm[q]], s.N, replace=False)
    q_scores = rng.uniform(0.2, 1.0, (s.Q, s.N)).astype(np.float32)
    return q_ids.astype(np.int32), q_scores


def padded_corpus(tweet_ids: np.ndarray, tweet_scores: np.ndarray, block: int):
    """The corpus padded with PAD rows to a multiple of ``block`` (the exact
    scan's layout, ``bench.py:152-157``)."""
    T, KT = tweet_ids.shape
    T_pad = -(-T // block) * block
    ti = np.full((T_pad, KT), PAD_ID, np.int32)
    tsc = np.zeros((T_pad, KT), np.float32)
    ti[:T] = tweet_ids
    tsc[:T] = tweet_scores
    return ti, tsc


@dataclasses.dataclass(frozen=True)
class IndexJobShape:
    """The index job's world: :data:`PROD`'s clusters and communities, cut
    counts of users, tweets and events."""

    sann: WorldShape = PROD  # C = 145,408 clusters in 512 communities
    users: int = 1 << 16
    tweets: int = 1 << 20
    events: int = 1 << 19
    K: int = 50  # InterestedIn clusters a user: a query's N
    in_community: float = 0.9  # the share of a user's events on its community's tweets
    window_s: int = 2 * 86400  # events' ages lie in [0, window_s)
    type_mix: Tuple[float, ...] = (0.6, 0.15, 0.1, 0.1, 0.05)  # fav, retweet, reply, video view, push open


INDEX_JOB = IndexJobShape()


class IndexJobWorld(NamedTuple):
    ii_ids: np.ndarray  # [U, K] int32 users' InterestedIn clusters, all of one community
    ii_scores: np.ndarray  # [U, K] float32
    user_comm: np.ndarray  # [U] the users' communities
    tweet_comm: np.ndarray  # [T] the tweets' communities
    user_rows: np.ndarray  # [E] int32 the engaging user
    tweet_ids: np.ndarray  # [E] int32 the engaged tweet
    event_type: np.ndarray  # [E] int32 into the job's event weights
    timestamps: np.ndarray  # [E] int32 seconds
    now: int


def build_index_job_world(shape: IndexJobShape = INDEX_JOB, seed: int = 17) -> IndexJobWorld:
    """The index job's inputs from ``seed``, with numpy. The communities'
    clusters are :func:`build_corpus`'s first draw (seed 0)."""
    s = shape.sann
    comm_clusters = np.random.default_rng(0).permutation(s.C).reshape(s.n_comm, s.cpc).astype(np.int32)
    ii_ids, ii_scores = draw_queries(dataclasses.replace(s, Q=shape.users, N=shape.K), comm_clusters, seed)
    comm_of = np.empty(s.C, np.int64)
    comm_of[comm_clusters] = np.arange(s.n_comm)[:, None]
    user_comm = comm_of[ii_ids[:, 0]]
    rng = np.random.default_rng(seed + 1)
    tweet_comm = rng.integers(0, s.n_comm, shape.tweets)
    user_rows = rng.integers(0, shape.users, shape.events)
    ucomm = user_comm[user_rows]
    by_comm = np.argsort(tweet_comm, kind="stable")
    counts = np.bincount(tweet_comm, minlength=s.n_comm)
    start = np.cumsum(counts) - counts
    own = by_comm[start[ucomm] + np.minimum((rng.random(shape.events) * counts[ucomm]).astype(np.int64),
                                            np.maximum(counts[ucomm] - 1, 0))]
    tweet_ids = np.where(rng.random(shape.events) < shape.in_community, own,
                         rng.integers(0, shape.tweets, shape.events))
    event_type = rng.choice(len(shape.type_mix), shape.events, p=shape.type_mix)
    timestamps = rng.integers(0, shape.window_s, shape.events)
    return IndexJobWorld(ii_ids, ii_scores, user_comm, tweet_comm, user_rows.astype(np.int32),
                         tweet_ids.astype(np.int32), event_type.astype(np.int32), timestamps.astype(np.int32),
                         shape.window_s)
