"""Port retrieval (the_algorithm_tpu_torch/ops/retrieval.py) against the JAX
package's batched scan and the numpy hashmap oracle.

Ids are compared as score-aligned sets and scores at rtol 1e-5: both scans
sum a tweet's contributions in f32 but in different orders (the dedup sorts
are not equally stable), so scores a few ulps apart may swap. Exactly equal
scores rank in ``lax.top_k``'s order on both sides, and a test with
dyadic scores holds the ids equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_same_collapse, assert_same_topk, collapse_to_dict

from the_algorithm_tpu.ops import retrieval as jr
from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding

C, M, N, X, Q = 64, 16, 8, 20, 4
ALGOS = list(ScoringAlgorithm)


def make_index(C=C, M=M, T=300, seed=0):
    """Random cluster→tweet index; a tweet appears in many rows, once per row."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(T, size=M, replace=False) for _ in range(C)]).astype(np.int32)
    scores = rng.uniform(0.1, 1.0, size=(C, M)).astype(np.float32)
    ts = rng.integers(100, 1000, size=(C, M)).astype(np.int32)
    ids[:, M - 2 :] = PAD_ID  # empty tail slots
    scores[:, M - 2 :] = 0
    order = np.argsort(-scores, axis=1, kind="stable")
    return tuple(np.take_along_axis(a, order, axis=1) for a in (ids, scores, ts))


def make_sources(Q=Q, N=N, C=C, seed=1):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(C, size=N, replace=False) for _ in range(Q)]).astype(np.int32)
    scores = rng.uniform(0.2, 1.0, size=(Q, N)).astype(np.float32)
    ids[0, -2:] = PAD_ID  # a query with empty slots
    scores[0, -2:] = 0
    return ids, scores


def _port(index_np, src_np, **kw):
    index = ClusterTweetIndex(*(torch.from_numpy(a) for a in index_np))
    src = SparseEmbedding(*(torch.from_numpy(a) for a in src_np))
    ids, scores = retrieval.approximate_cosine_similarity(index, src, **kw)
    return ids.numpy(), scores.numpy()


@functools.partial(jax.jit, static_argnames=("max_results", "algorithm", "cap"))
def _jax_batch(index, src, exclude, earliest, latest, *, max_results, algorithm, cap):
    def one(s, e):
        return jr.approximate_cosine_similarity(
            index, s, max_results=max_results, algorithm=algorithm,
            max_top_tweets_per_cluster=cap, exclude_tweet_id=e,
            earliest_ts=earliest, latest_ts=latest,
        )

    return jax.vmap(one)(src, exclude)


def _jax(index_np, src_np, *, exclude=None, earliest=0, latest=10**9, max_results=X,
         algorithm=ScoringAlgorithm.COSINE, cap=None):
    index = jr.ClusterTweetIndex(*(jnp.asarray(a) for a in index_np))
    src = js.SparseEmbedding(*(jnp.asarray(a) for a in src_np))
    if exclude is None:
        exclude = np.full(src_np[0].shape[0], -1, np.int32)
    ids, scores = _jax_batch(
        index, src, jnp.asarray(exclude), earliest, latest,
        max_results=max_results, algorithm=jr.ScoringAlgorithm(algorithm.value), cap=cap,
    )
    return np.asarray(ids), np.asarray(scores)


def _oracle(index_np, src_np, q, **kw):
    return retrieval.approximate_cosine_similarity_reference(*index_np, *(a[q] for a in src_np), **kw)


def _assert_matches_oracle(ids, scores, index_np, src_np, **kw):
    for q in range(ids.shape[0]):
        want = _oracle(index_np, src_np, q, max_results=ids.shape[1], **kw)
        want_ids = np.full(ids.shape[1], PAD_ID, np.int32)
        want_scores = np.full(ids.shape[1], -np.inf, np.float32)
        want_ids[: len(want)] = [t for t, _ in want]
        want_scores[: len(want)] = [s for _, s in want]
        assert_same_topk(ids[q : q + 1], scores[q : q + 1], want_ids[None], want_scores[None])


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_batch_scan_matches_jax_and_oracle(algo):
    index_np, src_np = make_index(), make_sources()
    got = _port(index_np, src_np, max_results=X, algorithm=algo)
    assert got[0].shape == (Q, X) and got[0].dtype == np.int32
    assert_same_topk(*got, *_jax(index_np, src_np, algorithm=algo))
    _assert_matches_oracle(*got, index_np, src_np, algorithm=algo)


def test_age_window_and_per_query_exclusion_match_jax_and_oracle():
    index_np, src_np = make_index(), make_sources()
    full_ids, _ = _port(index_np, src_np, max_results=X)
    exclude = full_ids[:, 0].copy()  # drop each query's best tweet
    got = _port(index_np, src_np, max_results=X, earliest_ts=300, latest_ts=800,
                exclude_tweet_id=torch.from_numpy(exclude))
    assert_same_topk(*got, *_jax(index_np, src_np, exclude=exclude, earliest=300, latest=800))
    assert not np.any(got[0] == exclude[:, None])
    for q in range(Q):
        want = [(t, s) for t, s in _oracle(index_np, src_np, q, max_results=10**6,
                                           earliest_ts=300, latest_ts=800)
                if t != exclude[q]][:X]
        assert_same_topk(
            got[0][q : q + 1], got[1][q : q + 1],
            np.array([[t for t, _ in want]], np.int32), np.array([[s for _, s in want]], np.float32),
        )


def test_row_cap_below_index_width_matches_jax():
    index_np, src_np = make_index(), make_sources()
    got = _port(index_np, src_np, max_results=X, max_top_tweets_per_cluster=6)
    assert_same_topk(*got, *_jax(index_np, src_np, cap=6))
    capped = tuple(a[:, :6] for a in index_np)
    _assert_matches_oracle(*got, capped, src_np)


def test_static_width_padding_when_the_scan_is_narrower_than_x():
    index_np = make_index()
    src_np = make_sources(N=2)
    got = _port(index_np, src_np, max_results=40)  # W = 2·16 = 32 < 40
    assert got[0].shape == (Q, 40)
    assert np.all(got[0][:, 32:] == PAD_ID) and np.all(np.isneginf(got[1][:, 32:]))
    assert_same_topk(*got, *_jax(index_np, src_np, max_results=40))


def _out_of_range_sources():
    """Sources whose valid slots hold ids outside [0, C): -1 (JAX's gather
    reads row C-1), C+3 (clamped to C-1) and -(C+2) (wrapped to -2, clamped
    to 0)."""
    ids, scores = make_sources()
    ids[1, :3] = [-1, C + 3, -(C + 2)]
    ids[2, 0] = -1
    ids[3, -1] = C + 3
    return ids, scores


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_out_of_range_cluster_ids_read_the_rows_jax_reads(algo):
    index_np, src_np = make_index(), _out_of_range_sources()
    got = _port(index_np, src_np, max_results=X, algorithm=algo)
    assert_same_topk(*got, *_jax(index_np, src_np, algorithm=algo))
    # the same as sources that name JAX's rows outright
    named = src_np[0].copy()
    named[1, :3] = [C - 1, C - 1, 0]
    named[2, 0] = C - 1
    named[3, -1] = C - 1
    assert_same_topk(*got, *_port(index_np, (named, src_np[1]), max_results=X, algorithm=algo))
    # the numpy oracle skips such ids instead; the port follows JAX, not it
    assert _oracle(index_np, src_np, 1, max_results=X, algorithm=algo) != _oracle(
        index_np, (named, src_np[1]), 1, max_results=X, algorithm=algo)


def test_out_of_range_cluster_ids_accumulate_as_jax_accumulates():
    index_np, src_np = make_index(), _out_of_range_sources()
    got = retrieval.accumulate_candidates(
        ClusterTweetIndex(*(torch.from_numpy(a) for a in index_np)),
        SparseEmbedding(*(torch.from_numpy(a) for a in src_np)))
    index = jr.ClusterTweetIndex(*(jnp.asarray(a) for a in index_np))
    want = jax.jit(jax.vmap(lambda s: jr.accumulate_candidates(index, s)))(
        js.SparseEmbedding(*(jnp.asarray(a) for a in src_np)))
    for q in range(Q):
        assert_same_collapse(
            collapse_to_dict(*(g[q].numpy() for g in got)),
            collapse_to_dict(*(np.asarray(w[q]) for w in want)),
        )


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_numpy_oracle_copy_equals_the_jax_original(algo):
    index_np, src_np = make_index(), make_sources()
    for q in range(Q):
        for window in ({}, {"earliest_ts": 250, "latest_ts": 900}):
            kw = dict(max_results=30, min_score=0.05, **window)
            got = _oracle(index_np, src_np, q, algorithm=algo, **kw)
            want = jr.approximate_cosine_similarity_reference(
                *index_np, *(a[q] for a in src_np), algorithm=jr.ScoringAlgorithm(algo.value), **kw
            )
            assert got == want


@pytest.mark.parametrize("max_results", [20, 80])
def test_exact_scan_matches_jax(max_results):
    rng = np.random.default_rng(5)
    T, K, block = 256, 6, 64
    corpus_ids = np.stack([rng.choice(C, size=K, replace=False) for _ in range(T)]).astype(np.int32)
    corpus_scores = rng.uniform(0.1, 1.0, size=(T, K)).astype(np.float32)
    corpus_ids[-10:] = PAD_ID  # padding rows
    corpus_scores[-10:] = 0
    corpus_ids[5, 3:] = PAD_ID
    src_np = make_sources()
    got_rows, got_scores = retrieval.exact_cosine_scan(
        torch.from_numpy(corpus_ids), torch.from_numpy(corpus_scores),
        SparseEmbedding(*(torch.from_numpy(a) for a in src_np)),
        num_clusters=C, max_results=max_results, block=block,
    )
    want_rows, want_scores = jr.exact_cosine_scan(
        jnp.asarray(corpus_ids), jnp.asarray(corpus_scores),
        js.SparseEmbedding(*(jnp.asarray(a) for a in src_np)),
        num_clusters=C, max_results=max_results, block=block,
    )
    assert got_rows.shape == (Q, max_results)
    want_rows = np.where(np.asarray(want_rows) < 0, PAD_ID, np.asarray(want_rows))
    got_rows = np.where(got_rows.numpy() < 0, PAD_ID, got_rows.numpy())
    assert_same_topk(got_rows, got_scores.numpy(), want_rows, np.asarray(want_scores))


def test_top_k_keeps_lax_top_k_order():
    rng = np.random.default_rng(6)
    floats = rng.integers(-3, 4, (5, 40)).astype(np.float32) * 0.5
    floats[0, ::3] = -np.inf
    floats[1] = rng.normal(size=40).astype(np.float32)  # negatives of every size
    ints = rng.integers(-2, 3, (4, 33)).astype(np.int32)
    ints[0, :5] = np.iinfo(np.int32).min  # the recency scan's sentinel
    ints[1, :5] = np.iinfo(np.int32).max
    for x in (floats, ints):
        for k in (1, 7, x.shape[1]):
            values, idx = retrieval.top_k(torch.from_numpy(x), k)
            want_values, want_idx = jax.lax.top_k(jnp.asarray(x), k)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
            np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))


def test_equal_scores_rank_as_jax_ranks_them():
    """Each tweet sits in one cluster row and every score is 0.5: all of a
    query's candidates tie, and X cuts inside the tie. The port keeps
    lax.top_k's order (lower dedup slot, i.e. lower tweet id, first)."""
    rng = np.random.default_rng(8)
    ids = rng.permutation(C * M).reshape(C, M).astype(np.int32)
    index_np = (ids, np.full((C, M), 0.5, np.float32), np.zeros((C, M), np.int32))
    src_ids, _ = make_sources()
    src_np = (src_ids, np.where(src_ids != PAD_ID, 0.5, 0.0).astype(np.float32))
    got = _port(index_np, src_np, max_results=X)
    want = _jax(index_np, src_np, max_results=X)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the exact scan's running merge keeps the same order: identical corpus rows
    corpus_ids = np.tile(np.arange(6, dtype=np.int32), (128, 1))
    corpus_scores = np.full((128, 6), 0.5, np.float32)
    src = SparseEmbedding(*(torch.from_numpy(a) for a in src_np))
    got = retrieval.exact_cosine_scan(torch.from_numpy(corpus_ids), torch.from_numpy(corpus_scores), src,
                                      num_clusters=C, max_results=X, block=32)
    want = jr.exact_cosine_scan(jnp.asarray(corpus_ids), jnp.asarray(corpus_scores),
                                js.SparseEmbedding(*(jnp.asarray(a) for a in src_np)), num_clusters=C,
                                max_results=X, block=32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("wide", [False, True], ids=["sorted rows", "top-k and tie repair"])
def test_top_k_on_tie_heavy_rows_keeps_lax_top_k_order(seed, wide):
    """Few distinct values: the k-th value is tied far beyond the cut, on
    1-D and batched rows, float and int, on both sides of SMALL_SORT."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300)) + (retrieval.SMALL_SORT if wide else 0)
    x = rng.integers(-2, 3, (3, n)).astype(np.float32)
    x[rng.random((3, n)) < 0.2] = -np.inf
    ints = np.where(np.isinf(x), np.iinfo(np.int32).min, x).astype(np.int32)  # the recency sentinel
    for a in (x, x[0], ints):
        for k in sorted({1, max(1, n // 3), n}):
            values, idx = retrieval.top_k(torch.from_numpy(np.ascontiguousarray(a)), k)
            want_values, want_idx = jax.lax.top_k(jnp.asarray(a), k)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
            np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))


def _exact_both(corpus_ids, corpus_scores, src_np, **kw):
    got = retrieval.exact_cosine_scan(torch.from_numpy(corpus_ids), torch.from_numpy(corpus_scores),
                                      SparseEmbedding(*(torch.from_numpy(a) for a in src_np)), **kw)
    want = jr.exact_cosine_scan(jnp.asarray(corpus_ids), jnp.asarray(corpus_scores),
                                js.SparseEmbedding(*(jnp.asarray(a) for a in src_np)), **kw)
    return tuple(g.numpy() for g in got), tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("where", ["sources", "corpus", "both"])
def test_exact_scan_out_of_range_cluster_ids_follow_jax(where):
    """Cluster ids -1, C+3 and -(C+2): the densifying scatter wraps a
    negative source id by +C and drops one still outside [0, C) (C+3, and
    -(C+2) wrapped to -2); the corpus gather reads the wrapped, clamped row."""
    rng = np.random.default_rng(9)
    T, K, block = 128, 6, 64
    corpus_ids = np.stack([rng.choice(C, size=K, replace=False) for _ in range(T)]).astype(np.int32)
    corpus_scores = rng.uniform(0.1, 1.0, size=(T, K)).astype(np.float32)
    src_ids, src_scores = make_sources()
    if where in ("sources", "both"):
        src_ids[0, :3] = [-1, C + 3, -(C + 2)]
        src_ids[2, 1] = -1
    if where in ("corpus", "both"):
        corpus_ids[3, :3] = [-1, C + 3, -(C + 2)]
        corpus_ids[70, 0] = -1
        corpus_ids[100, 5] = C + 3
    (got_rows, got_scores), (want_rows, want_scores) = _exact_both(
        corpus_ids, corpus_scores, (src_ids, src_scores), num_clusters=C, max_results=30, block=block)
    assert_same_topk(np.where(got_rows < 0, PAD_ID, got_rows), got_scores,
                     np.where(want_rows < 0, PAD_ID, want_rows), want_scores)
    # the same as ids that name JAX's rows outright (source C+3 and -(C+2) dropped)
    named_src = np.where(src_ids == -1, C - 1, src_ids)
    named_src_scores = np.where((named_src == C + 3) | (named_src == -(C + 2)), 0.0, src_scores).astype(np.float32)
    named_src = np.where((named_src == C + 3) | (named_src == -(C + 2)), 0, named_src).astype(np.int32)
    named_corpus = np.where(corpus_ids == -1, C - 1, corpus_ids)
    named_corpus = np.where(named_corpus == C + 3, C - 1, np.where(named_corpus == -(C + 2), 0, named_corpus))
    named = retrieval.exact_cosine_scan(
        torch.from_numpy(named_corpus.astype(np.int32)), torch.from_numpy(corpus_scores),
        SparseEmbedding(torch.from_numpy(named_src), torch.from_numpy(named_src_scores)),
        num_clusters=C, max_results=30, block=block)
    np.testing.assert_array_equal(got_rows, named[0].numpy())
    np.testing.assert_array_equal(got_scores, named[1].numpy())
