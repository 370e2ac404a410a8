"""The port's realtime tweet embeddings
(the_algorithm_tpu_torch/simclusters/tweet_embeddings.py) against the JAX
package's, on the same seeded numpy events and tables.

Tolerances: cluster ids, fav counts and timestamps are compared exactly.
Scores at rtol 1e-6: each event decays a row with exp2 (torch's and XLA's
may differ by an ulp) and adds at most two terms per cluster (exact either
way). The index build's ids are compared exactly, tie order included:
``lax.sort(num_keys=2)`` on the CPU keeps equal (cluster, score) entries in
input order (held below), and the port's stable sort does the same.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu.simclusters import tweet_embeddings as jte
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.simclusters import tweet_embeddings as te

NOW = 10_000_000
T, KT, C, U, KU = 64, 8, 20, 16, 6
CFG = dict(clusters_per_tweet=KT, tweets_per_cluster=5, min_favorite_count=2, clusters_per_user_contribution=4)
SCORE_RTOL = 1e-6


def _interests(seed=0):
    """[U, KU] per-user interests, score-descending, some PAD slots."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(C, KU, replace=False) for _ in range(U)]).astype(np.int32)
    scores = -np.sort(-rng.uniform(0.05, 1.0, (U, KU)), axis=1).astype(np.float32)
    ids[3, 4:] = PAD_ID
    scores[3, 4:] = 0
    return ids, scores


def _tables(seed=1):
    """(created_ts, author): a few tweets older than the 3-day limit."""
    rng = np.random.default_rng(seed)
    created = (NOW - rng.integers(0, 3 * 86400, T)).astype(np.int32)
    created[:4] = NOW - 4 * 86400
    return created, rng.integers(0, U, T).astype(np.int32)


def _events(seed, n, start):
    """Fav events with repeated tweets (up to 6 on tweet 9), self-favs and
    old tweets; timestamps non-decreasing from ``start``."""
    rng = np.random.default_rng(seed)
    _, author = _tables()
    users = rng.integers(0, U, n).astype(np.int32)
    tweets = rng.integers(0, T, n).astype(np.int32)
    tweets[::7] = 9
    tweets[1:5] = [0, 1, 2, 3]  # older than the age limit
    users[5:8] = author[tweets[5:8]]  # self-favs
    ts = (start + np.cumsum(rng.integers(0, 900, n))).astype(np.int32)
    return users, tweets, ts


@functools.lru_cache(maxsize=None)
def _jax_fns():
    cfg = jte.TweetEmbeddingConfig(**CFG)
    apply = jax.jit(functools.partial(jte.apply_fav_events, config=cfg))
    build = jax.jit(functools.partial(jte.build_cluster_index, num_clusters=C, config=cfg))
    return apply, build


def _both_states():
    created, author = _tables()
    jstate = jte.init_state(T, KT, jnp.asarray(created), jnp.asarray(author))
    state = te.init_state(T, KT, created, author, device="cpu")
    return jstate, state


def _assert_same_state(got, want):
    for name in ("cluster_ids", "last_ts", "fav_count", "created_ts", "author"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=SCORE_RTOL, atol=0)


def _apply_both(jstate, state, events):
    ui_ids, ui_scores = _interests()
    apply, _ = _jax_fns()
    jui = js.SparseEmbedding(jnp.asarray(ui_ids), jnp.asarray(ui_scores))
    ui = SparseEmbedding(torch.from_numpy(ui_ids), torch.from_numpy(ui_scores))
    users, tweets, ts = events
    jstate = apply(jstate, jui, jnp.asarray(users), jnp.asarray(tweets), jnp.asarray(ts))
    state = te.apply_fav_events(state, ui, users, tweets, ts, te.TweetEmbeddingConfig(**CFG))
    return jstate, state


def test_apply_fav_events_matches_jax_scan():
    """Two batches: repeated tweets compose in stream order, self-favs and
    favs of old tweets are skipped, and the input state is left as it was."""
    jstate, state = _both_states()
    before = state.cluster_ids.clone()
    jstate, new = _apply_both(jstate, state, _events(2, 60, NOW - 20_000))
    assert torch.equal(state.cluster_ids, before)  # a new table, not an in-place fold
    _assert_same_state(new, jstate)
    assert int(new.fav_count[9]) >= 5 and int(new.fav_count[:4].sum()) == 0
    jstate, new = _apply_both(jstate, new, _events(3, 40, NOW - 2_000))
    _assert_same_state(new, jstate)


def test_more_favs_than_row_capacity_truncate_as_jax():
    """Twenty favs on one tweet from users with disjoint clusters: the row
    holds KT clusters and truncates at every step, in stream order."""
    users = (np.arange(20) % U).astype(np.int32)
    users[users == _tables()[1][11]] = 0 if _tables()[1][11] else 1  # no self-fav
    events = (users, np.full(20, 11, np.int32), (NOW - 5000 + 100 * np.arange(20)).astype(np.int32))
    jstate, state = _apply_both(*_both_states(), events)
    _assert_same_state(state, jstate)
    assert int(state.fav_count[11]) == 20
    assert bool((state.cluster_ids[11] != PAD_ID).all())


def test_jax_multi_key_sort_keeps_input_order_among_ties():
    """What the port matches: JAX's two-key lax.sort on the CPU leaves
    exactly equal (cluster, score) entries in input order."""
    rng = np.random.default_rng(4)
    c = rng.integers(0, 4, 3000).astype(np.int32)
    s = (rng.integers(1, 4, 3000) * 0.25).astype(np.float32)
    t = np.arange(3000, dtype=np.int32)
    _, _, got = jax.jit(lambda c, s, t: jax.lax.sort((c, -s, t), num_keys=2))(c, s, t)
    np.testing.assert_array_equal(np.asarray(got), t[np.lexsort((-s, c))])


def _tied_state():
    """A table of dyadic scores with many exact (cluster, score) ties and
    equal decay times; fav counts on both sides of the minimum."""
    rng = np.random.default_rng(5)
    created, author = _tables()
    ids = np.stack([rng.choice(C, KT, replace=False) for _ in range(T)]).astype(np.int32)
    scores = (rng.integers(1, 4, (T, KT)) * 0.5).astype(np.float32)
    ids[7, 5:] = PAD_ID
    scores[7, 5:] = 0
    scores[8, 2] = 0.0  # a zero score is dropped
    last = np.full(T, NOW - 3600, np.int32)
    favs = rng.integers(0, 4, T).astype(np.int32)  # min_favorite_count is 2
    arrays = (ids, scores, last, favs, created, author)
    return (jte.TweetEmbeddingState(*(jnp.asarray(a) for a in arrays)),
            te.TweetEmbeddingState(*(torch.from_numpy(a) for a in arrays)))


def _assert_same_index(got, want):
    np.testing.assert_array_equal(got.tweet_ids.numpy(), np.asarray(want.tweet_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=SCORE_RTOL, atol=0)
    np.testing.assert_array_equal(got.timestamps.numpy(), np.asarray(want.timestamps))


def test_build_cluster_index_with_ties_and_min_favs_matches_jax():
    jstate, state = _tied_state()
    _, build = _jax_fns()
    want = build(jstate, now=jnp.int32(NOW))
    got = te.build_cluster_index(state, C, te.TweetEmbeddingConfig(**CFG), NOW)
    assert got.tweet_ids.shape == (C, CFG["tweets_per_cluster"])
    _assert_same_index(got, want)
    # cut inside ties: a cluster holds more eligible entries than M
    eligible = (state.fav_count >= CFG["min_favorite_count"]).numpy()
    ids = state.cluster_ids.numpy()
    assert np.bincount(ids[eligible[:, None] & (ids != PAD_ID)], minlength=C).max() > CFG["tweets_per_cluster"]
    listed = set(got.tweet_ids.numpy().ravel().tolist()) - {PAD_ID}
    assert listed and all(eligible[t] for t in listed)


def test_events_then_index_build_match_jax():
    jstate, state = _apply_both(*_both_states(), _events(6, 80, NOW - 30_000))
    _, build = _jax_fns()
    for now in (NOW, NOW + 86_400):
        _assert_same_index(te.build_cluster_index(state, C, te.TweetEmbeddingConfig(**CFG), now),
                           build(jstate, now=jnp.int32(now)))


@pytest.mark.parametrize("tweet", [9, -1, T + 5])
def test_tweet_embedding_at_matches_jax(tweet):
    jstate, state = _apply_both(*_both_states(), _events(7, 30, NOW - 9_000))
    got = te.tweet_embedding_at(state, tweet, NOW + 7200, 8 * 3600)
    want = jte.tweet_embedding_at(jstate, jnp.int32(tweet), jnp.int32(NOW + 7200), 8 * 3600)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=SCORE_RTOL, atol=0)


def test_out_of_range_event_ids_follow_jax():
    """A user id past the table reads JAX's clamped row; a tweet id past
    the table reads its clamped row and writes nothing, as JAX's scatter
    drops it."""
    users = np.asarray([U + 3, -1, 2, 4], np.int32)
    tweets = np.asarray([10, 12, T + 2, -(T + 4)], np.int32)
    ts = np.full(4, NOW - 100, np.int32)
    jstate, state = _apply_both(*_both_states(), (users, tweets, ts))
    _assert_same_state(state, jstate)
