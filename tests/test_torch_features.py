"""The port's graph features and user signals
(the_algorithm_tpu_torch/features/{graph_features, user_signals}.py) at ids
outside their tables, against the JAX package.

A JAX gather reads a negative id from the end (+n) and clamps the result to
[0, n-1]; the port maps every indexed id through ``gather.jax_rows`` to read
the same row. Counts, ids, timestamps and masks are compared exactly; the
normalized counts (one f32 division of the same integers) too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.features import graph_features as jgf
from the_algorithm_tpu.features import user_signals as jus
from the_algorithm_tpu_torch.features import graph_features, user_signals

U, D, W = 24, 12, 6


def _adjacency(seed=0):
    """[E, U, D] sorted, PAD-padded neighbour rows with many shared ids."""
    rng = np.random.default_rng(seed)
    rows = np.full((len(graph_features.EdgeType), U, D), PAD_ID, np.int32)
    for e in range(rows.shape[0]):
        for u in range(U):
            n = int(rng.integers(0, D + 1))
            rows[e, u, :n] = np.sort(rng.choice(3 * U, n, replace=False))
    return rows


# user ids: in range, at and past U, negative, and far negative
USERS = [3, U, U + 7, -1, -(U + 2)]


@pytest.mark.parametrize("user", USERS)
def test_get_intersection_out_of_range_ids_match_jax(user):
    rows = _adjacency()
    cands = np.asarray([0, 5, U - 1, U, U + 40, -1, -3, -(U + 9)], np.int32)
    tables = graph_features.GraphTables(torch.from_numpy(rows))
    jtables = jgf.GraphTables(jnp.asarray(rows))
    for ue, ce in graph_features.FEATURE_PAIRS.values():
        counts, degree = graph_features.get_intersection(tables, user, torch.from_numpy(cands), ue, ce)
        want_counts, want_degree = jgf.get_intersection(jtables, jnp.int32(user), jnp.asarray(cands),
                                                        jgf.EdgeType(int(ue)), jgf.EdgeType(int(ce)))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
        assert int(degree) == int(want_degree)


@pytest.mark.parametrize("user", USERS)
def test_feature_block_out_of_range_ids_match_jax(user):
    rows = _adjacency(1)
    cands = np.asarray([2, U + 1, -2, -(U + 5), 7], np.int32)
    got = graph_features.feature_block(graph_features.GraphTables(torch.from_numpy(rows)), user,
                                       torch.from_numpy(cands))
    want = jgf.feature_block(jgf.GraphTables(jnp.asarray(rows)), jnp.int32(user), jnp.asarray(cands))
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def _signal_stores(seed=2):
    rng = np.random.default_rng(seed)
    E = 200
    users = rng.integers(0, U, E)
    types = rng.integers(0, len(user_signals.SignalType), E)
    targets = rng.integers(0, 10_000, E)
    ts = np.sort(rng.integers(1000, 5000, E))
    store = user_signals.record(user_signals.init_store(U, W, device="cpu"), users, types, targets, ts)
    jstore = jus.record(jus.init_store(U, W), users, types, targets, ts)
    return store, jstore


@pytest.mark.parametrize("user", USERS)
def test_fetch_out_of_range_user_ids_match_jax(user):
    store, jstore = _signal_stores()
    for st in (user_signals.SignalType.TWEET_FAVORITE, user_signals.SignalType.RETWEET):
        for min_ts in (None, 3000):
            got = user_signals.fetch(store, user, st, min_timestamp=min_ts)
            want = jus.fetch(jstore, jnp.int32(user), jus.SignalType(int(st)), min_timestamp=min_ts)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = user_signals.fetch_engagement_tweets(store, user, [user_signals.SignalType.REPLY,
                                                             user_signals.SignalType.TWEET_SHARE])
    want = jus.fetch_engagement_tweets(jstore, jnp.int32(user), [jus.SignalType.REPLY, jus.SignalType.TWEET_SHARE])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
