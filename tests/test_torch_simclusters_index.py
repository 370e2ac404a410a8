"""The port's cluster→tweet index job (``simclusters/index_generation.py``)
against the JAX package's on the same numpy inputs.

At the JAX tests' sizes the two indexes hold the same ids and scores within
rtol 1e-4 (the JAX test's bound: JAX's run totals are differences of f32
prefix sums), and both equal the dict oracle's. Where JAX's job breaks
(fault 11, ROADMAP §3) the port is held to the oracle and to float64 sums:

- 11a: the composite key ``tweet · C + cluster`` is int32 in JAX (x64 off);
  at T·C ≥ 2³¹ its index comes back empty, the port's equals the oracle's;
- 11b: at ~2M slots JAX's prefix-sum differences miss float64 sums by more
  than 1e-2, the port's scores hold rtol 1e-5 and its cuts the float64
  cuts up to near-ties.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.simclusters import index_generation as jig
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.simclusters import index_generation as ig


def _world(U, K, C, T, E, seed, tweets_from=0, types=3, pad_tail=True, dyadic=False):
    """Seeded InterestedIn rows (distinct clusters a user, an optional PAD
    last slot) and E events."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(C, K, replace=False) for _ in range(U)]).astype(np.int32)
    if dyadic:
        sc = (2.0 ** -rng.integers(0, 3, (U, K))).astype(np.float32)
    else:
        sc = rng.uniform(0.1, 1.0, (U, K)).astype(np.float32)
    if pad_tail:
        ids[:, K - 1], sc[:, K - 1] = PAD_ID, 0.0
    ev = (rng.integers(0, U, E).astype(np.int32), rng.integers(tweets_from, T, E).astype(np.int32),
          rng.integers(0, types, E).astype(np.int32), rng.integers(0, 1000, E).astype(np.int32))
    return ids, sc, ev


def _jax_index(ev, ids, sc, cfg, now, jit=True):
    fn = lambda e, i, s: jig.generate_cluster_to_tweet_index(  # noqa: E731
        e, i, s, jig.IndexGenerationConfig(**cfg), jnp.asarray(now, jnp.int32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX warns that its int64 key is int32
        out = (jax.jit(fn) if jit else fn)(jig.EventLog(*map(jnp.asarray, ev)), jnp.asarray(ids), jnp.asarray(sc))
    return np.array(out.tweet_ids), np.array(out.scores)


def _port_index(ev, ids, sc, cfg, now):
    out = ig.generate_cluster_to_tweet_index(ig.EventLog(*map(torch.from_numpy, ev)), torch.from_numpy(ids),
                                             torch.from_numpy(sc), ig.IndexGenerationConfig(**cfg), now)
    return out.tweet_ids.numpy(), out.scores.numpy()


def _as_dict(tweet_ids, scores):
    return {c: [(int(t), float(s)) for t, s in zip(tweet_ids[c], scores[c]) if t != PAD_ID]
            for c in range(tweet_ids.shape[0]) if (tweet_ids[c] != PAD_ID).any()}


def _same_as_oracle(got, want, rtol):
    assert set(got) == set(want)
    for c in want:
        assert [t for t, _ in got[c]] == [t for t, _ in want[c]], f"cluster {c}"
        np.testing.assert_allclose([s for _, s in got[c]], [s for _, s in want[c]], rtol=rtol)


# the JAX tests' four cases (tests/test_index_generation.py): the oracle
# match, the engagement gate, weights and decay, the video-view weights
JAX_CASES = {
    "oracle": (dict(U=30, K=6, C=40, T=50, E=200, seed=0),
               dict(num_clusters=40, num_tweets=50, clusters_per_tweet=5, tweets_per_cluster=8, min_engagements=2,
                    event_weights=(1.0, 0.5, 0.25)), 2000),
    "video_view": (dict(U=30, K=6, C=40, T=50, E=100, seed=0),
                   dict(num_clusters=40, num_tweets=50, clusters_per_tweet=5, tweets_per_cluster=8,
                        event_weights=(0.0, 0.0, 1.0)), 2000),
    "tight_cuts": (dict(U=64, K=8, C=24, T=40, E=600, seed=3),
                   dict(num_clusters=24, num_tweets=40, clusters_per_tweet=3, tweets_per_cluster=4,
                        min_engagements=3), 900),
    "dyadic_ties": (dict(U=16, K=4, C=12, T=20, E=300, seed=4, dyadic=True, types=1),
                    dict(num_clusters=12, num_tweets=20, clusters_per_tweet=2, tweets_per_cluster=5,
                         half_life_s=1e12), 1000),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_index_matches_jax_and_the_oracle(case):
    shape, cfg, now = JAX_CASES[case]
    ids, sc, ev = _world(**shape)
    got_ids, got_s = _port_index(ev, ids, sc, cfg, now)
    want_ids, want_s = _jax_index(ev, ids, sc, cfg, now)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4)
    oracle = ig.generate_cluster_to_tweet_index_reference(
        ig.EventLog(*map(torch.from_numpy, ev)), ids, sc, ig.IndexGenerationConfig(**cfg), now)
    if case != "dyadic_ties":
        _same_as_oracle(_as_dict(got_ids, got_s), oracle, rtol=1e-5)
        return
    # exact sums on both sides and many equal scores, cut among ties: JAX's
    # tie order (the lower (tweet, cluster) key first) bit for bit; the
    # oracle breaks ties in its dicts' insertion order instead
    np.testing.assert_array_equal(got_s, want_s)
    assert any(len(set(r[r > 0])) < (r > 0).sum() for r in got_s)


def test_engagement_gate_and_decay_as_jax():
    """The JAX tests' two hand cases: one event under a gate of 2; a fresh
    fav and an hour-old retweet at a one-hour half-life."""
    ev = (np.asarray([0], np.int32), np.asarray([7], np.int32), np.asarray([0], np.int32), np.asarray([100], np.int32))
    cfg = dict(num_clusters=10, num_tweets=10, min_engagements=2, clusters_per_tweet=4, tweets_per_cluster=4)
    got_ids, _ = _port_index(ev, np.asarray([[3, 4]], np.int32), np.asarray([[1.0, 0.5]], np.float32), cfg, 100)
    assert (got_ids == PAD_ID).all()
    ev = (np.asarray([0, 0], np.int32), np.asarray([0, 1], np.int32), np.asarray([0, 1], np.int32),
          np.asarray([1000, 1000 - 3600], np.int32))
    ii, s = np.asarray([[5, PAD_ID]], np.int32), np.asarray([[2.0, 0.0]], np.float32)
    cfg = dict(num_clusters=10, num_tweets=10, clusters_per_tweet=4, tweets_per_cluster=4, half_life_s=3600.0,
               event_weights=(1.0, 0.5))
    got = _port_index(ev, ii, s, cfg, 1000)
    want = _jax_index(ev, ii, s, cfg, 1000, jit=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][5, :2].tolist() == [0, 1] and got[1][5, :2].tolist() == [2.0, 0.5]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_oracle_copy_equals_jax(seed):
    ids, sc, ev = _world(U=20, K=5, C=30, T=25, E=150, seed=seed)
    cfg = dict(num_clusters=30, num_tweets=25, clusters_per_tweet=3, tweets_per_cluster=4, min_engagements=seed)
    got = ig.generate_cluster_to_tweet_index_reference(
        ig.EventLog(*map(torch.from_numpy, ev)), torch.from_numpy(ids), torch.from_numpy(sc),
        ig.IndexGenerationConfig(**cfg), 800)
    want = jig.generate_cluster_to_tweet_index_reference(
        jig.EventLog(*map(jnp.asarray, ev)), jnp.asarray(ids), jnp.asarray(sc), jig.IndexGenerationConfig(**cfg), 800)
    assert got == want


def test_fault_11a_jax_keys_wrap_past_int32():
    """T·C ≥ 2³¹ (C = 145,408 as bench.py, tweets in [15,000, 20,000)): the
    JAX index is empty, the port's equals the dict oracle's."""
    ids, sc, ev = _world(U=64, K=4, C=145_408, T=20_000, E=64, seed=0, tweets_from=15_000, types=5,
                         pad_tail=False)
    cfg = dict(num_clusters=145_408, num_tweets=20_000, tweets_per_cluster=8)
    assert 20_000 * 145_408 >= 2**31
    jax_ids, _ = _jax_index(ev, ids, sc, cfg, 1000, jit=False)
    assert (jax_ids == PAD_ID).all()
    oracle = ig.generate_cluster_to_tweet_index_reference(
        ig.EventLog(*map(torch.from_numpy, ev)), ids, sc, ig.IndexGenerationConfig(**cfg), 1000)
    assert sum(len(r) for r in oracle.values()) == 64 * 4
    _same_as_oracle(_as_dict(*_port_index(ev, ids, sc, cfg, 1000)), oracle, rtol=1e-6)


def test_fault_11b_jax_prefix_sums_lose_precision():
    """~2M slots (U=4,096, K=50, T=8,192, C=4,096, E=40,000): JAX's scores
    miss float64 sums by more than 1e-2; the port holds rtol 1e-5, and its
    cuts the float64 cuts up to near-ties."""
    ids, sc, ev = _world(U=4096, K=50, C=4096, T=8192, E=40_000, seed=1, types=5, pad_tail=False)
    cfg = dict(num_clusters=4096, num_tweets=8192)
    now = 1000
    events = ig.EventLog(*map(torch.from_numpy, ev))
    config = ig.IndexGenerationConfig(**cfg)
    port = ClusterTweetIndex(*(torch.from_numpy(a) for a in _port_index(ev, ids, sc, cfg, now)),
                             torch.zeros((4096, 400), dtype=torch.int32))
    got = ig.compare_with_float64(port, events, ids, sc, config, now, rtol=1e-5)
    assert got["entries"] > 100_000 and got["unknown"] == 0
    assert got["max_rel_err"] <= 1e-5 and got["far"] == 0 and got["out_of_order"] == 0, got
    j = _jax_index(ev, ids, sc, cfg, now)
    jax_idx = ClusterTweetIndex(torch.from_numpy(j[0]), torch.from_numpy(j[1]), port.timestamps)
    bad = ig.compare_with_float64(jax_idx, events, ids, sc, config, now, rtol=1e-5)
    assert bad["max_rel_err"] > 1e-2 and bad["far"] > 0, bad


def test_raises_before_building_past_int32_slots():
    ids = torch.zeros((1, 1 << 16), dtype=torch.int32)
    events = ig.EventLog(*(torch.zeros(1 << 15, dtype=torch.int32) for _ in range(4)))
    with pytest.raises(ValueError, match="int32"):
        ig.generate_cluster_to_tweet_index(events, ids, ids.float(), ig.IndexGenerationConfig(4, 4), 0)


def test_sum_by_key_matches_float64_with_long_runs():
    """One run collapse over dense run indices: each (tweet, cluster) total
    within rtol 1e-6 of float64, runs of up to ~600 slots."""
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 3000, 200_000) * (1 << 33) + rng.integers(0, 2, 200_000))
    vals = torch.from_numpy(rng.random(200_000).astype(np.float32))
    key_s, total, is_end = ig._sum_by_key(keys, vals)
    uniq, inv = np.unique(keys.numpy(), return_inverse=True)
    want = np.bincount(inv, weights=vals.numpy().astype(np.float64))
    np.testing.assert_array_equal(key_s[is_end].numpy(), uniq)
    np.testing.assert_allclose(total[is_end].numpy(), want, rtol=1e-6)
    assert float(total[~is_end].abs().max()) == 0.0


def test_index_job_world_builds_and_serves_the_job():
    """``data/sann_world.build_index_job_world`` at a cut shape: users' rows
    of one community each, events mostly in the user's community, and the
    job's index held to float64."""
    from the_algorithm_tpu_torch.data import sann_world

    shape = sann_world.IndexJobShape(sann=sann_world.WorldShape(n_comm=16, cpc=64, M=40, N=10, X=50, T=1, KT=1, Q=1),
                                     users=512, tweets=4096, events=8192, K=10)
    w = sann_world.build_index_job_world(shape, seed=3)
    comm_clusters = np.random.default_rng(0).permutation(16 * 64).reshape(16, 64)
    assert all(set(w.ii_ids[u]) <= set(comm_clusters[w.user_comm[u]]) for u in range(512))
    assert (w.tweet_comm[w.tweet_ids] == w.user_comm[w.user_rows]).mean() > 0.85
    cfg = ig.IndexGenerationConfig(num_clusters=1024, num_tweets=4096, tweets_per_cluster=40)
    events = ig.EventLog(*map(torch.from_numpy, (w.user_rows, w.tweet_ids, w.event_type, w.timestamps)))
    index = ig.generate_cluster_to_tweet_index(events, torch.from_numpy(w.ii_ids), torch.from_numpy(w.ii_scores),
                                               cfg, w.now)
    got = ig.compare_with_float64(index, events, w.ii_ids, w.ii_scores, cfg, w.now)
    assert got["entries"] > 10_000 and got["far"] == 0 and got["out_of_order"] == 0 and got["max_rel_err"] <= 1e-5
