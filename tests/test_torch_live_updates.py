"""The port's live-update writer (the_algorithm_tpu_torch/mixers/live_updates.py)
against the JAX package's, on the same seeded world (synthetic_world, seed 3,
32 users): the four cases of tests/test_live_updates.py, each run on both
packages, plus ring pushes with repeated keys and with more than W events on
one key, a batch that exhausts a store's capacity, and bench.py's mixed
event batches.

Tolerances: aggregate values at rtol 1e-6 (float32 folds and exp2 decays
taken in another order or by another library; as
test_torch_hydration.py); timestamps, rings, engagement history, resolvers
and applied counts exactly; scores and head probabilities at rtol 1e-5,
atol 1e-6 (the model's f32 sums); the refreshed index as
test_torch_tweet_embeddings.py holds it (ids exact, scores rtol 1e-6).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from the_algorithm_tpu.mixers import device_hydration as jdh
from the_algorithm_tpu.mixers import feature_schema as jfs
from the_algorithm_tpu.mixers import home_mixer as jhm
from the_algorithm_tpu.mixers import live_updates as jlu
from the_algorithm_tpu.mixers import wide_hydrators as jwh
from the_algorithm_tpu.models import masknet as jmasknet
from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu.pipeline.component import Candidate as JCandidate
from the_algorithm_tpu.simclusters import ann as jann
from the_algorithm_tpu.simclusters import tweet_embeddings as jte
from the_algorithm_tpu_torch.features import aggregation
from the_algorithm_tpu_torch.features.user_signals import SignalType
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import home_mixer as hm
from the_algorithm_tpu_torch.mixers import live_updates as lu
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.pipeline.component import Candidate
from the_algorithm_tpu_torch.simclusters import ann
from the_algorithm_tpu_torch.simclusters import tweet_embeddings as te

NOW = 10_000_000
A = 48
WORLD = dict(seed=3, num_users=32, num_authors=A, num_tweets=1 << 12, engagement_width=8, now=NOW)
PB = 128
FOLD_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-6
WEIGHTS = [1.0, 0.5, 0.25, 0.125]


@functools.lru_cache(maxsize=None)
def _worlds():
    """Both packages' tables, formulas, resolvers and f32 MaskNets (the
    flax params carried across)."""
    jworld = jwh.synthetic_world(**WORLD, include_device_spec=True)
    jspec = jworld.pop("device_spec")
    world = wh.synthetic_world(**WORLD, device="cpu")
    spec = world.pop("device_spec")
    F = jfs.total_width(jfs.WIDE_SCHEMA)
    cfg = dict(num_features=F, num_heads=4, mask_blocks=1, block_dim=32, aggregation_dim=16, head_hidden=(16,),
               dtype="float32")
    jmodel = jmasknet.MaskNet(jmasknet.MaskNetConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, F)))
    model = masknet.MaskNet(masknet.MaskNetConfig(**cfg), device="cpu")
    model.load_state_dict(masknet.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jdh.build_from_world(jworld, jspec), dh.build_from_world(world, spec), (jmodel, params), model


def _scorers():
    """Fresh scorers over the worlds' tables (an updater swaps in new tables
    and never writes the old ones) with copies of the resolvers (an update
    allocates rows in them)."""
    (jt, jf, jres), (t, f, res), (jmodel, params), model = _worlds()
    jscorer = jdh.DeviceHydrationScorer(jt, jf, copy.deepcopy(jres), jmodel, params, jnp.asarray(WEIGHTS), pad_b=PB,
                                        compute_dtype=jnp.float32)
    scorer = dh.DeviceHydrationScorer(t, f, copy.deepcopy(res), model, WEIGHTS, pad_b=PB, compute_dtype=torch.float32)
    return jscorer, scorer


def _candidates(cls, n):
    """tests/test_device_hydration.py's make_candidates, for either package."""
    rng = np.random.default_rng(9)
    sources = ("simclusters_interested_in", "EarlybirdInNetwork", "DirectUteg")
    out = []
    for i in range(n):
        tid = int(rng.integers(1, 1 << 20))
        out.append(cls(id=tid, source=sources[i % 3], features={
            "retrieval_score": float(rng.random()), "social_proof": float(i % 3), "author_id": tid % A,
            "created_ts": NOW - (tid % 86400), "topic_id": tid % 16, "language_id": tid % 8,
            "media_type": tid % 4, "conversation_id": tid // 2, "is_in_network": float(i % 2)}))
    return out


def _score_both(jscorer, scorer, n=12, user_id=5):
    got = scorer.score_requests([(hm.ForYouQuery(user_id=user_id, followed_authors=[1, 2, 3], max_results=50,
                                                 now=NOW), _candidates(Candidate, n))])[0]
    want = jscorer.score_requests([(jhm.ForYouQuery(user_id=user_id, followed_authors=[1, 2, 3], max_results=50,
                                                    now=NOW), _candidates(JCandidate, n))])[0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
    return got


def _assert_same_tables(t, jt):
    """The port's live tables against JAX's, and the pack consistent with
    its per-store views."""
    for g, w in zip(t.agg_values, jt.agg_values):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FOLD_RTOL, atol=0)
    for name in ("agg_last_ts",):
        for g, w in zip(getattr(t, name), getattr(jt, name)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in ("uss_ids", "uss_ts", "eng_ids", "eng_type", "eng_ts", "eng_valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jt, name)).astype(np.int32),
                                      err_msg=name)
    pack = t.agg_packed
    assert torch.equal(pack.values, torch.cat(t.agg_values)) and torch.equal(pack.last_ts, torch.cat(t.agg_last_ts))
    base = pack.values.untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in t.agg_values)  # views into the pack


def _apply_both(jupd, upd, events):
    want = jupd.apply(jlu.batch_from_actions(events))
    got = upd.apply(lu.batch_from_actions(events))
    assert got == want
    _assert_same_tables(upd.scorer.tables, jupd.scorer.tables)
    for name, r in upd.scorer.builder.resolvers.items():
        assert r._map == jupd.scorer.builder.resolvers[name]._map, name
    return got


def test_event_moves_next_request_scores():
    """A tweet faved mid-serve changes its score in the next request, on both
    packages alike."""
    jscorer, scorer = _scorers()
    jupd, upd = jlu.LiveUpdater(jscorer), lu.LiveUpdater(scorer)
    target = _candidates(Candidate, 12)[0]
    _, combined0 = _score_both(jscorer, scorer)
    events = [(7 + i, target.id, int(target.features["author_id"]), "fav" if i % 2 == 0 else "retweet", NOW - 50 + i)
              for i in range(32)]
    counts = _apply_both(jupd, upd, events)
    assert counts["events"] == 32 and counts["tweet_agg"] == 32
    _, combined1 = _score_both(jscorer, scorer)
    assert combined0[0] != combined1[0], "fav burst did not move the score"


def test_fold_matches_host_aggregation_framework():
    """The fold equals aggregation.update on a copy of the store, read back
    through the live tables, and JAX's fold."""
    jscorer, scorer = _scorers()
    jupd, upd = jlu.LiveUpdater(jscorer), lu.LiveUpdater(scorer)
    si = dh.CAND_KEYED_AGG.index("tweet_agg")
    resolver = scorer.builder.resolvers["tweet_agg"]
    tweet = 777_001
    events = [(3, tweet, 9, "fav", NOW - 100), (4, tweet, 9, "reply", NOW - 80), (5, tweet, 9, "fav", NOW - 60)]
    store_before = aggregation.AggregateStore(scorer.tables.agg_values[si].clone(),
                                              scorer.tables.agg_last_ts[si].clone())
    _apply_both(jupd, upd, events)
    row = int(resolver.lookup([(tweet,)])[0])
    assert row >= 0
    onehot = np.zeros((3, len(upd.group.labels)), np.float32)
    onehot[np.arange(3), [lu.LABEL_OF_ACTION[a] for a in ("fav", "reply", "fav")]] = 1.0
    want = aggregation.update(upd.group, store_before, torch.full((3,), row), torch.ones((3, 1)),
                              torch.from_numpy(onehot), torch.tensor([NOW - 100, NOW - 80, NOW - 60]))
    np.testing.assert_allclose(scorer.tables.agg_values[si][row].numpy(), want.values[row].numpy(),
                               rtol=FOLD_RTOL, atol=0)
    assert int(scorer.tables.agg_last_ts[si][row]) == NOW - 60
    assert int(scorer.tables.agg_packed.last_ts[int(scorer.tables.agg_packed.offsets[si]) + row]) == NOW - 60


def test_uss_and_engagement_rings_advance():
    jscorer, scorer = _scorers()
    jupd, upd = jlu.LiveUpdater(jscorer), lu.LiveUpdater(scorer)
    u = 11
    _apply_both(jupd, upd, [(u, 555_000 + i, 2, "fav", NOW - 10 + i) for i in range(3)])
    t = scorer.tables
    ring = t.uss_ids[u % t.uss_ids.shape[0], int(SignalType.TWEET_FAVORITE)].numpy()
    assert ring[0] == 555_002 and ring[1] == 555_001 and ring[2] == 555_000  # newest first
    eng = t.eng_ids[u % t.eng_ids.shape[0]].numpy()
    assert eng[0] == 555_002
    assert int(t.eng_type[u % t.eng_ids.shape[0]][0]) == lu.ENG_OF_ACTION["fav"]


def test_refresh_moves_retrieval():
    """Fav burst + refresh_index: the tweet enters the cluster index and
    ranks for users interested in its favers' clusters, as in JAX."""
    jscorer, scorer = _scorers()
    T, K, U = 256, 8, 16
    rng = np.random.default_rng(0)
    created, author = np.full(T, NOW - 3600, np.int32), rng.integers(0, 8, T).astype(np.int32)
    ui_ids, ui_scores = (np.arange(U)[:, None] % 4).astype(np.int32), np.ones((U, 1), np.float32)
    kw = dict(clusters_per_tweet=K, tweets_per_cluster=4, min_favorite_count=2, clusters_per_user_contribution=1)
    jupd = jlu.LiveUpdater(jscorer, emb_state=jte.init_state(T, K, jnp.asarray(created), jnp.asarray(author)),
                           user_interests=js.SparseEmbedding(jnp.asarray(ui_ids), jnp.asarray(ui_scores)),
                           emb_config=jte.TweetEmbeddingConfig(**kw), num_clusters=4)
    upd = lu.LiveUpdater(scorer, emb_state=te.init_state(T, K, created, author, device="cpu"),
                         user_interests=SparseEmbedding(torch.from_numpy(ui_ids), torch.from_numpy(ui_scores)),
                         emb_config=te.TweetEmbeddingConfig(**kw), num_clusters=4)
    tweet = 99  # favers are users ≡ 1 (mod 4) → mass in cluster 1
    _apply_both(jupd, upd, [(1 + 4 * i, tweet, 3, "fav", NOW - 30 + i) for i in range(4)])
    index, jindex = upd.refresh_index(NOW), jupd.refresh_index(NOW)
    np.testing.assert_array_equal(index.tweet_ids.numpy(), np.asarray(jindex.tweet_ids))
    np.testing.assert_allclose(index.scores.numpy(), np.asarray(jindex.scores), rtol=FOLD_RTOL, atol=0)
    assert tweet in index.tweet_ids[1].numpy()
    src = SparseEmbedding(torch.tensor([[1]], dtype=torch.int32), torch.ones((1, 1)))
    cfg = dict(max_scan_clusters=1, max_top_tweets_per_cluster=4, max_num_results=4,
               max_tweet_candidate_age_hours=10 ** 6)
    ids, _ = ann.get_tweet_candidates_batch(index, src, ann.SimClustersANNConfig(**cfg))
    want, _ = jann.get_tweet_candidates_batch(jindex, js.SparseEmbedding(jnp.asarray([[1]], jnp.int32),
                                                                         jnp.ones((1, 1), jnp.float32)),
                                              jann.SimClustersANNConfig(**cfg))
    assert tweet in set(ids[0].tolist())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))


def _ring_events(rng, E, U, S):
    """Events on few keys: repeated (user, signal) pairs, one key with more
    than W events, and skipped (-1) signals."""
    u = rng.integers(0, 4, E).astype(np.int32)
    s = rng.integers(-1, S, E).astype(np.int32)
    u[:20], s[:20] = 2, 1  # 20 events on one key, more than W
    t = rng.integers(0, 1 << 30, E).astype(np.int32)
    ts = np.sort(rng.integers(0, 10 ** 6, E)).astype(np.int32)
    return u, s, t, ts


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_push_matches_jax_scan(seed):
    rng = np.random.default_rng(seed)
    U, S, W, E = 6, 5, 7, 64
    ids = rng.integers(0, 1000, (U, S, W)).astype(np.int32)
    tss = rng.integers(0, 1000, (U, S, W)).astype(np.int32)
    u, s, t, ts = _ring_events(rng, E, U, S)
    got = lu._ring_push(torch.from_numpy(ids), torch.from_numpy(tss), u, s, t, ts)
    want = jax.jit(jlu._ring_push)(*(jnp.asarray(a) for a in (ids, tss, u, s, t, ts)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not torch.equal(got[0], torch.from_numpy(ids))


@pytest.mark.parametrize("seed", [0, 1])
def test_eng_push_matches_jax_scan(seed):
    rng = np.random.default_rng(seed + 10)
    U, W, E = 5, 6, 50
    tables = [rng.integers(0, 1000, (U, W)).astype(np.int32) for _ in range(3)]
    valid = rng.integers(0, 2, (U, W)).astype(np.int32)
    u, kind, t, ts = _ring_events(rng, E, U, 6)
    got = lu._eng_push(*(torch.from_numpy(a) for a in tables), torch.from_numpy(valid), u, kind, t, ts)
    want = jax.jit(jlu._eng_push)(*(jnp.asarray(a) for a in tables), jnp.asarray(valid.astype(bool)),
                                  *(jnp.asarray(a) for a in (u, kind, t, ts)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))


def test_batch_that_exhausts_a_store_matches_jax():
    """More new tweet keys than the tweet store has spare rows: the resolver
    allocates until it is full, the rest of the batch folds only into rows
    that exist, and masked events fold a zero label vector into row 0, whose
    last_ts still advances (the JAX package's behaviour)."""
    jscorer, scorer = _scorers()
    jupd, upd = jlu.LiveUpdater(jscorer), lu.LiveUpdater(scorer)
    si = dh.CAND_KEYED_AGG.index("tweet_agg")
    resolver = scorer.builder.resolvers["tweet_agg"]
    spare = resolver.capacity - len(resolver._map)
    assert spare > 0
    events = [(i % 32, 900_000 + i, i % A, "fav", NOW - 40 + i // 4) for i in range(spare + 12)]
    counts = _apply_both(jupd, upd, events)
    assert len(resolver._map) == resolver.capacity
    assert counts["tweet_agg"] < len(events)
    assert int(scorer.tables.agg_last_ts[si][0]) == max(e[-1] for e in events)


def _bench_batch(rng, E=256, target=4321, target_author=17):
    """bench.py's event batch: users, tweets below 2¹⁵ and kinds drawn as
    there, 8 favs on one target tweet."""
    users = rng.integers(0, 32, E)
    tweets = rng.integers(0, 1 << 15, E).astype(np.int64)
    tweets[:8] = target
    kinds = rng.choice(np.asarray(["fav", "retweet", "reply", "click"]), E, p=[0.7, 0.1, 0.1, 0.1])
    return [(int(users[i]), int(tweets[i]), int(tweets[i] % A) if tweets[i] != target else target_author,
             str(kinds[i]), NOW + i // 64) for i in range(E)]


def test_bench_event_batches_match_jax():
    """Two of bench.py's 256-event batches, with a tweet-embedding state:
    every table, the resolvers and the embedding state as JAX's."""
    jscorer, scorer = _scorers()
    T, Kt, C = 1 << 12, 16, 64
    rng = np.random.default_rng(23)
    created = (NOW - rng.integers(0, 4 * 86400, T)).astype(np.int32)
    author = rng.integers(0, A, T).astype(np.int32)
    ui_ids = np.stack([rng.choice(C, 10, replace=False) for _ in range(32)]).astype(np.int32)
    ui_scores = -np.sort(-rng.uniform(0.05, 1.0, (32, 10)), axis=1).astype(np.float32)
    kw = dict(clusters_per_tweet=Kt, tweets_per_cluster=32, min_favorite_count=2, clusters_per_user_contribution=6)
    jupd = jlu.LiveUpdater(jscorer, emb_state=jte.init_state(T, Kt, jnp.asarray(created), jnp.asarray(author)),
                           user_interests=js.SparseEmbedding(jnp.asarray(ui_ids), jnp.asarray(ui_scores)),
                           emb_config=jte.TweetEmbeddingConfig(**kw), num_clusters=C)
    upd = lu.LiveUpdater(scorer, emb_state=te.init_state(T, Kt, created, author, device="cpu"),
                         user_interests=SparseEmbedding(torch.from_numpy(ui_ids), torch.from_numpy(ui_scores)),
                         emb_config=te.TweetEmbeddingConfig(**kw), num_clusters=C)
    _, combined0 = _score_both(jscorer, scorer)
    for _ in range(2):
        _apply_both(jupd, upd, _bench_batch(rng))
    _score_both(jscorer, scorer)
    got, want = upd.emb_state, jupd.emb_state
    for name in ("cluster_ids", "last_ts", "fav_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=FOLD_RTOL, atol=0)
    assert int(got.fav_count[4321 % T]) > 0
    index, jindex = upd.refresh_index(NOW + 10), jupd.refresh_index(NOW + 10)
    np.testing.assert_array_equal(index.tweet_ids.numpy(), np.asarray(jindex.tweet_ids))


def test_scorer_reads_one_snapshot_per_batch():
    """A batch reads ``scorer.tables`` once: a writer's swap between two
    reads cannot mix two versions in one batch."""

    class Counting(dh.DeviceHydrationScorer):
        reads = 0

        @property
        def tables(self):
            Counting.reads += 1
            return self._tables

        @tables.setter
        def tables(self, value):
            self._tables = value

    (_, _, _), (t, f, res), _, model = _worlds()
    scorer = Counting(t, f, copy.deepcopy(res), model, WEIGHTS, pad_b=PB, compute_dtype=torch.float32)
    Counting.reads = 0
    scorer.score_requests([(hm.ForYouQuery(user_id=3, max_results=50, now=NOW), _candidates(Candidate, 8))])
    assert Counting.reads == 1


def test_serving_while_a_writer_swaps_reads_whole_versions():
    """A serve thread scoring while a writer thread applies batches (the
    interpreter switching threads every microsecond): every served result
    equals the scores of one whole version of the tables."""
    import sys
    import threading

    _, scorer = _scorers()
    updater = lu.LiveUpdater(scorer)
    target = _candidates(Candidate, 12)[0]
    versions = [scorer.tables]
    batches = [[(7 + i, target.id, 3, "fav", NOW - 50 + 10 * b + i) for i in range(16)] for b in range(4)]
    query = hm.ForYouQuery(user_id=5, followed_authors=[1, 2, 3], max_results=50, now=NOW)
    served, errors = [], []

    def writer():
        for b in batches:
            updater.apply(lu.batch_from_actions(b))
            versions.append(scorer.tables)

    def server():
        try:
            for _ in range(6):
                served.append(scorer.score_requests([(query, _candidates(Candidate, 12))])[0][1])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer), threading.Thread(target=server)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(served) == 6 and len(versions) == 5
    per_version = []
    for t in versions:
        scorer.tables = t
        per_version.append(scorer.score_requests([(query, _candidates(Candidate, 12))])[0][1])
    assert len({float(v[0]) for v in per_version}) == 5  # every batch moved the target's score
    for got in served:
        assert any(np.array_equal(got, v) for v in per_version)
