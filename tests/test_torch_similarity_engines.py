"""The port's similarity engines (the_algorithm_tpu_torch/mixers/similarity_engines.py)
against their JAX twins, engine by engine, on one seeded world fed to both.

The world mirrors ``tests/test_candidate_pipeline_catalog.make_world`` (a
cluster index, dense item tables, UTEG/UTG graphs, an earlybird index, QIG
and topic tables, trip and lookup stores), with random graphs and repeated
ids so that dedup and tie order matter, and 256 dense items so that a
top-200 exists (``lax.top_k`` raises for k past the items, and so does the
port). Candidate ids are compared in order, ties included; scores at rtol
1e-5 (f32 sums in another order); the extra features (``social_proof``,
``cooccurrence``, ``unified_sources``, ``promoted``, ``lookup_model_id``)
exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.core.config import Params as JParams
from the_algorithm_tpu.graph import graphjet as jg
from the_algorithm_tpu.graph import uteg as ju
from the_algorithm_tpu.mixers import similarity_engines as jse
from the_algorithm_tpu.ops.retrieval import ClusterTweetIndex as JIndex
from the_algorithm_tpu.ops.sparse import SparseEmbedding as JEmb
from the_algorithm_tpu.search import earlybird as jeb
from the_algorithm_tpu.simclusters import ann as jann
from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.data.tweet_mixer_world import Query
from the_algorithm_tpu_torch.graph import graphjet, uteg
from the_algorithm_tpu_torch.mixers import similarity_engines as se
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.simclusters import ann

RTOL, ATOL = 1e-5, 1e-6
C, M, U, W, T, WR, N_DENSE, D, DOCS = 8, 6, 16, 8, 64, 8, 256, 16, 32
EXACT_FEATURES = ("social_proof", "cooccurrence", "unified_sources", "promoted", "lookup_model_id")
QUERIES = [
    Query(user_id=1, followed_authors=(2, 3, 5), recent_engagement_ids=(7, 11)),
    Query(user_id=6, followed_authors=(0, 4), recent_engagement_ids=(20, 3, 41), source_tweet_id=9),
    Query(user_id=13, followed_authors=(1, 2, 3, 6, 7), recent_engagement_ids=(5,)),
]


def _cluster_index_np(rng, base, id_space):
    ids = (rng.integers(0, id_space, (C, M)) + base).astype(np.int32)
    ids[0, -1] = PAD_ID  # an empty slot
    scores = -np.sort(-rng.uniform(0.05, 1.0, (C, M)), axis=1).astype(np.float32)
    return ids, scores, np.full((C, M), 50, np.int32)


def _emb_np(clusters, K=4):
    ids = np.full(K, PAD_ID, np.int32)
    sc = np.zeros(K, np.float32)
    for j, c in enumerate(clusters):
        ids[j], sc[j] = c, 1.0 - 0.125 * j
    return ids, sc


class World:
    """The same stores for both packages: ``j`` the JAX side, ``p`` the port's."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.sann_np = _cluster_index_np(rng, 100, 40)  # 40 ids over 48 slots: repeats across clusters
        self.topic_np = _cluster_index_np(rng, 500, 20)
        self.j_sann, self.p_sann = JIndex(*map(jnp.asarray, self.sann_np)), ClusterTweetIndex(
            *map(torch.from_numpy, self.sann_np))
        self.j_topic, self.p_topic = JIndex(*map(jnp.asarray, self.topic_np)), ClusterTweetIndex(
            *map(torch.from_numpy, self.topic_np))
        self.j_cfg = jann.SimClustersANNConfig(max_scan_clusters=4, max_top_tweets_per_cluster=M, max_num_results=8,
                                               max_tweet_candidate_age_hours=1000)
        self.p_cfg = ann.SimClustersANNConfig(max_scan_clusters=4, max_top_tweets_per_cluster=M, max_num_results=8,
                                              max_tweet_candidate_age_hours=1000)

        items = rng.normal(0, 1, (N_DENSE, D)).astype(np.float32)
        items[[30, 60]] = items[3]  # exact ties
        self.items = items / np.linalg.norm(items, axis=1, keepdims=True)
        self.users = self.items[:U].copy()  # the TwHIN user table, rows aligned with the graph's users

        # engagement graphs: the JAX package's ring appends, the same arrays for the port
        ev_u = rng.integers(0, U, 300).astype(np.int32)
        ev_t = rng.integers(0, T, 300).astype(np.int32)
        ev_ty = rng.integers(0, 6, 300).astype(np.int32)
        ev_ts = np.sort(rng.integers(0, 1000, 300)).astype(np.int32)
        left = ju.record_engagements(ju.init_graph(U, W), ev_u, ev_t, ev_ty, ev_ts)
        right = jg.record_right(jg.init_right_index(T, WR), ev_t, ev_u, ev_ts)
        self.j_left, self.j_right = left, right
        self.p_left = uteg.EngagementGraph.from_numpy(*map(np.asarray, left), device="cpu")
        self.p_right = graphjet.RightIndex.from_numpy(*map(np.asarray, right), device="cpu")
        self.video = rng.random(T) < 0.5

        # earlybird: a duplicated tweet id whose first slot is by an author outside the seeds
        F = len(jeb.DOC_FEATURES)
        tokens = np.full((DOCS, 4), PAD_ID, np.int32)
        tokens[:, :2] = rng.integers(1, 6, (DOCS, 2))
        author = (np.arange(DOCS) % 8).astype(np.int32)
        created = rng.integers(10, 900, DOCS).astype(np.int32)
        feats = rng.random((DOCS, F)).astype(np.float32)
        tids = (900 + np.arange(DOCS)).astype(np.int32)
        tids[11] = tids[2]  # slot 2's author is 2, slot 11's is 3
        author[DOCS - 1] = PAD_ID  # an empty slot
        self.eb_np = (tokens, author, created, feats, tids)
        self.j_eb = jeb.EarlybirdIndex(*map(jnp.asarray, self.eb_np), jnp.int32(DOCS - 1))
        self.p_eb = eb.EarlybirdIndex.from_numpy(*self.eb_np, DOCS - 1, device="cpu")

        clicks = np.stack([rng.integers(0, 12, 80), rng.integers(0, T, 80)], 1)
        self.clicks = clicks
        self.j_qig = jse.build_qig_table(clicks, T, 4)
        self.p_qig = se.build_qig_table(clicks, T, 4, device="cpu")

        self.engagers = {p: (rng.integers(0, U, 5).tolist(), rng.uniform(0.1, 1, 5).round(3).tolist())
                         for p in range(8)}
        self.similar = {q.user_id: (rng.integers(0, U, 6).tolist(), rng.uniform(0, 1, 6).round(3).tolist())
                        for q in QUERIES}
        self.eb_weights = {q.user_id: rng.uniform(0, 1, 8).round(3).tolist() for q in QUERIES}

    # per-side helpers -----------------------------------------------------
    def emb(self, side, clusters):
        ids, sc = _emb_np(clusters)
        return JEmb(jnp.asarray(ids), jnp.asarray(sc)) if side == "j" else SparseEmbedding(
            torch.from_numpy(ids), torch.from_numpy(sc))

    def vec(self, side, row):
        v = self.items[int(row) % N_DENSE]
        return jnp.asarray(v) if side == "j" else torch.from_numpy(v)


@functools.lru_cache(maxsize=None)
def world() -> World:
    return World()


def assert_same(got, want):
    assert [c.id for c in got] == [c.id for c in want]
    assert [c.source for c in got] == [c.source for c in want]
    if want:
        np.testing.assert_allclose([c.score for c in got], [c.score for c in want], rtol=RTOL, atol=ATOL)
    for g, w in zip(got, want):
        assert set(g.features) == set(w.features)
        for k in EXACT_FEATURES:
            if k in w.features:
                assert g.features[k] == w.features[k], k
        np.testing.assert_allclose(g.features.get("retrieval_score", 0.0), w.features.get("retrieval_score", 0.0),
                                   rtol=RTOL, atol=ATOL)


def both(make, queries=QUERIES, j_params=None, p_params=None):
    """Build the engine for each side (``make(side)``) and hold every
    query's candidates equal; some query must get candidates."""
    je, pe = make("j"), make("p")
    n = 0
    for q in queries:
        want = je.get(q, j_params if j_params is not None else JParams())
        got = pe.get(q, p_params if p_params is not None else Params())
        assert_same(got, want)
        n += len(want)
    assert n > 0, "no query got candidates"
    return je, pe


def _follows(q):
    return list(q.followed_authors), [1.0] * len(q.followed_authors)


def _source(q):
    return q.source_tweet_id if q.source_tweet_id is not None else q.recent_engagement_ids[0]


def test_simclusters_ann_engine():
    w = world()
    both(lambda s: (jse if s == "j" else se).SimClustersANNEngine(
        w.j_sann if s == "j" else w.p_sann, w.j_cfg if s == "j" else w.p_cfg,
        lambda q: w.emb(s, (q.user_id % C, (q.user_id + 3) % C, 1)), name="SimClustersInterestedIn"))


def test_diffusion_engine_on_a_built_diffusion_index():
    w = world()
    rng = np.random.default_rng(5)
    ii_ids = rng.integers(0, C, (U, 3)).astype(np.int32)
    ii_ids[0, 2] = PAD_ID
    ii_sc = rng.uniform(0.1, 1, (U, 3)).astype(np.float32)
    rt_t, rt_u = rng.integers(0, T, 120), rng.integers(0, U, 120)
    j_idx = jse.build_diffusion_index(JEmb(jnp.asarray(ii_ids), jnp.asarray(ii_sc)), rt_t, rt_u, C, M)
    p_idx = se.build_diffusion_index(SparseEmbedding(torch.from_numpy(ii_ids), torch.from_numpy(ii_sc)), rt_t, rt_u,
                                     C, M, device="cpu")
    for a, b in zip(p_idx, j_idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    both(lambda s: (jse if s == "j" else se).DiffusionEngine(
        j_idx if s == "j" else p_idx, w.j_cfg if s == "j" else w.p_cfg,
        lambda q: w.emb(s, (q.user_id % C, 2)), name="Diffusion"))


@pytest.mark.parametrize("k", [200, 17])
def test_twhin_ann_engine(k):
    w = world()
    both(lambda s: (jse if s == "j" else se).TwHINANNEngine(
        jnp.asarray(w.items) if s == "j" else torch.from_numpy(w.items), lambda q: w.vec(s, 3 * q.user_id), k=k,
        name="TwhinConsumerBased"))


def test_twhin_ann_engine_past_the_items_raises_on_both():
    w = world()
    for mod, items in ((jse, jnp.asarray(w.items[:50])), (se, torch.from_numpy(w.items[:50]))):
        with pytest.raises(ValueError):
            mod.TwHINANNEngine(items, lambda q: items[0], k=200).get(QUERIES[0], None)


def test_uteg_engine():
    w = world()
    both(lambda s: (jse if s == "j" else se).UTEGEngine(w.j_left if s == "j" else w.p_left, _follows, name="UTEG"))


def test_uag_engine_marks_promoted():
    w = world()
    both(lambda s: (jse if s == "j" else se).UAGEngine(w.j_left if s == "j" else w.p_left, _follows, name="UAG"))


def test_consumers_based_utg_engine():
    w = world()
    both(lambda s: (jse if s == "j" else se).ConsumersBasedUTGEngine(
        w.j_left if s == "j" else w.p_left, lambda q: w.similar[q.user_id], name="ConsumersBasedUserTweetGraph"))


def test_producer_based_utg_engine():
    w = world()
    both(lambda s: (jse if s == "j" else se).ProducerBasedUTGEngine(
        w.j_left if s == "j" else w.p_left, lambda p: w.engagers[p % 8],
        lambda q: (list(q.followed_authors)[:8], [1.0] * min(len(q.followed_authors), 8)), max_seeds=6,
        name="ProducerBasedUserTweetGraph"))


@pytest.mark.parametrize("video", [False, True])
def test_utg_engine(video):
    w = world()

    def make(s):
        mask = None if not video else (jnp.asarray(w.video) if s == "j" else torch.from_numpy(w.video))
        return (jse if s == "j" else se).UTGEngine(
            w.j_left if s == "j" else w.p_left, w.j_right if s == "j" else w.p_right, _source,
            candidate_mask=mask, name="UVGTweetBased" if video else "UTGTweetBased")

    both(make)


def test_twhin_collab_filter_engine():
    w = world()
    both(lambda s: (jse if s == "j" else se).TwhinCollabFilterEngine(
        jnp.asarray(w.users) if s == "j" else torch.from_numpy(w.users), w.j_left if s == "j" else w.p_left,
        lambda q: w.vec(s, q.user_id + 5), similar_users=6, name="TwhinCollabFilter"))


def test_qig_engine_and_table():
    w = world()
    for a, b in zip(w.p_qig, w.j_qig):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows = [int(t) for t in np.unique(w.clicks[:, 1])[:6]]
    qs = [Query(last_searched_tweet_id=t) for t in rows]
    both(lambda s: (jse if s == "j" else se).QIGEngine(
        *(w.j_qig if s == "j" else w.p_qig), lambda q: q.last_searched_tweet_id, min_score=0.3,
        name="QigSearchHistoryTweets"), queries=qs)


@pytest.mark.parametrize("source", [T + 5, -1, -(T + 3), T - 1, 0])
def test_qig_and_topic_rows_at_out_of_range_sources(source):
    """A source past the table reads JAX's clamped row, a negative one the
    wrapped (then clamped) row."""
    w = world()
    q = [Query(last_searched_tweet_id=source, topic_id=source)]
    both(lambda s: (jse if s == "j" else se).QIGEngine(
        *(w.j_qig if s == "j" else w.p_qig), lambda q: q.last_searched_tweet_id), queries=q)
    both(lambda s: (jse if s == "j" else se).TopicTweetEngine(
        w.j_topic if s == "j" else w.p_topic, lambda q: q.topic_id, name="PopularTopicTweets"), queries=q)


@pytest.mark.parametrize("kw", [dict(min_relevance=0.0), dict(min_relevance=0.4), dict(high_precision=True),
                                dict(allowed_ids=np.arange(500, 510))])
def test_topic_tweet_engine(kw):
    w = world()
    qs = [Query(topic_id=t) for t in range(C)]
    both(lambda s: (jse if s == "j" else se).TopicTweetEngine(
        w.j_topic if s == "j" else w.p_topic, lambda q: q.topic_id, name="SkitTopicTweets", **kw), queries=qs)


def test_unified_engine():
    w = world()

    def make(s):
        m = jse if s == "j" else se
        left, right = (w.j_left, w.j_right) if s == "j" else (w.p_left, w.p_right)
        qig = w.j_qig if s == "j" else w.p_qig
        return m.UnifiedEngine([m.UTGEngine(left, right, _source, name="UTG"),
                                m.QIGEngine(*qig, _source, name="QIG")], max_results=12, name="TweetBasedUnified")

    both(make)


def test_earlybird_engine():
    w = world()

    def make(s):
        m, eb_mod = (jse, jeb) if s == "j" else (se, eb)

        def query_fn(q):
            toks, follows = np.array([1, 3, PAD_ID, PAD_ID], np.int32), np.array(sorted(q.followed_authors), np.int32)
            if s == "j":
                return jeb.SearchQuery(tokens=jnp.asarray(toks), require_all=False, min_ts=jnp.int32(0),
                                       max_ts=jnp.int32(1000), followed_authors=jnp.asarray(follows))
            return eb.SearchQuery(tokens=torch.from_numpy(toks), require_all=False, min_ts=0, max_ts=1000,
                                  followed_authors=torch.from_numpy(follows))

        return m.EarlybirdEngine(w.j_eb if s == "j" else w.p_eb, query_fn, max_results=10)

    both(make)


@pytest.mark.parametrize("tf", [False, True])
def test_earlybird_model_based_engine(tf):
    """Tweet 902 sits at slot 2 (author 2) and slot 11 (author 3): user 1's
    seeds (5, 3, 7) retrieve it from slot 11, but its first slot's author is
    no seed, so it takes seed 0's weight (author 5's), as the all-zero
    argmax row does."""
    w = world()
    seeds = {1: [5, 3, 7], 6: [2, 3], 13: [3, 3, 1]}  # a repeated seed author: its first weight counts

    def make(s):
        m = jse if s == "j" else se
        fn = (lambda f: f[:, 0] * 2.0) if tf else (lambda f: f[:, 0])
        cls = m.EarlybirdTensorflowBasedEngine if tf else m.EarlybirdModelBasedEngine
        return cls(w.j_eb if s == "j" else w.p_eb,
                   lambda q: (seeds[q.user_id], w.eb_weights[q.user_id][: len(seeds[q.user_id])]), fn, max_results=9)

    both(make)


def _equality_first_match(values, keys):
    """The JAX engine's form: argmax over each row of the equality matrix."""
    return np.argmax((values[:, None] == keys[None, :]).astype(np.int32), axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_match_equals_the_equality_argmax(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, 300).astype(np.int32)  # many repeats
    values = np.concatenate([rng.integers(0, 60, 100), [PAD_ID, keys[0], keys[-1]]]).astype(np.int32)  # absent ids
    got = se.first_match(torch.from_numpy(values), torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, _equality_first_match(values, keys))


def test_author_adjustment_equals_the_equality_form():
    """Duplicated tweet ids (the first slot's author is no seed → seed 0),
    an author outside the seeds, a repeated seed, a PAD id (-inf)."""
    rng = np.random.default_rng(7)
    tweet_ids = rng.integers(0, 50, 200).astype(np.int32)
    author = rng.integers(0, 20, 200).astype(np.int32)
    seeds = np.array([4, 9, 4, 13], np.int32)
    weights = np.array([0.5, 0.25, 0.75, 1.0], np.float32)
    ids = np.concatenate([tweet_ids[rng.integers(0, 200, 60)], [PAD_ID, 77]]).astype(np.int32)
    pos = _equality_first_match(ids, tweet_ids)
    rows = _equality_first_match(author, seeds)
    want = np.where(ids != PAD_ID, weights[rows[pos]], -np.inf)
    got = se.author_adjustment(*map(torch.from_numpy, (ids, tweet_ids, author, seeds, weights))).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        se.author_adjustment(*map(torch.from_numpy, (ids, tweet_ids, author, seeds[:0], weights[:0])))


def test_trip_engine():
    w = world()
    index = {("TOP_GEO", c): [(1300 + 3 * c + j, 0.9 - 0.1 * j) for j in range(3)] for c in range(C)}
    index[("TOP_GEO", 2)].append((1300, 0.95))  # a repeat across clusters keeps its best score
    both(lambda s: (jse if s == "j" else se).TripEngine(
        {"m": lambda uid: w.emb(s, (uid % C, (uid + 1) % C, 2))}, index, "m", name="Trip"))


def test_two_tower_engine_maps_rows_through_item_ids():
    w = world()
    item_ids = (5000 + np.arange(N_DENSE)[::-1]).astype(np.int64)
    both(lambda s: (jse if s == "j" else se).TwoTowerEngine(
        lambda uid: w.items[uid % N_DENSE], jnp.asarray(w.items) if s == "j" else torch.from_numpy(w.items),
        item_ids=item_ids, max_results=50))


def test_lookup_engine_routes_by_param_and_caches():
    w = world()
    clock = {"t": 0.0}

    def make(s):
        m = jse if s == "j" else se
        idx, cfg = (w.j_sann, w.j_cfg) if s == "j" else (w.p_sann, w.p_cfg)
        engines = {"v1": m.SimClustersANNEngine(idx, cfg, lambda q: w.emb(s, (q.user_id % C,))),
                   "v2": m.SimClustersANNEngine(idx, cfg, lambda q: w.emb(s, (1, 5)))}
        return m.LookupEngine(engines, "v1", cache_ttl_s=10.0, now_fn=lambda: clock["t"])

    je, pe = both(make)  # default model v1, cached
    both(lambda s: je if s == "j" else pe, j_params=JParams({jse.LOOKUP_MODEL_ID: "v2"}),
         p_params=Params({se.LOOKUP_MODEL_ID: "v2"}))
    assert pe.models() == je.models() == ["v1", "v2"]
    clock["t"] = 100.0  # expired: served again
    both(lambda s: je if s == "j" else pe)
    with pytest.raises(KeyError):
        pe.get(QUERIES[0], Params({se.LOOKUP_MODEL_ID: "v9"}))
