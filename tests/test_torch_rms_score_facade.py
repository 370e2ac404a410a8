"""RMS, the score facade, the RSX score stores and the SimClusters candidate
sources of the port against the JAX package's on the same numpy inputs.

Multigets and cluster rankings are compared exactly (ids, and scores bit for
bit: both read the same f32 rows); pairwise scores within rtol 1e-5 / atol
1e-6 (the port sums an embedding's K×K matches in its own order); the
wrapper source's candidates id for id, scores within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.core.config import Params as JParams
from the_algorithm_tpu.features import representation_scorer as jrs
from the_algorithm_tpu.ops import retrieval as jret
from the_algorithm_tpu.ops.retrieval import ClusterTweetIndex as JIndex
from the_algorithm_tpu.ops.sparse import SparseEmbedding as JEmb
from the_algorithm_tpu.simclusters import ann as jann
from the_algorithm_tpu.simclusters import candidate_source as jcs
from the_algorithm_tpu.simclusters import representation_manager as jrm
from the_algorithm_tpu.simclusters import score_facade as jsf
from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.core.metrics import StatsReceiver
from the_algorithm_tpu_torch.features import representation_scorer as rs
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.simclusters import ann
from the_algorithm_tpu_torch.simclusters import candidate_source as cs
from the_algorithm_tpu_torch.simclusters import representation_manager as rm
from the_algorithm_tpu_torch.simclusters import score_facade as sf

CPU = torch.device("cpu")
USER_II = rm.EmbeddingId(rm.EmbeddingKind.FAV_BASED_USER_INTERESTED_IN, rm.EntityKind.USER)
TWEET_EMB = rm.EmbeddingId(rm.EmbeddingKind.LOG_FAV_BASED_TWEET, rm.EntityKind.TWEET)
J_USER_II = jrm.EmbeddingId(jrm.EmbeddingKind.FAV_BASED_USER_INTERESTED_IN, jrm.EntityKind.USER)
J_TWEET_EMB = jrm.EmbeddingId(jrm.EmbeddingKind.LOG_FAV_BASED_TWEET, jrm.EntityKind.TWEET)
RTOL, ATOL = 1e-5, 1e-6


def make_store(n=10, k=4, seed=0, ids_start=100, C=64):
    """Entity ids and [n, k] rows: distinct clusters a row, a PAD tail on
    every third row."""
    rng = np.random.default_rng(seed)
    cids = np.stack([rng.choice(C, k, replace=False) for _ in range(n)]).astype(np.int32)
    scores = rng.uniform(0.1, 1.0, size=(n, k)).astype(np.float32)
    cids[::3, -1], scores[::3, -1] = PAD_ID, 0.0
    return list(range(ids_start, ids_start + n)), cids, scores


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    np.testing.assert_array_equal(_np(a.ids), _np(b.ids))
    np.testing.assert_array_equal(_np(a.scores), _np(b.scores))


@pytest.mark.parametrize("k", [4, 5])  # 16-byte rows (the TMA ring) and 20-byte rows (the word kernel)
def test_table_store_multiget_matches_jax(k):
    entity_ids, cids, scores = make_store(k=k)
    got = rm.store_from_pairs(entity_ids, cids, scores, device=CPU)
    want = jrm.store_from_pairs(entity_ids, cids, scores)
    for ids in ([102, 100], [100, 999, 105, 999], [109]):
        _same(got.multiget(np.asarray(ids)), want.multiget(np.asarray(ids)))
    out = got.multiget(np.asarray([100, 999]))
    assert (out.ids[1] == PAD_ID).all() and (out.scores[1] == 0).all()
    assert got.device == CPU


def test_cached_store_hits_misses_ttl_and_lru_as_jax():
    entity_ids, cids, scores = make_store()
    calls, jcalls = [], []

    class Counting:
        device = CPU

        def __init__(self, inner, log):
            self.inner, self.log = inner, log

        def multiget(self, ids):
            self.log.append(list(np.asarray(ids)))
            return self.inner.multiget(ids)

    t = [0.0]
    stats = StatsReceiver()
    cache = rm.CachedEmbeddingStore(Counting(rm.store_from_pairs(entity_ids, cids, scores, device=CPU), calls),
                                    ttl_s=10.0, clock=lambda: t[0], stats=stats)
    jcache = jrm.CachedEmbeddingStore(Counting(jrm.store_from_pairs(entity_ids, cids, scores), jcalls),
                                      ttl_s=10.0, clock=lambda: t[0])
    for when, ids in ((0.0, [100, 101]), (1.0, [101, 100, 104]), (11.5, [100, 999]), (12.0, [999, 104])):
        t[0] = when
        _same(cache.multiget(np.asarray(ids)), jcache.multiget(np.asarray(ids)))
    assert calls == jcalls == [[100, 101], [104], [100, 999], [104]]
    counters = stats.counters()
    assert counters["rms_cache/hits"] == 3 and counters["rms_cache/misses"] == 6
    lru = rm.CachedEmbeddingStore(rm.store_from_pairs(entity_ids, cids, scores, device=CPU), max_items=2,
                                  clock=lambda: 0.0)
    lru.multiget(np.asarray([100, 101, 102]))
    assert list(lru._cache) == [101, 102]


def test_representation_manager_registry_and_get():
    entity_ids, cids, scores = make_store()
    rms = rm.RepresentationManager()
    rms.register(USER_II, rm.store_from_pairs(entity_ids, cids, scores, device=CPU))
    assert rms.has(USER_II) and not rms.has(TWEET_EMB)
    emb = rms.get(USER_II, 103)
    np.testing.assert_array_equal(emb.ids.numpy(), cids[3])
    with pytest.raises(KeyError):
        rms.get(TWEET_EMB, 1)


def _facades(n=40, k=6):
    a_ids, a_c, a_s = make_store(n=n, k=k, seed=1, ids_start=100, C=16)
    b_ids, b_c, b_s = make_store(n=n, k=k, seed=2, ids_start=200, C=16)
    rms, jrms_ = rm.RepresentationManager(), jrm.RepresentationManager()
    rms.register(USER_II, rm.store_from_pairs(a_ids, a_c, a_s, device=CPU))
    rms.register(TWEET_EMB, rm.store_from_pairs(b_ids, b_c, b_s, device=CPU))
    jrms_.register(J_USER_II, jrm.store_from_pairs(a_ids, a_c, a_s))
    jrms_.register(J_TWEET_EMB, jrm.store_from_pairs(b_ids, b_c, b_s))
    rng = np.random.default_rng(3)
    pairs = (rng.integers(100, 100 + n + 2, 64), rng.integers(200, 200 + n + 2, 64))  # a few misses
    return sf.ScoreFacadeStore(rms), jsf.ScoreFacadeStore(jrms_), pairs


@pytest.mark.parametrize("algorithm", list(sf.PAIR_ALGORITHMS))
def test_pair_scores_match_jax(algorithm):
    facade, jfacade, (a, b) = _facades()
    assert list(sf.PAIR_ALGORITHMS) == list(jsf.PAIR_ALGORITHMS)
    got = facade.pair_scores(algorithm, USER_II, a, TWEET_EMB, b)
    want = jfacade.pair_scores(algorithm, J_USER_II, a, J_TWEET_EMB, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    single = facade.get(sf.PairScoreId(algorithm, USER_II, int(a[0]), TWEET_EMB, int(b[0])))
    jsingle = jfacade.get(jsf.PairScoreId(algorithm, J_USER_II, int(a[0]), J_TWEET_EMB, int(b[0])))
    np.testing.assert_allclose(single, jsingle, rtol=RTOL, atol=ATOL)


def test_weighted_sum_aggregate_matches_jax():
    facade, jfacade, (a, b) = _facades()
    terms = (("PairEmbeddingDotProduct", 0.3), ("PairEmbeddingCosineSimilarity", 0.7),
             ("PairEmbeddingManhattanDistance", -0.1))
    facade.register_aggregate(sf.WeightedSumSpec("blend", terms))
    jfacade.register_aggregate(jsf.WeightedSumSpec("blend", terms))
    got = facade.aggregate_scores("blend", USER_II, a, TWEET_EMB, b)
    want = jfacade.aggregate_scores("blend", J_USER_II, a, J_TWEET_EMB, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(KeyError):
        facade.register_aggregate(sf.WeightedSumSpec("bad", (("NoSuchAlgorithm", 1.0),)))


def _pairs(seed, n=32, k=8, C=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        ids = np.stack([rng.choice(C, k, replace=False) for _ in range(n)]).astype(np.int32)
        sc = rng.uniform(0.1, 1.0, (n, k)).astype(np.float32)
        ids[rng.random((n, k)) < 0.2] = PAD_ID
        sc[ids == PAD_ID] = 0.0
        out.append((ids, sc))
    return out


@pytest.mark.parametrize("kind", ["dot", "cosine", "log_cosine", "exp_cosine", "jaccard", "euclidean", "manhattan"])
def test_pair_score_store_matches_jax(kind):
    (ai, as_), (bi, bs) = _pairs(4)
    got = rs.PairScoreStore(kind)(SparseEmbedding(*map(torch.from_numpy, (ai, as_))),
                                  SparseEmbedding(*map(torch.from_numpy, (bi, bs))))
    want = jax.vmap(jrs.PairScoreStore(kind))(JEmb(jnp.asarray(ai), jnp.asarray(as_)), JEmb(jnp.asarray(bi),
                                                                                             jnp.asarray(bs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_weighted_sum_score_matches_jax():
    rng = np.random.default_rng(6)
    scores = {k: rng.normal(size=16).astype(np.float32) for k in ("dot", "cosine", "jaccard")}
    weights = {"cosine": 0.5, "dot": 2.0, "jaccard": -1.25}
    got = rs.weighted_sum_score({k: torch.from_numpy(v) for k, v in scores.items()}, weights)
    want = jrs.weighted_sum_score({k: jnp.asarray(v) for k, v in scores.items()}, weights)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ranked_inputs(seed=7, R=24, K=12, C=32):
    """Embeddings with PAD slots and tied scores, cluster norms and fills."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(C, K, replace=False) for _ in range(R)]).astype(np.int32)
    sc = rng.choice(np.float32([0.25, 0.5, 0.75, 1.0]), (R, K))
    ids[rng.random((R, K)) < 0.25] = PAD_ID
    sc[ids == PAD_ID] = 0.0
    norms = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), C)
    fill = rng.integers(0, 5, C).astype(np.int32)
    return ids, sc, norms, fill


@pytest.mark.parametrize("strategy", list(cs.ClusterRankStrategy))
@pytest.mark.parametrize("top_n", [5, 12, 20])
def test_rank_clusters_matches_jax(strategy, top_n):
    ids, sc, norms, fill = _ranked_inputs()
    jstrategy = jcs.ClusterRankStrategy(strategy.value)
    got = cs.rank_clusters(SparseEmbedding(torch.from_numpy(ids), torch.from_numpy(sc)), top_n, strategy,
                           cluster_norms=torch.from_numpy(norms), index_fill=torch.from_numpy(fill))
    for r in range(ids.shape[0]):  # JAX ranks one embedding a call
        want = jcs.rank_clusters(JEmb(jnp.asarray(ids[r]), jnp.asarray(sc[r])), top_n, jstrategy,
                                 cluster_norms=jnp.asarray(norms), index_fill=jnp.asarray(fill))
        np.testing.assert_array_equal(got.ids[r].numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.scores[r].numpy(), np.asarray(want.scores))


def _index(seed, C, M, T):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, T, size=(C, M)).astype(np.int32), rng.uniform(0.1, 1.0, size=(C, M)).astype(np.float32),
            np.zeros((C, M), np.int32))


def test_index_fill_counts_matches_jax():
    ids, sc, ts = _index(8, 16, 8, 50)
    ids[np.random.default_rng(9).random(ids.shape) < 0.4] = PAD_ID
    got = cs.index_fill_counts(ClusterTweetIndex(*map(torch.from_numpy, (ids, sc, ts))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcs.index_fill_counts(JIndex(*map(jnp.asarray, (ids, sc,
                                                                                                               ts))))))


def _wrappers(strategy, heavy=None, cached=False, seed=0, C=32, M=8, T=100, X=10):
    index_np = _index(seed, C, M, T)
    entity_ids, cids, scores = make_store(n=6, k=6, C=C)
    rms, jrms_ = rm.RepresentationManager(), jrm.RepresentationManager()
    rms.register(USER_II, rm.store_from_pairs(entity_ids, cids, scores, cached=cached, device=CPU))
    jrms_.register(J_USER_II, jrm.store_from_pairs(entity_ids, cids, scores, cached=cached))
    ann_cfg = dict(max_scan_clusters=4, max_top_tweets_per_cluster=M, max_num_results=X)
    index = ClusterTweetIndex(*map(torch.from_numpy, index_np))
    src = cs.SimClustersANNWrapperCandidateSource(
        rms, index, cs.SimClustersANNWrapperConfig(
            embedding=USER_II, ann_config=ann.SimClustersANNConfig(**ann_cfg), cluster_rank_strategy=strategy,
            enable_heavy_ranker=heavy is not None), heavy_ranker=heavy)
    jsrc = jcs.SimClustersANNWrapperCandidateSource(
        jrms_, JIndex(*map(jnp.asarray, index_np)), jcs.SimClustersANNWrapperConfig(
            embedding=J_USER_II, ann_config=jann.SimClustersANNConfig(**ann_cfg),
            cluster_rank_strategy=jcs.ClusterRankStrategy(strategy.value), enable_heavy_ranker=heavy is not None),
        heavy_ranker=heavy)
    return src, jsrc, rms, index


@pytest.mark.parametrize("strategy", [cs.ClusterRankStrategy.BY_SCORE, cs.ClusterRankStrategy.BY_LOG_SCORE,
                                      cs.ClusterRankStrategy.BY_INDEX_POPULARITY])
def test_wrapper_candidate_source_matches_jax(strategy):
    src, jsrc, rms, index = _wrappers(strategy, cached=True)
    for user in range(100, 106):
        got = src.get({"user_id": user}, Params())
        want = jsrc.get({"user_id": user}, JParams())
        assert [c.id for c in got] == [c.id for c in want] and got
        np.testing.assert_allclose([c.score for c in got], [c.score for c in want], rtol=RTOL)
        assert all(c.source == "simclusters_ann_wrapper" for c in got)
        # the same as the SANN path over the RMS row, ranked
        emb = rms.get(USER_II, user)
        ranked = cs.rank_clusters(emb, 4, strategy, index_fill=cs.index_fill_counts(index))
        ids, _ = ann.get_tweet_candidates(index, ranked, src.config.ann_config)
        assert [int(t) for t in ids if t != PAD_ID] == [c.id for c in got]


def test_wrapper_heavy_ranker_reorders_as_jax():
    def invert(_query, ids, scores):
        return -scores

    src, jsrc, _, _ = _wrappers(cs.ClusterRankStrategy.BY_SCORE, heavy=invert, seed=1, C=16, T=50, X=8)
    for user in (100, 101, 104):
        got = src.get({"user_id": user}, Params())
        want = jsrc.get({"user_id": user}, JParams())
        assert [c.id for c in got] == [c.id for c in want]
        np.testing.assert_allclose([c.score for c in got], [c.score for c in want], rtol=RTOL)
        assert [c.score for c in got] == sorted((c.score for c in got), reverse=True)


def test_approximate_cosine_similarity_batch_matches_jax():
    ids, sc, ts = _index(10, 64, 16, 300)
    ts = np.random.default_rng(11).integers(0, 100, ts.shape).astype(np.int32)
    (qi, qs), _ = _pairs(12, n=16, k=10, C=64)
    kw = dict(max_results=24, algorithm=retrieval.ScoringAlgorithm.LOG_COSINE, min_score=0.01, earliest_ts=10,
              latest_ts=90)
    got = retrieval.approximate_cosine_similarity_batch(ClusterTweetIndex(*map(torch.from_numpy, (ids, sc, ts))),
                                                        SparseEmbedding(*map(torch.from_numpy, (qi, qs))), **kw)
    want = jax.jit(lambda index, src: jret.approximate_cosine_similarity_batch(
        index, src, **dict(kw, algorithm=jret.ScoringAlgorithm.LOG_COSINE)))(
        JIndex(*map(jnp.asarray, (ids, sc, ts))), JEmb(jnp.asarray(qi), jnp.asarray(qs)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL)
