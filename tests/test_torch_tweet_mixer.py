"""The port's tweet-mixer (the_algorithm_tpu_torch/mixers/{candidate_pipeline_catalog,
tweet_mixer_products,tweet_mixer,cr_mixer}.py and pipeline/component.py)
against the JAX package's.

The 63-spec table is compared row by row (name, family, signals, needs,
default gate, param). Both catalogs are built over one seeded world (every
store the table names, on the engine tests' world) and routed and run for
the same queries: every product's blended ids equal JAX's in order, scores
at rtol 1e-5. The host blenders and the fan-out run on stub engines.
"""

import dataclasses
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_similarity_engines import C, EXACT_FEATURES, N_DENSE, PAD_ID, World, _cluster_index_np

from the_algorithm_tpu.core.config import Params as JParams
from the_algorithm_tpu.mixers import candidate_pipeline_catalog as jcat
from the_algorithm_tpu.mixers import cr_mixer as jcr
from the_algorithm_tpu.mixers import tweet_mixer as jtm
from the_algorithm_tpu.mixers import tweet_mixer_products as jtmp
from the_algorithm_tpu.ops.retrieval import ClusterTweetIndex as JIndex
from the_algorithm_tpu.pipeline import component as jcomp
from the_algorithm_tpu.search import earlybird as jeb
from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.data.tweet_mixer_world import Query
from the_algorithm_tpu_torch.mixers import candidate_pipeline_catalog as cat
from the_algorithm_tpu_torch.mixers import cr_mixer as cr
from the_algorithm_tpu_torch.mixers import tweet_mixer as tm
from the_algorithm_tpu_torch.mixers import tweet_mixer_products as tmp
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.pipeline import component as comp
from the_algorithm_tpu_torch.search import earlybird as eb

RTOL, ATOL = 1e-5, 1e-6
QUERIES = [
    Query(user_id=1, followed_authors=(2, 3, 5), recent_engagement_ids=(7, 11, 20, 33)),
    Query(user_id=6, followed_authors=(0, 4), recent_engagement_ids=(20, 3), source_tweet_id=9, topic_id=2,
          last_searched_tweet_id=int(np.int32(41))),
    Query(user_id=13, followed_authors=(), recent_engagement_ids=(5,), geo_id=1, trend_id=0, language_code="en",
          country_code="us", event_id=3, interest_topic_ids=(0, 1, 4), pinned_tweet_id=12),
    Query(user_id=None, followed_authors=(), recent_engagement_ids=(), source_tweet_id=7, geo_id=4, trend_id=1,
          topic_id=5),
]


def _cluster(side, arrays):
    return JIndex(*map(jnp.asarray, arrays)) if side == "j" else ClusterTweetIndex(*map(torch.from_numpy, arrays))


def _dense(side, a):
    return jnp.asarray(a) if side == "j" else torch.from_numpy(a)


def source_world(w: World, side: str):
    """Every store of the table for one side, the same data for both."""
    j = side == "j"
    m_cat = jcat if j else cat
    rng = np.random.default_rng(11)
    clusters = {name: _cluster_index_np(rng, base, 40) for name, base in (
        ("cold", 300), ("promoted", 400), ("certo", 600), ("geo", 700), ("trend", 800), ("events", 900),
        ("grok", 1000), ("control", 1100))}
    dense = {name: np.roll(w.items, k, axis=0) for k, name in enumerate(
        ("media", "evergreen", "content", "clip_long", "clip_short", "semantic", "evergreen_video",
         "cross_border", "tier_two"), start=1)}
    items = w.items

    def query_fn(q):
        toks, follows = np.array([1, 3, PAD_ID, PAD_ID], np.int32), np.array(sorted(q.followed_authors), np.int32)
        if j:
            return jeb.SearchQuery(tokens=jnp.asarray(toks), require_all=False, min_ts=jnp.int32(0),
                                   max_ts=jnp.int32(1000), followed_authors=jnp.asarray(follows))
        return eb.SearchQuery(tokens=torch.from_numpy(toks), require_all=False, min_ts=0, max_ts=1000,
                              followed_authors=torch.from_numpy(follows))

    sann, cfg = (w.j_sann, w.j_cfg) if j else (w.p_sann, w.p_cfg)
    se_mod = jcat.se if j else cat.se
    return m_cat.SourceWorld(
        sann_index=sann, sann_config=cfg,
        interested_in_fn=lambda q: w.emb(side, (q.user_id % C, 1)),
        tweet_embedding_fn=lambda t: w.emb(side, (int(t) % C,)),
        producer_embedding_fn=lambda q: w.emb(side, (2, q.user_id % C)),
        cold_index=_cluster(side, clusters["cold"]), promoted_creator_index=_cluster(side, clusters["promoted"]),
        twhin_items=_dense(side, items), twhin_rebuild_items=_dense(side, dense["evergreen"]),
        twhin_user_vec_fn=lambda q: w.vec(side, q.user_id), twhin_tweet_vec_fn=lambda t: w.vec(side, int(t) + 1),
        dr_tweet_items=_dense(side, items), dr_media_items=_dense(side, dense["media"]),
        dr_evergreen_items=_dense(side, dense["evergreen"]),
        dr_user_vec_fn=lambda q: w.vec(side, 2 * q.user_id), dr_tweet_vec_fn=lambda t: w.vec(side, int(t) + 3),
        uteg_graph=w.j_left if j else w.p_left, ad_graph=w.j_left if j else w.p_left,
        utg_left=w.j_left if j else w.p_left, utg_right=w.j_right if j else w.p_right,
        video_mask=_dense(side, w.video),
        topic_index=w.j_topic if j else w.p_topic, certo_topic_index=_cluster(side, clusters["certo"]),
        geo_index=_cluster(side, clusters["geo"]), trend_index=_cluster(side, clusters["trend"]),
        qig_ids=(w.j_qig if j else w.p_qig)[0], qig_scores=(w.j_qig if j else w.p_qig)[1],
        diffusion_index=_cluster(side, clusters["promoted"]),
        earlybird_index=w.j_eb if j else w.p_eb, earlybird_query_fn=query_fn,
        content_ann_items=_dense(side, dense["content"]), content_tweet_vec_fn=lambda t: w.vec(side, int(t) + 5),
        clip_long_items=_dense(side, dense["clip_long"]), clip_short_items=_dense(side, dense["clip_short"]),
        semantic_video_items=_dense(side, dense["semantic"]),
        evergreen_video_items=_dense(side, dense["evergreen_video"]),
        dr_cross_border_items=_dense(side, dense["cross_border"]), dr_tier_two_items=_dense(side, dense["tier_two"]),
        events_index=_cluster(side, clusters["events"]), pop_grok_topic_index=_cluster(side, clusters["grok"]),
        control_ai_topic_index=_cluster(side, clusters["control"]),
        haplolite_store={"us": [(1201, 0.9), (1202, 0.5)]},
        video_tweet_ids=np.asarray(clusters["trend"][0][0, :3], np.int32),
        curated_tls_authors={"en": [2, 5]},
        pinned_tweet_author_fn=lambda t: int(t) % 8,
        producer_embedding_by_id_fn=lambda a: w.emb(side, (int(a) % C,)),
        twhin_user_items=_dense(side, w.users),
        similar_consumers_fn=lambda q: w.similar[q.user_id],
        producer_engagers_fn=lambda p: w.engagers[int(p) % 8],
        trip_embedding_stores={"model_a": lambda uid: w.emb(side, (uid % C, 1))},
        trip_index={("TOP_GEO", c): [(1300 + c, 0.9 - 0.01 * c)] for c in range(C)} | {
            ("TOP_DOMAIN", 1): [(1350, 0.7), (1351, 0.6)]},
        trip_model_id="model_a",
        two_tower_user_fn=lambda uid: w.items[uid % N_DENSE], two_tower_items=_dense(side, items),
        two_tower_item_ids=np.arange(N_DENSE) + 7000,
        eb_seeds_fn=lambda q: ([2, 3, 5], [1.0, 0.5, 0.25]),
        eb_model_score_fn=lambda f: f[:, 0],
        eb_tf_score_fn=lambda f: f[:, 0] * 2.0,
        lookup_engines={"v1": se_mod.SimClustersANNEngine(sann, cfg, lambda q: w.emb(side, (0, 1)))},
        lookup_default_model="v1",
    )


@functools.lru_cache(maxsize=None)
def worlds():
    w = World()
    jw, pw = source_world(w, "j"), source_world(w, "p")
    return w, jw, pw, jcat.build_catalog(jw), cat.build_catalog(pw)


def assert_same(got, want):
    assert [c.id for c in got] == [c.id for c in want]
    assert [c.source for c in got] == [c.source for c in want]
    if want:
        np.testing.assert_allclose([c.score or 0.0 for c in got], [c.score or 0.0 for c in want], rtol=RTOL,
                                   atol=ATOL)
    for g, w in zip(got, want):
        for k in EXACT_FEATURES:
            assert g.features.get(k) == w.features.get(k), k


def _spec_row(s):
    return (s.name, s.family, tuple(s.signals), tuple(s.needs), s.enabled_by_default, s.param.name, s.param.default)


def test_catalog_table_equals_jax():
    want = [_spec_row(s) for s in jcat.catalog_specs()]
    got = [_spec_row(s) for s in cat.catalog_specs()]
    assert len(got) == 63
    assert got == want


def test_source_world_and_signal_checks_equal_jax():
    assert [f.name for f in dataclasses.fields(cat.SourceWorld)] == [f.name for f in dataclasses.fields(
        jcat.SourceWorld)]
    assert list(cat.SIGNAL_CHECKS) == list(jcat.SIGNAL_CHECKS)
    for q in QUERIES:
        for name in cat.SIGNAL_CHECKS:
            assert cat.SIGNAL_CHECKS[name](q) == jcat.SIGNAL_CHECKS[name](q), name


def test_every_spec_builds_on_the_full_world():
    *_, jc, pc = worlds()
    assert [s.name for s, _ in pc] == [s.name for s, _ in jc]
    assert len(pc) == 63
    assert [p.name for _, p in pc] == [p.name for _, p in jc]


@pytest.mark.parametrize("missing", [("topic_index", "qig_ids"), ("sann_index",), ("utg_right", "earlybird_index"),
                                     ("two_tower_items", "trip_index", "lookup_engines")])
def test_build_catalog_skips_specs_whose_stores_are_missing(missing):
    _, jw, pw, *_ = worlds()
    none = {f: None for f in missing}
    want = [s.name for s, _ in jcat.build_catalog(dataclasses.replace(jw, **none))]
    got = [s.name for s, _ in cat.build_catalog(dataclasses.replace(pw, **none))]
    assert got == want and len(got) < 63


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_enabled_pipelines_route_and_gate_as_jax(qi):
    *_, jc, pc = worlds()
    q = QUERIES[qi]
    names = lambda pipes: [p.name for p in pipes]  # noqa: E731
    assert names(cat.enabled_pipelines(pc, q, Params())) == names(jcat.enabled_pipelines(jc, q, JParams()))
    # gates: default-off specs switched on, default-on ones off
    flip = [s for s, _ in pc][qi::3]
    jflip = {jcat.Param(s.param.name, s.param.default): not s.enabled_by_default for s in flip}
    pflip = {s.param: not s.enabled_by_default for s in flip}
    got = names(cat.enabled_pipelines(pc, q, Params(pflip)))
    assert got == names(jcat.enabled_pipelines(jc, q, JParams(jflip)))
    assert got != names(cat.enabled_pipelines(pc, q, Params()))


@pytest.mark.parametrize("product", list(tmp.TweetMixerProduct), ids=lambda p: p.name)
def test_run_product_equals_jax(product):
    *_, jc, pc = worlds()
    jp = jtmp.TweetMixerProduct(product.value)
    n = 0
    for q in QUERIES:
        want = jtmp.run_product(jc, jp, q)
        got = tmp.run_product(pc, product, q)
        assert [p.name for p in tmp.product_pipelines(pc, product, q, Params())] == [
            p.name for p in jtmp.product_pipelines(jc, jp, q, JParams())]
        assert_same(got, want)
        assert len(got) <= tmp.PRODUCT_SPECS[product].max_results
        n += len(want)
    assert n > 0


def test_product_specs_equal_jax():
    assert [p.value for p in tmp.TweetMixerProduct] == [p.value for p in jtmp.TweetMixerProduct]
    for p in tmp.TweetMixerProduct:
        a, b = tmp.PRODUCT_SPECS[p], jtmp.PRODUCT_SPECS[jtmp.TweetMixerProduct(p.value)]
        assert (a.pipeline_names, a.max_results, a.needs_user) == (b.pipeline_names, b.max_results, b.needs_user)


def test_home_routes_twenty_pipelines_for_a_user_with_every_signal():
    *_, pc = worlds()
    pipes = tmp.product_pipelines(pc, tmp.TweetMixerProduct.HOME_RECOMMENDED_TWEETS, QUERIES[0], Params())
    assert len(pipes) == 20


# -- host blending, the mixer's cache and fan-out, cr-mixer ----------------------------------------


def _lists(mod, seed, engines=4, n=12):
    rng = np.random.default_rng(seed)
    return [[mod.Candidate(id=int(i), score=float(s), source=f"e{e}")
             for i, s in zip(rng.integers(0, 30, n), rng.uniform(0, 1, n))] for e in range(engines)]


@pytest.mark.parametrize("seed,max_results", [(0, 10), (1, 25), (2, 200)])
def test_interleave_blend_equals_jax(seed, max_results):
    got = tm.interleave_blend(_lists(comp, seed), max_results)
    want = jtm.interleave_blend(_lists(jcomp, seed), max_results)
    assert [(c.id, c.source) for c in got] == [(c.id, c.source) for c in want]


class _Stub:
    """An engine that returns fixed candidates after a delay; records calls."""

    def __init__(self, mod, cands, delay, fail=False):
        self.mod, self.cands, self.delay, self.fail, self.calls = mod, cands, delay, fail, 0

    @property
    def name(self):
        return "stub"

    def get(self, query, params):
        self.calls += 1
        time.sleep(self.delay)
        if self.fail:
            raise RuntimeError("engine down")
        return [self.mod.Candidate(c.id, dict(c.features), c.score, c.source) for c in self.cands]


def _stubs(mod, seed):
    lists = _lists(mod, seed, engines=6)
    # later engines finish first: the fan-out must keep engine order
    return [_Stub(mod, cands, 0.002 * (6 - e), fail=e == 2) for e, cands in enumerate(lists)]


@pytest.mark.parametrize("concurrency", [1, 8])
def test_tweet_mixer_fan_out_keeps_engine_order(concurrency):
    mixer = tm.TweetMixer(_stubs(comp, 3), max_results=40, max_concurrency=concurrency)
    jmixer = jtm.TweetMixer(_stubs(jcomp, 3), max_results=40, max_concurrency=concurrency)
    try:
        got, want = mixer.get_candidates(QUERIES[0]), jmixer.get_candidates(QUERIES[0])
        assert [(c.id, c.source) for c in got] == [(c.id, c.source) for c in want]
        assert len(got) > 20  # 30 ids over the five engines that answer
    finally:
        mixer.close()


def test_tweet_mixer_cache_serves_within_its_ttl(monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr(tm.time, "monotonic", lambda: clock["t"])
    stubs = _stubs(comp, 4)
    mixer = tm.TweetMixer(stubs, max_results=20, cache_ttl_s=60.0, max_concurrency=1)
    source = tm.TweetMixerSource(mixer)
    first = source.get(QUERIES[0], Params())
    clock["t"] = 150.0
    assert [c.id for c in source.get(QUERIES[0], Params())] == [c.id for c in first]
    assert all(s.calls == 1 for s in stubs)  # a hit runs no engine
    source.get(QUERIES[1], Params())  # another user: its own key
    assert all(s.calls == 2 for s in stubs)
    clock["t"] = 161.0  # expired
    source.get(QUERIES[0], Params())
    assert all(s.calls == 3 for s in stubs)
    assert mixer.get_candidates(QUERIES[0]) and all(s.calls == 4 for s in stubs)  # no key: no cache


def test_cr_mixer_router_equals_jax():
    def signals(mod):
        return [mod.SourceSignal(mod.SignalKind(k), e, w) for k, e, w in (
            ("tweet_engagement", 7, 0.5), ("tweet_engagement", 9, 0.9), ("producer", 3, 1.0),
            ("consumer", 1, 1.0), ("tweet_engagement", 11, 0.7))]

    def specs(mod):
        return [mod.EngineSpec("tweet", mod.SignalKind.TWEET_ENGAGEMENT, None, max_signals=2),
                mod.EngineSpec("producer", mod.SignalKind.PRODUCER, None),
                mod.EngineSpec("consumer", mod.SignalKind.CONSUMER, None)]

    got = [(s.name, sig.entity_id) for s, sig in cr.route_signals(signals(cr), specs(cr))]
    want = [(s.name, sig.entity_id) for s, sig in jcr.route_signals(signals(jcr), specs(jcr))]
    assert got == want == [("tweet", 9), ("tweet", 11), ("producer", 3), ("consumer", 1)]


@pytest.mark.parametrize("blender", ["weighted", "rank_decay", "interleave"])
def test_cr_candidate_generator_blends_as_jax(blender):
    def run(mod, comp_mod):
        lists = _lists(comp_mod, 9, engines=3)
        engine = lambda i: (lambda sig, params: [c for c in lists[i] if c.id % 3 != sig.entity_id % 3])  # noqa
        failing = lambda sig, params: (_ for _ in ()).throw(RuntimeError("down"))  # noqa: E731
        specs = [mod.EngineSpec("a", mod.SignalKind.TWEET_ENGAGEMENT, engine(0), weight=2.0),
                 mod.EngineSpec("b", mod.SignalKind.PRODUCER, engine(1), weight=0.5),
                 mod.EngineSpec("c", mod.SignalKind.CONSUMER, engine(2)),
                 mod.EngineSpec("down", mod.SignalKind.CONSUMER, failing)]
        sig = [mod.SourceSignal(mod.SignalKind.TWEET_ENGAGEMENT, 4), mod.SourceSignal(mod.SignalKind.PRODUCER, 5),
               mod.SourceSignal(mod.SignalKind.CONSUMER, 6)]
        gen = mod.CrCandidateGenerator(specs, mod.CrMixerConfig(max_results=15, blender=blender,
                                                               min_blended_score=0.05))
        return mod.CrMixerSource(gen).get({"signals": sig}, None)

    got, want = run(cr, comp), run(jcr, jcomp)
    assert [(c.id, c.source) for c in got] == [(c.id, c.source) for c in want]
    np.testing.assert_allclose([c.score for c in got], [c.score for c in want], rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_component_library_selectors_and_filters_equal_jax(seed):
    def run(mod):
        cands = [c for lst in _lists(mod, seed, engines=2) for c in lst]
        dedup = mod.DedupSelector().select(None, cands, None)
        top = mod.TopKScoreSelector(7).select(None, cands, None)
        kept, removed = mod.PredicateFilter(lambda q, c, p: c.id % 2 == 0, "even").apply(None, cands, None)
        gate = mod.LambdaGate(lambda q, p: q > 0, "positive")
        return ([c.id for c in dedup], [c.id for c in top], [c.id for c in kept], [c.id for c in removed],
                gate.should_continue(1, None), gate.should_continue(-1, None), gate.name)

    assert run(comp) == run(jcomp)
    pipe = comp.CandidatePipeline(source=tm.TweetMixerSource(tm.TweetMixer([], max_concurrency=1)))
    assert pipe.name == "TweetMixer" and pipe.fail_open


# -- the port-only world the chip check serves Home from ------------------------------------------

@functools.lru_cache(maxsize=None)
def small_world():
    from the_algorithm_tpu_torch.data import foryou_world, sann_world, tweet_mixer_world as tmw

    shape = tmw.TweetMixerShape(
        sann=sann_world.WorldShape(n_comm=8, cpc=64, M=40, N=10, X=50, T=8192, KT=8, Q=32),
        foryou=foryou_world.ForYouShape(num_users=512, num_authors=128, eb_docs=4096, tweet_space=4096, follows=12,
                                        follow_width=16, utg_width=32, utg_sources=16),
        embed_dim=16, tower_hidden=(16,), users=3)
    return tmw, tmw.build(shape, device="cpu")


def _home_lists(w):
    catalog = cat.build_catalog(w.source_world())
    home = tmp.TweetMixerProduct.HOME_RECOMMENDED_TWEETS
    return {(q.user_id, p.name): [(c.id, c.score) for c in p.source.get(q, Params())]
            for q in w.queries for p in tmp.product_pipelines(catalog, home, q, Params())}


def test_tweet_mixer_world_serves_every_home_pipeline():
    tmw, w = small_world()
    lists = _home_lists(w)
    assert len(lists) == 20 * len(w.queries)
    assert all(lists.values())  # every pipeline answers every served user
    for q in w.queries:
        assert q.followed_authors and 1 <= len(q.recent_engagement_ids) <= 4
        blended = tmp.run_product(cat.build_catalog(w.source_world()), tmp.TweetMixerProduct.HOME_RECOMMENDED_TWEETS, q)
        assert len(blended) == 400 and len({c.id for c in blended}) == 400


def test_tweet_mixer_world_copy_serves_the_same_lists():
    """``to`` rebuilds the models from their state on another device (here
    the CPU again): the copy serves the same lists."""
    _, w = small_world()
    copy = w.to("cpu")
    assert copy.twhin is not w.twhin
    assert _home_lists(copy) == _home_lists(w)


def test_tweet_mixer_world_draws():
    """The two-tower table is the item tower of every item; the community
    draw is build_corpus's; the trip rows descend."""
    tmw, w = small_world()
    from the_algorithm_tpu_torch.data import sann_world

    _, _, _, comm = sann_world.build_corpus(w.shape.sann)
    np.testing.assert_array_equal(tmw.community_clusters(w.shape.sann), comm)
    ids = torch.arange(w.shape.num_items)
    torch.testing.assert_close(w.two_tower_items, w.two_tower.item_embeddings(ids), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(tmw.export_item_table(w.two_tower, chunk=1000), w.two_tower_items, rtol=1e-6, atol=1e-7)
    assert (np.diff(w.trip.scores, axis=-1) <= 0).all()
    assert w.trip.get(("TOP_GEO", -1)) == () and w.trip.get(("NOWHERE", 0)) == ()


def test_expected_launches_count_the_expansion_per_source_tweet():
    tmw, _ = small_world()
    q = Query(user_id=1, followed_authors=(2,), recent_engagement_ids=(5, 6, 7))
    names = list(tmp.PRODUCT_SPECS[tmp.TweetMixerProduct.HOME_RECOMMENDED_TWEETS].pipeline_names)
    assert set(names) == set(tmw.PIPELINE_LAUNCHES)
    # SANN ×5 and the UTEG family ×3: 1 + 1 each; UTG 2 + 1, and 3 × (2 + 1) expanded; TwHIN's
    # consumer vector 2, the collab filter 3 + 1, its tweet row 1; the deep-retrieval and two-tower rows 3
    assert tmw.expected_launches(names, q) == {"run_collapse": 5 + 3 + 1 + 3 + 1,
                                               "row_gather": 5 + 3 + 2 + 6 + 2 + 3 + 1 + 3}
