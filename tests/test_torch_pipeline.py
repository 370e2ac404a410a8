"""The port's pipeline framework (the_algorithm_tpu_torch/pipeline/{recommendation,
component_library, mixer, urt}.py) against the JAX package's.

Each scenario of the JAX tests ``tests/test_{pipeline,component_library,urt}.py``
and ``test_home_products.py::TestMixerSelectors`` runs through both packages,
built from each package's own classes, and the outcomes are compared exactly:
candidate ids and their order, ``removed`` and ``failures`` keys, gate and
quality-factor effects, stats counters, timeline entries, and the URT
response's ``to_json()`` bytes. All host code: no tolerance.
"""

import dataclasses
import json
import threading
import time
import types

import pytest
import torch_port_util  # noqa: F401  (one torch thread)

import the_algorithm_tpu.core.config as j_config
import the_algorithm_tpu.core.metrics as j_metrics
import the_algorithm_tpu.pipeline.component as j_component
import the_algorithm_tpu.pipeline.component_library as j_library
import the_algorithm_tpu.pipeline.mixer as j_mixer
import the_algorithm_tpu.pipeline.recommendation as j_recommendation
import the_algorithm_tpu.pipeline.urt as j_urt
import the_algorithm_tpu_torch.core.config as t_config
import the_algorithm_tpu_torch.core.metrics as t_metrics
import the_algorithm_tpu_torch.pipeline.component as t_component
import the_algorithm_tpu_torch.pipeline.component_library as t_library
import the_algorithm_tpu_torch.pipeline.mixer as t_mixer
import the_algorithm_tpu_torch.pipeline.recommendation as t_recommendation
import the_algorithm_tpu_torch.pipeline.urt as t_urt

JAX = types.SimpleNamespace(config=j_config, metrics=j_metrics, component=j_component, library=j_library,
                            mixer=j_mixer, recommendation=j_recommendation, urt=j_urt)
PORT = types.SimpleNamespace(config=t_config, metrics=t_metrics, component=t_component, library=t_library,
                             mixer=t_mixer, recommendation=t_recommendation, urt=t_urt)


def both(scenario):
    """The scenario's outcome in the JAX package and in the port."""
    return scenario(JAX), scenario(PORT)


# -- the recommendation engine (tests/test_pipeline.py) --------------------------


def _components(ns):
    c = ns.component

    class StaticSource(c.CandidateSource):
        def __init__(self, ids, name="StaticSource", delay=0.0):
            self.ids, self._name, self.delay = ids, name, delay

        @property
        def name(self):
            return self._name

        def get(self, query, params):
            time.sleep(self.delay)
            return [c.Candidate(id=i) for i in self.ids]

    class FailingSource(c.CandidateSource):
        def get(self, query, params):
            raise RuntimeError("backend down")

    class AgeHydrator(c.FeatureHydrator):
        def hydrate(self, query, candidates, params):
            for x in candidates:
                x.features["age"] = x.id * 10

    class FailingHydrator(c.FeatureHydrator):
        def hydrate(self, query, candidates, params):
            raise KeyError("store gone")

    class IdScorer(c.Scorer):
        def score(self, query, candidates, params):
            for x in candidates:
                x.score = float(x.id)

    class BoomScorer(c.Scorer):
        def score(self, query, candidates, params):
            raise ValueError("model gone")

    class RecordingSideEffect(c.SideEffect):
        def __init__(self):
            self.seen = None

        def run(self, query, result, params):
            self.seen = [x.id for x in result]

    class FailingSideEffect(c.SideEffect):
        def run(self, query, result, params):
            raise RuntimeError("sink down")

    class FeaturesQueryHydrator(c.QueryFeatureHydrator):
        def __init__(self, feats):
            self.feats = feats

        def hydrate(self, query, params):
            return dict(self.feats)

    class FailingQueryHydrator(c.QueryFeatureHydrator):
        def hydrate(self, query, params):
            raise RuntimeError("uss down")

    return types.SimpleNamespace(**{k: v for k, v in locals().items() if isinstance(v, type)})


def _pipeline(ns, **kwargs):
    c, k = ns.component, _components(ns)
    defaults = dict(
        candidate_pipelines=[c.CandidatePipeline(k.StaticSource([1, 2, 3], "A")),
                             c.CandidatePipeline(k.StaticSource([3, 4], "B"))],
        post_candidate_selectors=[c.DedupSelector()],
        post_candidate_hydrators=[k.AgeHydrator()],
        scorers=[k.IdScorer()],
        result_selectors=[c.TopKScoreSelector(3)],
    )
    defaults.update(kwargs)
    return ns.recommendation.RecommendationPipeline(**defaults)


def _summary(out):
    return dict(ids=[x.id for x in out.candidates], scores=[x.score for x in out.candidates],
                sources=[x.source for x in out.candidates],
                features=[sorted(x.features.items()) for x in out.candidates],
                removed=dict(out.removed), gated=out.gated, failures=sorted(out.failures))


class _Query:
    def __init__(self):
        self.features = {}


def engine_end_to_end(ns):
    k = _components(ns)
    se = k.RecordingSideEffect()
    out = _pipeline(ns, side_effects=[se]).run(_Query())
    return _summary(out), se.seen


def engine_gate(ns):
    gate = ns.component.LambdaGate(lambda q, pr: False, "Closed")
    return _summary(_pipeline(ns, gates=[gate]).run(_Query()))


def engine_fail_open_source(ns):
    c, k = ns.component, _components(ns)
    p = _pipeline(ns, candidate_pipelines=[c.CandidatePipeline(k.FailingSource()),
                                           c.CandidatePipeline(k.StaticSource([7], "OK"))])
    return _summary(p.run(_Query()))


def engine_fail_closed_source(ns):
    c, k = ns.component, _components(ns)
    p = _pipeline(ns, candidate_pipelines=[c.CandidatePipeline(k.FailingSource(), fail_open=False)])
    with pytest.raises(RuntimeError) as e:
        p.run(_Query())
    return str(e.value)


def engine_global_filter(ns):
    f = ns.component.PredicateFilter(lambda q, x, pr: x.id % 2 == 0, "EvenOnly")
    return _summary(_pipeline(ns, global_filters=[f]).run(_Query()))


def engine_quality_factor(ns):
    qf = ns.recommendation.QualityFactorConfig(target_latency_ms=0.0, min_quality_factor=0.4)
    qf.quality_factor = 0.5
    out = _pipeline(ns, quality_factor=qf, result_selectors=[]).run(_Query())
    return _summary(out), qf.quality_factor


def engine_stats(ns):
    stats = ns.metrics.StatsReceiver()
    _pipeline(ns, stats=stats).run(_Query())
    return {k: v for k, v in stats.counters().items()}


def engine_scorer_fail_open(ns):
    k = _components(ns)
    return _summary(_pipeline(ns, scorers=[k.BoomScorer()], scorer_fail_open=True, result_selectors=[]).run(_Query()))


def engine_scorer_fail_closed(ns):
    k = _components(ns)
    with pytest.raises(ValueError) as e:
        _pipeline(ns, scorers=[k.BoomScorer()]).run(_Query())
    return str(e.value)


def engine_query_hydration_and_failures(ns):
    """Two hydration phases (the second overrides the first), a failing query
    hydrator, a failing candidate hydrator and a failing side effect: each a
    ``failures`` entry, the request still served."""
    k = _components(ns)
    q = _Query()
    q.features = {"kept": 1}
    out = _pipeline(ns, query_hydrators=[k.FeaturesQueryHydrator({"a": 1, "b": 1}), k.FailingQueryHydrator()],
                    query_hydrators_phase2=[k.FeaturesQueryHydrator({"b": 2})],
                    post_candidate_hydrators=[k.AgeHydrator(), k.FailingHydrator()],
                    side_effects=[k.FailingSideEffect()]).run(q)
    return _summary(out), sorted(q.features.items())


def engine_results_in_pipeline_order(ns):
    """Candidate pipelines finish in another order than they are listed (the
    first sleeps): the results are taken in pipeline order."""
    c, k = ns.component, _components(ns)
    p = _pipeline(ns, candidate_pipelines=[c.CandidatePipeline(k.StaticSource([5, 6], "Slow", delay=0.05)),
                                           c.CandidatePipeline(k.StaticSource([1, 6], "Fast"))],
                  scorers=[], result_selectors=[])
    return _summary(p.run(_Query()))


ENGINE = [engine_end_to_end, engine_gate, engine_fail_open_source, engine_fail_closed_source, engine_global_filter,
          engine_quality_factor, engine_stats, engine_scorer_fail_open, engine_scorer_fail_closed,
          engine_query_hydration_and_failures, engine_results_in_pipeline_order]


@pytest.mark.parametrize("scenario", ENGINE, ids=[f.__name__ for f in ENGINE])
def test_recommendation_engine_matches_jax(scenario):
    got_jax, got_port = both(scenario)
    assert got_port == got_jax


def test_engine_runs_concurrent_requests_apart():
    """8 requests at once through one port pipeline: each gets its own
    candidates (nothing is shared between runs but the components)."""
    c = t_component

    class UserSource(c.CandidateSource):
        def get(self, query, params):
            return [c.Candidate(id=query.uid * 100 + i) for i in range(5)]

    p = _pipeline(PORT, candidate_pipelines=[c.CandidatePipeline(UserSource())])
    outs, lock = {}, threading.Lock()

    def run(u):
        q = _Query()
        q.uid = u
        ids = [x.id for x in p.run(q).candidates]
        with lock:
            outs[u] = ids

    threads = [threading.Thread(target=run, args=(u,)) for u in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert outs == {u: [u * 100 + 4, u * 100 + 3, u * 100 + 2] for u in range(8)}


# -- the component library (tests/test_component_library.py) --------------------


@dataclasses.dataclass
class Q:
    user_id: object = 1
    country_code: object = "US"
    cursor: object = None
    excluded_ids: tuple = ()
    languages: tuple = ()
    now: int = 0
    features: dict = dataclasses.field(default_factory=dict)


def _cands(ns, *specs):
    return [ns.component.Candidate(id=i, features=dict(f)) for i, f in specs]


class _Takedowns:
    def __init__(self, withheld):
        self.withheld = withheld

    def is_withheld(self, tweet_id, country):
        return country in self.withheld.get(tweet_id, ())


class _Bloom:
    def __init__(self, ids):
        self.ids = set(ids)

    def __contains__(self, k):
        return k in self.ids


def library_gates(ns):
    cl, P = ns.library, ns.config
    p = P.Param("enable_x", True)
    q = Q(features={"eligible": True, "quality_factor": 0.3})
    return [
        cl.DefinedUserIdGate().should_continue(Q(), P.Params()),
        cl.DefinedUserIdGate().should_continue(Q(user_id=None), P.Params()),
        cl.DefinedCountryCodeGate().should_continue(Q(country_code=None), P.Params()),
        cl.FirstPageGate().should_continue(Q(), P.Params()),
        cl.FirstPageGate().should_continue(Q(cursor="abc"), P.Params()),
        cl.FeatureGate("eligible").should_continue(q, P.Params()),
        cl.FeatureGate("other").should_continue(q, P.Params()),
        cl.FeatureGate("other").name,
        cl.ParamGate(p).should_continue(q, P.Params()),
        cl.ParamGate(p).should_continue(q, P.Params({p: False})),
        cl.ParamGate(p).name,
        cl.QualityFactorGate(0.5).should_continue(q, P.Params()),
        cl.QualityFactorGate(0.2).should_continue(q, P.Params()),
    ]


def library_filters(ns):
    cl, P, Cand = ns.library, ns.config, ns.component.Candidate
    pr = P.Params()
    now_s = (cl.SNOWFLAKE_EPOCH_MS + 10_000_000) // 1000
    fresh, stale = (10_000_000 - 1000) << 22, (10_000_000 - 7_200_000) << 22
    pf = P.Param("enable_f", False)

    def kept(r):
        return [x.id for x in r.kept], [x.id for x in r.removed]

    return [
        kept(cl.ExcludedIdsFilter().apply(Q(excluded_ids=(2,)), _cands(ns, (1, {}), (2, {})), pr)),
        kept(cl.FeatureFilter("is_nsfw", keep_if=False).apply(Q(), _cands(ns, (1, {"is_nsfw": True}), (2, {})), pr)),
        cl.FeatureFilter("is_nsfw").name,
        kept(cl.FeatureValueConditionalFilter("score", lambda v: v > 0.5).apply(
            Q(), _cands(ns, (1, {"score": 0.9}), (2, {"score": 0.1}), (3, {})), pr)),
        kept(cl.FeatureValueConditionalFilter("score", lambda v: v > 0.5, missing_ok=True).apply(
            Q(), _cands(ns, (1, {"score": 0.9}), (3, {})), pr)),
        kept(cl.ParamGatedFilter(pf, cl.HasAuthorIdFeatureFilter()).apply(
            Q(), _cands(ns, (1, {}), (2, {"author_id": 9})), pr)),
        kept(cl.ParamGatedFilter(pf, cl.HasAuthorIdFeatureFilter()).apply(
            Q(), _cands(ns, (1, {}), (2, {"author_id": 9})), P.Params({pf: True}))),
        cl.ParamGatedFilter(pf, cl.HasAuthorIdFeatureFilter()).name,
        kept(cl.SnowflakeIdAgeFilter(3600_000).apply(Q(now=now_s), [Cand(id=fresh), Cand(id=stale)], pr)),
        cl.snowflake_creation_ms(fresh),
        kept(cl.TweetAuthorIsSelfFilter().apply(Q(user_id=1), _cands(ns, (1, {"author_id": 1}), (2, {"author_id": 9})),
                                                pr)),
        kept(cl.TweetIsNotReplyFilter().apply(Q(), _cands(ns, (1, {"is_reply": True}), (2, {})), pr)),
        kept(cl.TweetLanguageFilter().apply(Q(languages=("en",)),
                                            _cands(ns, (1, {"language": "ja"}), (2, {"language": "en"}), (3, {})),
                                            pr)),
        kept(cl.TweetAuthorCountryFilter(_Takedowns({1: ("US",)})).apply(
            Q(country_code="US"), _cands(ns, (1, {}), (2, {})), pr)),
        kept(cl.BloomFilterDedupFilter({1: _Bloom([7])}).apply(Q(user_id=1), _cands(ns, (7, {}), (8, {})), pr)),
        kept(cl.BloomFilterDedupFilter({1: _Bloom([7])}).apply(Q(user_id=2), _cands(ns, (7, {}), (8, {})), pr)),
    ]


def library_selectors(ns):
    cl, P, Cand = ns.library, ns.config, ns.component.Candidate
    pr, pm = P.Params(), P.Param("max_n", 2)

    def ids(xs):
        return [x.id for x in xs]

    cs = [Cand(id=1, score=0.2, features={"author_id": 5}), Cand(id=2, score=0.9, features={"author_id": 5}),
          Cand(id=3, score=None, features={"author_id": 6}), Cand(id=1, score=0.5)]
    return [
        ids(cl.DropDuplicateCandidates().select(None, cs, pr)),
        ids(cl.DropDuplicateCandidates(lambda x: x.features.get("author_id")).select(None, cs, pr)),
        ids(cl.DropMaxCandidates(2).select(None, cs, pr)),
        ids(cl.DropMaxCandidates(param=pm).select(None, cs, P.Params({pm: 3}))),
        ids(cl.DropTooFewResults(5).select(None, cs, pr)),
        ids(cl.DropTooFewResults(4).select(None, cs, pr)),
        ids(cl.InsertAppendResults(lambda q: [Cand(id=3), Cand(id=9)]).select(None, cs[:2], pr)),
        ids(cl.SortCandidates().select(None, cs, pr)),
        ids(cl.SortCandidates(lambda x: x.id, descending=False).select(None, cs, pr)),
        ids(cl.DropOrthogonalCandidates(lambda q: [Cand(id=2)]).select(None, cs, pr)),
    ]


def library_composed(ns):
    """The stock components inside the engine (test_component_library.py's
    TestComposedPipeline)."""
    c, cl = ns.component, ns.library
    k = _components(ns)
    pipe = ns.recommendation.RecommendationPipeline(
        gates=[cl.DefinedUserIdGate()],
        candidate_pipelines=[c.CandidatePipeline(k.StaticSource([1, 2, 3, 4, 5], "A")),
                             c.CandidatePipeline(k.StaticSource([4, 5, 6], "B"))],
        post_candidate_selectors=[cl.DropDuplicateCandidates()],
        global_filters=[cl.ExcludedIdsFilter()],
        scorers=[k.IdScorer()],
        result_selectors=[cl.SortCandidates(), cl.DropMaxCandidates(3)],
    )
    return _summary(pipe.run(Q(excluded_ids=(6,)))), _summary(pipe.run(Q(user_id=None)))


LIBRARY = [library_gates, library_filters, library_selectors, library_composed]


@pytest.mark.parametrize("scenario", LIBRARY, ids=[f.__name__ for f in LIBRARY])
def test_component_library_matches_jax(scenario):
    got_jax, got_port = both(scenario)
    assert got_port == got_jax


# -- the mixer (tests/test_home_products.py::TestMixerSelectors) -----------------


def _entries(ns, timeline_or_entries):
    entries = getattr(timeline_or_entries, "entries", timeline_or_entries)
    out = []
    for e in entries:
        if e.module is not None:
            out.append((e.kind.value, e.module.kind, e.module.header, e.module.item_kind,
                        [x.id for x in e.module.items]))
        else:
            out.append((e.kind.value, e.candidate.id))
    return out


def _mod(ns, kind, ids):
    m = ns.mixer
    return m.TimelineEntry(kind=m.EntryKind.MODULE,
                           module=m.Module(kind=kind, items=[ns.component.Candidate(id=i) for i in ids]))


def _tweets(ns, ids, kind=None):
    m = ns.mixer
    return [m.TimelineEntry(kind=kind or m.EntryKind.TWEET, candidate=ns.component.Candidate(id=i)) for i in ids]


def mixer_drop_too_few_and_truncate(ns):
    m = ns.mixer
    entries = [_mod(ns, "who_to_follow", [1]), _mod(ns, "who_to_follow", [2, 3, 4]), _mod(ns, "conversation", [5])]
    out = m.DropModuleTooFewItems(2, "who_to_follow").select(None, entries, None)
    out2 = m.DropMaxModuleItemCandidates(2, "who_to_follow").select(None, out, None)
    out3 = m.DropModuleTooFewItems(2).select(None, entries, None)
    return _entries(ns, out), _entries(ns, out2), _entries(ns, out3), [len(e.module.items) for e in entries]


def mixer_insert_fixed_position(ns):
    m = ns.mixer
    entries = _tweets(ns, range(5)) + [_mod(ns, "who_to_follow", [9, 10]), _mod(ns, "conversation", [11, 12])]
    return [_entries(ns, m.InsertFixedPositionModule(m.EntryKind.MODULE, pos, kind).select(None, entries, None))
            for pos, kind in ((50, "who_to_follow"), (2, "who_to_follow"), (0, None), (3, None))]


def mixer_ads(ns):
    m = ns.mixer
    ads = _tweets(ns, range(70, 73), m.EntryKind.AD)
    out = []
    for n_tweets, spacing, first, max_ads in ((3, 2, 1, 4), (12, 3, 2, 4), (12, 2, 0, 2), (0, 2, 0, 4), (6, 4, 2, 4)):
        sel = m.InsertAdResults(min_spacing=spacing, first_position=first, max_ads=max_ads)
        out.append(_entries(ns, sel.select(None, _tweets(ns, range(n_tweets)) + ads, None)))
    out.append(_entries(ns, m.InsertAdResults().select(None, _tweets(ns, range(6)), None)))
    return out


def mixer_sorts_and_truncation(ns):
    m = ns.mixer
    entries = (_tweets(ns, [5, 9, 1]) + [_mod(ns, "conversation", [3, 8])] + _tweets(ns, [7], m.EntryKind.AD)
               + [_mod(ns, "who_to_follow", [])])
    return [_entries(ns, m.SortByRecency().select(None, entries, None)),
            _entries(ns, m.SortModulesByRecency().select(None, entries, None)),
            _entries(ns, m.DropMaxEntries(3).select(None, entries, None)),
            [e.sort_id for e in entries], m.SortByRecency().name]


def mixer_pipeline_fail_open(ns):
    c, m = ns.component, ns.mixer

    class Boom(c.CandidateSource):
        def get(self, query, params):
            raise RuntimeError("source down")

    class Ok(c.CandidateSource):
        def get(self, query, params):
            return [c.Candidate(id=1)]

    pipe = m.MixerPipeline(candidate_pipelines=[
        m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(source=Boom())),
        m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(source=Ok())),
    ])
    tl = pipe.run(Q())
    closed = m.MixerPipeline(candidate_pipelines=[
        m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(source=Boom(), fail_open=False))])
    with pytest.raises(RuntimeError):
        closed.run(Q())
    return tl.tweet_ids()


def _mixer_product(ns, stats=None):
    """A mixer with every kind of result: tweets through a grouper, a user
    module, ads, an instruction-only pipeline, a query hydrator, a gate, a
    hydrator and filter inside a candidate pipeline, and side effects."""
    c, m = ns.component, ns.mixer

    class Tweets(c.CandidateSource):
        name = "Tweets"

        def get(self, query, params):
            return [c.Candidate(id=100 + i, score=1.0 - 0.1 * i,
                                features={"author_id": i % 3, "social_proof": i % 2, "created_ts": 5})
                    for i in range(8)]

    class Users(c.CandidateSource):
        name = "Users"

        def get(self, query, params):
            return [c.Candidate(id=900 + i, features={"author_follows_viewer": 1}) for i in range(3)]

    class Ads(c.CandidateSource):
        name = "ads"

        def get(self, query, params):
            return [c.Candidate(id=7001, source="ads", features={"advertiser_id": 55}), c.Candidate(id=7002)]

    class Hyd(c.FeatureHydrator):
        def hydrate(self, query, candidates, params):
            for x in candidates:
                x.features["hydrated"] = True

    class QH(c.QueryFeatureHydrator):
        def hydrate(self, query, params):
            return {"qh": 1}

    class Effect(c.SideEffect):
        def __init__(self):
            self.seen = []

        def run(self, query, entries, params):
            self.seen.append(len(entries))

    class BoomEffect(c.SideEffect):
        def run(self, query, entries, params):
            raise RuntimeError("sink down")

    def grouper(query, cands):
        out = []
        for i in range(0, len(cands), 3):
            chunk = cands[i:i + 3]
            if len(chunk) == 1:
                out.append(m.TimelineEntry(kind=m.EntryKind.TWEET, candidate=chunk[0]))
            else:
                out.append(m.TimelineEntry(kind=m.EntryKind.MODULE, module=m.Module(kind="conversation", items=chunk)))
        return out

    def users(query, cands):
        return [m.TimelineEntry(kind=m.EntryKind.MODULE, module=m.Module(
            kind="who_to_follow", items=list(cands), header="Who to follow", item_kind="user"))]

    def instructions(query, cands):
        return [m.Instruction(op="replace_entry", payload={"entry_id": 101, "with": 9101}),
                m.Instruction(op="show_alert", payload={"kind": "new_tweets_pill", "count": 2}),
                m.Instruction(op="clear_cache"), m.Instruction(op="navigate", payload={"to": "home"}),
                m.Instruction(op="custom", payload={"x": 1})]

    effect = Effect()
    pipe = m.MixerPipeline(
        candidate_pipelines=[
            m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(
                source=Tweets(), hydrators=[Hyd()],
                filters=[c.PredicateFilter(lambda q, x, p: x.id != 104, "Drop104")])),
            m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(source=Tweets()), grouper=grouper),
            m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(source=Users()), kind=m.EntryKind.MODULE,
                                     grouper=users),
            m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(source=Ads()), kind=m.EntryKind.AD),
            m.MixerCandidatePipeline(pipeline=c.CandidatePipeline(source=Users()), instruction_builder=instructions),
        ],
        query_hydrators=[QH()],
        entry_selectors=[m.SortModulesByRecency(), m.DropMaxModuleItemCandidates(2, "conversation"),
                         m.InsertFixedPositionModule(m.EntryKind.MODULE, 2, "who_to_follow"),
                         m.InsertAdResults(min_spacing=3), m.DropMaxEntries(12)],
        side_effects=[effect, BoomEffect()],
        stats=stats,
    )
    return pipe, effect


def mixer_pipeline_run(ns):
    pipe, effect = _mixer_product(ns)
    q = Q()
    tl = pipe.run(q)
    gated = ns.mixer.MixerPipeline(candidate_pipelines=pipe.candidate_pipelines,
                                   gates=[ns.component.LambdaGate(lambda q, p: False, "Closed")])
    return (_entries(ns, tl), [(i.op, i.payload) for i in tl.instructions], tl.top_cursor, tl.bottom_cursor,
            tl.tweet_ids(), effect.seen, q.features, _entries(ns, gated.run(Q())))


def test_mixer_counts_into_stats_where_jax_raises():
    """The JAX mixer calls ``.incr`` on ``StatsReceiver.counter``'s None and
    raises at its first count; the port's counts, and serves the same
    timeline as JAX's without stats."""
    with pytest.raises(AttributeError):
        _mixer_product(JAX, JAX.metrics.StatsReceiver())[0].run(Q())
    stats = PORT.metrics.StatsReceiver()
    tl = _mixer_product(PORT, stats)[0].run(Q())
    assert _entries(PORT, tl) == _entries(JAX, _mixer_product(JAX)[0].run(Q()))
    assert stats.counters() == {"mixer/candidates/Tweets": 7 * 2 + 1, "mixer/candidates/Users": 6,
                                "mixer/candidates/ads": 2, "mixer/side_effect_failed/BoomEffect": 1}


MIXER = [mixer_drop_too_few_and_truncate, mixer_insert_fixed_position, mixer_ads, mixer_sorts_and_truncation,
         mixer_pipeline_fail_open, mixer_pipeline_run]


@pytest.mark.parametrize("scenario", MIXER, ids=[f.__name__ for f in MIXER])
def test_mixer_matches_jax(scenario):
    got_jax, got_port = both(scenario)
    assert got_port == got_jax


# -- URT (tests/test_urt.py) --------------------------------------------------------


def urt_mixer_product(ns):
    pipe, _ = _mixer_product(ns)
    return ns.urt.marshal_timeline(pipe.run(Q())).to_json()


def urt_marshaller_options(ns):
    pipe, _ = _mixer_product(ns)
    tl = pipe.run(Q())
    dec = ns.urt.UrtItemCandidateDecorator(social_context_builder=lambda c: None)
    return ns.urt.marshal_timeline(tl, tweet_decorator=dec, sort_index_step=7).to_json()


def urt_social_contexts(ns):
    u, Cand = ns.urt, ns.component.Candidate
    b = u.FeatureSocialContextBuilder()
    cands = [Cand(id=1, features={"social_proof": 3, "social_proof_user_ids": [7, 8]}),
             Cand(id=2, features={"social_proof": 1}),
             Cand(id=3, features={"topic_relevance": 0.9, "topic_name": "TPUs"}),
             Cand(id=4, features={"topic_relevance": 0.9, "topic_id": 17}),
             Cand(id=5, features={"author_follows_viewer": True}),
             Cand(id=6)]
    return [None if (ctx := b(c)) is None else ctx.to_dict() for c in cands]


def urt_entries_of_every_kind(ns):
    u, m, Cand = ns.urt, ns.mixer, ns.component.Candidate
    entries = [
        m.TimelineEntry(kind=m.EntryKind.TWEET, candidate=Cand(
            id=5, score=0.25, source="Src", features={"visibility_interstitial": "nsfw_hp", "author_id": 2})),
        m.TimelineEntry(kind=m.EntryKind.AD, candidate=Cand(id=7001, features={"promoted": True})),
        m.TimelineEntry(kind=m.EntryKind.AD, candidate=Cand(id=7002)),
        m.TimelineEntry(kind=m.EntryKind.MODULE, module=m.Module(kind="carousel", items=[Cand(id=3), Cand(id=4)],
                                                                 header="More")),
        m.TimelineEntry(kind=m.EntryKind.MODULE, module=m.Module(kind="other", items=[])),
        m.TimelineEntry(kind=m.EntryKind.PROMPT, candidate=Cand(id=11)),
    ]
    tl = m.Timeline(entries=entries, instructions=[m.Instruction(op="clear_cache")], top_cursor=9, bottom_cursor=1)
    resp = u.marshal_timeline(tl)
    return resp.to_json(), resp.entries(), u.UrtTimelineResponse(instructions=[]).entries()


URT = [urt_mixer_product, urt_marshaller_options, urt_social_contexts, urt_entries_of_every_kind]


@pytest.mark.parametrize("scenario", URT, ids=[f.__name__ for f in URT])
def test_urt_matches_jax_byte_for_byte(scenario):
    got_jax, got_port = both(scenario)
    assert got_port == got_jax
    if isinstance(got_port, str):
        json.loads(got_port)
