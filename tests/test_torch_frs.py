"""The port's follow recommendations (the_algorithm_tpu_torch/simclusters/
{known_for, sims_graph}.py, mixers/{follow_recommendations, frs_catalog}.py,
data/frs_world.py) against the JAX package's.

Tolerances:

- the follow matrix exactly; the sims graph (follower cosine, top-K,
  symmetrized) ids equal but among near-ties, weights rtol 1e-6 (co-follow
  counts are exact; ``rsqrt`` may differ by an ulp);
- the four device sources on seeded graphs with PAD rows, repeated ids and
  out-of-range ids: ids equal but among near-ties, scores rtol 1e-6 (f32
  sums in another order), and the JAX tests' oracle cases;
- every host source class, predicate, ``PreviouslyRecommendedStore``,
  ``ml_ranker`` and ``interleave_promoted`` exactly; each display-location
  flow over a small seeded FRS world: the same candidates, sources and
  features, scores rtol 1e-5, ranks apart only among near-ties;
- the slice as a whole: JAX's ``build_for_you_mixer`` with JAX's
  HOME_TIMELINE flow and the port's with the port's, on
  test_torch_home_pipeline's small world: the same URT JSON, ids equal but
  among near-ties, scores rtol 1e-5 (creation times below 1,000 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID, assert_same_topk

from the_algorithm_tpu.graph import graphjet as jgraphjet
from the_algorithm_tpu.graph import realgraph as jrealgraph
from the_algorithm_tpu.mixers import follow_recommendations as jfrs
from the_algorithm_tpu.mixers import frs_catalog as jfc
from the_algorithm_tpu.pipeline.component import Candidate as JCandidate
from the_algorithm_tpu.simclusters import known_for as jkf
from the_algorithm_tpu.simclusters import sims_graph as jsims
from the_algorithm_tpu_torch.data import frs_world as fw
from the_algorithm_tpu_torch.graph import realgraph
from the_algorithm_tpu_torch.mixers import follow_recommendations as frs
from the_algorithm_tpu_torch.mixers import frs_catalog as fc
from the_algorithm_tpu_torch.ops import gather, seg_scan
from the_algorithm_tpu_torch.pipeline.component import Candidate
from the_algorithm_tpu_torch.simclusters import known_for, sims_graph

P = int(PAD_ID)
RTOL = 1e-6
FLOW_RTOL = 1e-5
SMALL = fw.FrsShape(num_users=512, num_authors=128, follows=12, follow_width=16, tweet_space=4096,
                    realgraph_events=4096, sims_top_k=16, top_k=24)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# JAX's device functions, jitted: eager, each of their ops compiles apart
J_SIMILAR = jax.jit(jfrs.similar_producers_candidates, static_argnums=2)
J_TRIANGULAR = jax.jit(jfrs.triangular_closure_candidates, static_argnums=2)
J_SALSA = jax.jit(jfc.salsa_candidates, static_argnums=3)
J_EXPANSION = jax.jit(jfc.sims_expansion_candidates, static_argnums=(3, 4))


@pytest.fixture(autouse=True, scope="module")
def _jitted_graph_calls():
    """JAX's source classes call ``graphjet.recommend_users`` and
    ``realgraph.top_edges`` eagerly; the same functions, jitted."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jgraphjet, "recommend_users",
               jax.jit(jgraphjet.recommend_users, static_argnames=("max_results", "min_social_proof")))
    mp.setattr(jrealgraph, "top_edges", jax.jit(jrealgraph.top_edges, static_argnums=4))
    yield
    mp.undo()


def _follow_adjacency(seed=0, U=512, Pn=256, D=24):
    """[U, D] follows of P producers: PAD rows, repeated ids, ids past P."""
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, Pn, (U, D)).astype(np.int32)
    adj[rng.random((U, D)) < 0.3] = P
    adj[::17] = P  # empty rows
    adj[5, :4] = 7  # a repeated follow
    adj[9, 0] = Pn + 3  # outside [0, P): counts nowhere
    return adj


def test_known_for_types():
    g = known_for.Graph(_t(np.full((3, 2), P, np.int32)), torch.zeros(3, 2))
    assert g.num_nodes == 3 and known_for.NO_CLUSTER == int(jkf.NO_CLUSTER)
    p = known_for.KnownForParams(num_clusters=4)
    assert dataclasses.asdict(p) == dataclasses.asdict(jkf.KnownForParams(num_clusters=4))
    kf = known_for.KnownFor(torch.tensor([0, -1], dtype=torch.int32), torch.tensor([1.0, 0.0]))
    assert kf.cluster.dtype == torch.int32


@pytest.mark.parametrize("self_loops,min_sim", [(True, 0.0), (False, 0.05)])
def test_sims_graph_matches_jax(self_loops, min_sim):
    adj = _follow_adjacency()
    fm = sims_graph.follow_matrix_from_adjacency(_t(adj), 256)
    jfm = jsims.follow_matrix_from_adjacency(jnp.asarray(adj), 256)
    np.testing.assert_array_equal(fm.numpy(), np.asarray(jfm))
    kw = dict(top_k=16, min_similarity=min_sim, include_self_loops=self_loops, block_size=96)
    g = sims_graph.cosine_similarity_graph(fm, **kw)
    jg = jsims.cosine_similarity_graph(jfm, **kw)
    assert_same_topk(g.nbr_ids.numpy(), g.nbr_weights.numpy(), np.asarray(jg.nbr_ids), np.asarray(jg.nbr_weights),
                     rtol=RTOL, atol=1e-7)
    s, js = sims_graph.symmetrize(g), jsims.symmetrize(jg)
    assert_same_topk(s.nbr_ids.numpy(), s.nbr_weights.numpy(), np.asarray(js.nbr_ids), np.asarray(js.nbr_weights),
                     rtol=RTOL, atol=1e-7)
    assert s.nbr_ids.dtype == torch.int32 and s.nbr_ids.is_contiguous()
    # symmetric: q in p's row ⇒ p in q's row wherever q's row has room
    ids = s.nbr_ids.numpy()
    full = (ids != P).all(1)
    for p in range(0, 256, 7):
        for q in ids[p][ids[p] != P]:
            assert p in ids[q] or full[q]


def _as_dict(ids, scores):
    return {int(i): float(s) for i, s in zip(np.asarray(ids), np.asarray(scores)) if int(i) != P}


def _source_world(seed=1):
    rng = np.random.default_rng(seed)
    U, A, D = 96, 40, 12
    follow = rng.integers(0, A, (U, D)).astype(np.int32)
    follow[rng.random((U, D)) < 0.25] = P
    follow[3] = P
    follow[4, :3] = 5
    follower = np.full((A, 32), P, np.int32)
    for a in range(A):
        fs = np.flatnonzero((follow == a).any(1))[:32]
        follower[a, : len(fs)] = fs
    sims_ids = rng.integers(0, A, (A, 8)).astype(np.int32)
    sims_ids[rng.random((A, 8)) < 0.3] = P
    sims_ids[2] = P
    sims_w = np.where(sims_ids != P, rng.random((A, 8)), 0).astype(np.float32)
    seeds = np.asarray([0, 5, 5, 2, 3, P, 39, 41, -1, P], np.int32)  # repeats, PAD, past the end, negative
    return follow, follower, sims_ids, sims_w, seeds


@pytest.mark.parametrize("k", [6, 64])
def test_device_sources_match_jax(k):
    follow, follower, sims_ids, sims_w, seeds = _source_world()
    cases = [
        (frs.similar_producers_candidates(known_for.Graph(_t(sims_ids), _t(sims_w)), _t(seeds), k),
         J_SIMILAR(jkf.Graph(jnp.asarray(sims_ids), jnp.asarray(sims_w)), jnp.asarray(seeds), k)),
        (frs.triangular_closure_candidates(_t(follow), _t(seeds), k),
         J_TRIANGULAR(jnp.asarray(follow), jnp.asarray(seeds), k)),
        (fc.salsa_candidates(_t(follow), _t(follower), _t(seeds), k),
         J_SALSA(jnp.asarray(follow), jnp.asarray(follower), jnp.asarray(seeds), k)),
        (fc.sims_expansion_candidates(_t(sims_ids), _t(sims_w), _t(seeds), k, second_hop_decay=0.3),
         J_EXPANSION(jnp.asarray(sims_ids), jnp.asarray(sims_w), jnp.asarray(seeds), k, 0.3)),
    ]
    for (ids, sc), (jids, jsc) in cases:
        assert ids.shape == jids.shape and ids.dtype == torch.int32
        jsc = np.asarray(jsc)
        assert_same_topk(ids.numpy()[None], np.where(np.isfinite(sc.numpy()), sc.numpy(), 0)[None],
                         np.asarray(jids)[None], np.where(np.isfinite(jsc), jsc, 0)[None], rtol=RTOL, atol=1e-7)
        assert len(_as_dict(ids, sc)) > 0


def test_device_sources_launch_once_a_hop(monkeypatch):
    """On the CPU the kernels run their plain versions; the launch pattern is
    what the wrappers are called with: a hop is one row_gather (both tables
    of the hop together), a source one run_collapse_sorted of one row."""
    follow, follower, sims_ids, sims_w, seeds = _source_world()
    calls = []
    rg, rc = gather.row_gather, seg_scan.run_collapse_sorted

    def count_rg(ids, *tables):
        calls.append(("rg", len(tables)))
        return rg(ids, *tables)

    def count_rc(ids, *values):
        assert ids.shape[0] == 1 and ids.dim() == 2
        calls.append(("rc", ids.shape[1]))
        return rc(ids, *values)

    monkeypatch.setattr(frs, "row_gather", count_rg)
    monkeypatch.setattr(fc, "row_gather", count_rg)
    from the_algorithm_tpu_torch.ops import retrieval
    monkeypatch.setattr(retrieval, "run_collapse_sorted", count_rc)
    S = seeds.size
    fc.salsa_candidates(_t(follow), _t(follower), _t(seeds), 8)
    assert calls == [("rg", 1), ("rg", 1), ("rc", S * 32 * 12)]
    calls.clear()
    fc.sims_expansion_candidates(_t(sims_ids), _t(sims_w), _t(seeds), 8)
    assert calls == [("rg", 2), ("rg", 2), ("rc", S * 8 + S * 64)]
    calls.clear()
    frs.similar_producers_candidates(known_for.Graph(_t(sims_ids), _t(sims_w)), _t(seeds), 8)
    frs.triangular_closure_candidates(_t(follow), _t(seeds), 8)
    assert calls == [("rg", 2), ("rc", S * 8), ("rg", 1), ("rc", S * 12)]


def _pad_rows(rows, width):
    out = np.full((len(rows), width), P, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return _t(out)


def test_oracle_cases():
    """tests/test_frs_catalog.py:26-57 and tests/test_frs_tsps_tlr.py:29-75."""
    follow = [[10, 11], [10, 12], [11], [12, 13]]
    follower = {10: [0, 1], 11: [0, 2], 12: [1, 3], 13: [3]}
    ids, scores = fc.salsa_candidates(_pad_rows(follow, 4), _pad_rows([follower.get(p, []) for p in range(14)], 4),
                                      torch.tensor([10, 11, P, P], dtype=torch.int32), 8)
    mass = {}
    for s in (10, 11):
        for u in follower[s]:
            for p2 in follow[u]:
                mass[p2] = mass.get(p2, 0.0) + 1.0 / len(follower[s]) / len(follow[u])
    got = _as_dict(ids, scores)
    assert set(got) == set(mass)
    for p2, m in mass.items():
        np.testing.assert_allclose(got[p2], m, rtol=1e-5)

    ids, w = _pad_rows([[1], [2], []], 2), torch.tensor([[0.8, 0], [0.5, 0], [0, 0]])
    d = _as_dict(*fc.sims_expansion_candidates(ids, w, torch.tensor([0, P], dtype=torch.int32), 4,
                                               second_hop_decay=0.5))
    np.testing.assert_allclose(d[1], 0.8, rtol=1e-6)
    np.testing.assert_allclose(d[2], 0.5 * 0.8 * 0.5, rtol=1e-6)

    sims_ids = np.full((8, 2), P, np.int32)
    sims_w = np.zeros((8, 2), np.float32)
    sims_ids[0], sims_w[0] = [1, 2], [0.9, 0.5]
    sims_ids[5], sims_w[5] = [6, P], [0.8, 0]
    got = _as_dict(*frs.similar_producers_candidates(known_for.Graph(_t(sims_ids), _t(sims_w)),
                                                     torch.tensor([0, 5], dtype=torch.int32), 4))
    assert got == pytest.approx({1: 0.9, 6: 0.8, 2: 0.5})

    adj = np.full((4, 2), P, np.int32)
    adj[1], adj[2] = [7, 8], [8, P]
    ids, counts = frs.triangular_closure_candidates(_t(adj), torch.tensor([1, 2], dtype=torch.int32), 4)
    assert _as_dict(ids, counts) == {8: 2.0, 7: 1.0} and int(ids[0]) == 8

    class Req:
        user_id, followed_set, blocked_set = 9, {1}, {2}

    flow = frs.RecommendationFlow(sources=[lambda r: [Candidate(id=i, score=float(i)) for i in [1, 2, 3, 9, 4]]],
                                  predicates=[frs.not_already_followed, frs.not_blocked, frs.not_self],
                                  max_results=2)
    assert [c.id for c in flow.run(Req())] == [4, 3]


@dataclasses.dataclass
class Request:
    user_id: int = 0
    followed_set: frozenset = frozenset({10, 11})
    blocked_set: frozenset = frozenset()
    excluded_ids: frozenset = frozenset()
    recent_engagement_ids: tuple = ()
    geo_id: int = None
    profile_user_id: int = None
    locale: str = None
    now: int = 1000


def _cands(out):
    return [(c.id, c.score, c.source, c.features) for c in out]


def test_host_sources_predicates_ranker_match_jax():
    req = [Request(), Request(user_id=1, geo_id=0, profile_user_id=0, locale="ja",
                              recent_engagement_ids=(6, 11, 16, 7)), Request(locale="xx", geo_id=5)]
    geo = (np.asarray([[1, 2]]), np.asarray([[1.0, 0.5]]), np.asarray([3, 4]), np.asarray([1.0, 0.5]))
    follows = {10: [40, 41], 11: [41, 0]}
    tables = {
        "RecentEngagementSource": ((lambda ids: ids % 5,), {}),
        "PopGeoSource": (geo, {}),
        "StpSource": ((np.asarray([[5, 6]]), np.asarray([[0.9, 0.2]], np.float32)), {}),
        "PpmiLocaleSource": (({"ja": (np.asarray([8]), np.asarray([0.7]))},), {}),
        "AddressBookSource": ((), dict(forward={0: [20, 21]}, reverse={0: [21, 22], 1: [3]})),
        "CrowdSearchAccountsSource": (({"global": (np.asarray([7]), np.asarray([1.0])),
                                        "ja": (np.asarray([8]), np.asarray([2.0]))},), {}),
        "PromotedAccountsSource": ((np.asarray([30, 31, 32]), np.asarray([0.1, 0.9, 0.5])), dict(max_results=2)),
        "SocialgraphSource": ((lambda u: follows.get(u, []),), {}),
        "TwoHopRandomWalkSource": ((np.asarray([[50, 51], [52, P]]), np.asarray([[0.9, 0.1], [0.3, -np.inf]])), {}),
    }
    for name, (args, kw) in tables.items():
        got, want = getattr(fc, name)(*args, **kw), getattr(jfc, name)(*args, **kw)
        for r in req:
            assert _cands(got.get(r, None)) == _cands(want.get(r, None)), name

    preds = [(fc.inactive_predicate(np.asarray([0, 990]), 100), jfc.inactive_predicate(np.asarray([0, 990]), 100)),
             (fc.health_predicate({3}), jfc.health_predicate({3})),
             (fc.excluded_ids_predicate(), jfc.excluded_ids_predicate()),
             (frs.not_already_followed, jfrs.not_already_followed), (frs.not_blocked, jfrs.not_blocked),
             (frs.not_self, jfrs.not_self)]
    store, jstore = fc.PreviouslyRecommendedStore(), jfc.PreviouslyRecommendedStore()
    for s in (store, jstore):
        s.record_shown(0, [5, 9])
        s.record_dismiss(0, 6)
        s.record_shown(1, [7])
    preds.append((store.predicate(), jstore.predicate()))
    rs = req + [Request(excluded_ids=frozenset({4}), blocked_set=frozenset({2}), now=2000)]
    for p, jp in preds:
        for r in rs:
            for i in range(-1, 13):
                assert p(r, Candidate(id=i)) == jp(r, JCandidate(id=i))

    feats = lambda r, cs: np.asarray([[c.id, len(c.features)] for c in cs], np.float32)  # noqa: E731
    predict = lambda f: 1.0 / (1.0 + np.exp(-f[:, 0] / 10.0 + f[:, 1]))  # noqa: E731
    got = [Candidate(id=i, features={"a": 1.0} if i % 2 else {}) for i in (1, 9, 4)]
    want = [JCandidate(id=c.id, features=dict(c.features)) for c in got]
    fc.ml_ranker(feats, lambda f: torch.from_numpy(predict(f)))(req[0], got)  # a tensor from the predict fn
    jfc.ml_ranker(feats, predict)(req[0], want)
    assert _cands(got) == _cands(want)
    fc.ml_ranker(feats, predict)(req[0], [])

    for every in (2, 4):
        org = [Candidate(id=i) for i in range(12)]
        pro = [Candidate(id=100 + i) for i in range(4)]
        jorg, jpro = [JCandidate(id=c.id) for c in org], [JCandidate(id=c.id) for c in pro]
        assert _cands(fc.interleave_promoted(org, pro, every)) == _cands(jfc.interleave_promoted(jorg, jpro, every))
    assert {k.name: v for k, v in fc.FlowCatalog.FLOW_SOURCES.items()} == \
        {k.name: v for k, v in jfc.FlowCatalog.FLOW_SOURCES.items()}
    assert {k.name: v for k, v in fc.FlowCatalog.FLOW_SIZE.items()} == \
        {k.name: v for k, v in jfc.FlowCatalog.FLOW_SIZE.items()}


def test_graph_sources_match_jax():
    """RealGraphSource and UserUserGraphSource over the same tables."""
    w = fw.build(SMALL, device="cpu")
    jtable = jrealgraph.EdgeTable(*(jnp.asarray(t.numpy()) for t in w.realgraph))
    jparams = {k: jnp.asarray(v) for k, v in realgraph.params_to_jax(w.rg_params).items()}
    juug = jgraphjet.UserUserGraph(*(jnp.asarray(t.numpy()) for t in w.uug))
    for u in (0, 5, 77, 600):
        r = w.request(u % SMALL.num_users)
        for got_src, want_src in ((fc.RealGraphSource(w.realgraph, w.rg_params, k=SMALL.top_k),
                                   jfc.RealGraphSource(jtable, jparams, k=SMALL.top_k)),
                                  (fc.UserUserGraphSource(w.uug, max_results=SMALL.top_k),
                                   jfc.UserUserGraphSource(juug, max_results=SMALL.top_k))):
            got, want = got_src.get(r, None), want_src.get(r, None)
            _same_flow(got, want)
            assert got


def _same_flow(got, want, rtol=FLOW_RTOL):
    """Two candidate lists: the same length; ranks apart only among
    near-ties; shared ids with the same source and features, scores at
    rtol; an id in one list only ties the last kept score."""
    assert len(got) == len(want)
    tol = lambda s: rtol * abs(s) + 1e-7  # noqa: E731
    for g, w in zip(got, want):
        if g.id != w.id:
            assert abs((g.score or 0.0) - (w.score or 0.0)) <= tol(w.score or 0.0), (g.id, w.id)
    gd, wd = {c.id: c for c in got}, {c.id: c for c in want}
    for i in gd.keys() & wd.keys():
        assert gd[i].source == wd[i].source, i
        assert sorted(gd[i].features) == sorted(wd[i].features), i
        for key, v in wd[i].features.items():
            np.testing.assert_allclose(gd[i].features[key], v, rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(gd[i].score or 0.0, wd[i].score or 0.0, rtol=rtol, atol=1e-7)
    if want:
        cut = min(c.score or 0.0 for c in want)
        for i in gd.keys() ^ wd.keys():
            c = gd.get(i, wd.get(i))
            assert abs((c.score or 0.0) - cut) <= tol(cut), i


def jax_catalog(w: fw.FrsWorld, store):
    """JAX's FlowCatalog over the port world's host copies: JAX's device
    functions and source classes, the same host tables, predicates and
    ranker."""
    jsims_g = jkf.Graph(jnp.asarray(w.sims_ids), jnp.asarray(w.sims_weights))
    follow_adj, follower_adj = jnp.asarray(w.follows), jnp.asarray(w.followers)
    jtable = jrealgraph.EdgeTable(*(jnp.asarray(t.cpu().numpy()) for t in w.realgraph))
    jparams = {k: jnp.asarray(v) for k, v in realgraph.params_to_jax(w.rg_params).items()}
    juug = jgraphjet.UserUserGraph(*(jnp.asarray(t.cpu().numpy()) for t in w.uug))
    k = w.shape.top_k

    def followed(r):
        ids = sorted(int(a) for a in r.followed_set)[: w.shape.follow_width]
        return jnp.asarray(np.asarray(ids + [P] * (w.shape.follow_width - len(ids)), np.int32))

    def wrap(name, fn):
        return lambda r: jfc._to_candidates(*fn(followed(r)), fw.SOURCE_NAMES[name])

    get = lambda src: (lambda r: src.get(r, None))  # noqa: E731
    follows = w.follows
    sources = {
        "sims": wrap("sims", lambda f: J_SIMILAR(jsims_g, f, k)),
        "sims_expansion": wrap("sims_expansion", lambda f: J_EXPANSION(jsims_g.nbr_ids, jsims_g.nbr_weights, f, k, 0.5)),
        "triangular": wrap("triangular", lambda f: J_TRIANGULAR(follow_adj, f, k)),
        "salsa": wrap("salsa", lambda f: J_SALSA(follow_adj, follower_adj, f, k)),
        "real_graph": get(jfc.RealGraphSource(jtable, jparams, k=k)),
        "user_user_graph": get(jfc.UserUserGraphSource(juug, max_results=k)),
        "recent_engagement": get(jfc.RecentEngagementSource(w.author_of, max_results=k)),
        "pop_geo": get(jfc.PopGeoSource(w.geo_ids, w.geo_scores, w.global_ids, w.global_scores)),
        "stp": get(jfc.StpSource(w.sims_ids, w.sims_weights)),
        "ppmi_locale": get(jfc.PpmiLocaleSource(w.ppmi)),
        "address_book": get(jfc.AddressBookSource(w.address_forward, w.address_reverse)),
        "crowd_search": get(jfc.CrowdSearchAccountsSource(w.crowd)),
        "promoted_accounts": get(jfc.PromotedAccountsSource(w.promoted_ids, w.promoted_bids)),
        "socialgraph": get(jfc.SocialgraphSource(lambda u: follows[u][follows[u] != P])),
        "two_hop_random_walk": get(jfc.TwoHopRandomWalkSource(w.walk_ids, w.walk_scores)),
    }
    return jfc.FlowCatalog(
        sources_by_name=sources,
        predicates=[jfrs.not_already_followed, jfrs.not_blocked, jfrs.not_self, jfc.excluded_ids_predicate(),
                    jfc.health_predicate(set(w.unsafe)), jfc.inactive_predicate(w.last_active), store.predicate()],
        ranker=jfc.ml_ranker(fw.follow_features, fw.follow_score))


def test_flows_match_jax():
    w = fw.build(SMALL, device="cpu")
    store, jstore = fc.PreviouslyRecommendedStore(), jfc.PreviouslyRecommendedStore()
    for s in (store, jstore):
        s.record_shown(3, [int(w.sims_ids[0, 0])])
        s.record_dismiss(3, 17)
    cat, jcat = w.catalog(store), jax_catalog(w, jstore)
    for loc in fc.DisplayLocation:
        flow, jflow = cat.flow(loc), jcat.flow(jfc.DisplayLocation[loc.name])
        assert len(flow.sources) == len(jflow.sources) == len(fc.FlowCatalog.FLOW_SOURCES[loc])
        for u in (3, 200, 511):
            r = w.request(u)
            got, want = flow.run(r), jflow.run(r)
            _same_flow(got, want)
            assert got, loc
            ids = {c.id for c in got}
            assert not ids & (r.followed_set | r.blocked_set | {u})
            assert len(got) <= fc.FlowCatalog.FLOW_SIZE[loc]


def test_world_launch_table():
    assert fw.flow_launches(fc.DisplayLocation.HOME_TIMELINE) == {"run_collapse": 5, "row_gather": 8}
    assert fw.flow_launches(fc.DisplayLocation.PROFILE_SIDEBAR) == {"run_collapse": 2, "row_gather": 2}
    w = fw.build(SMALL, device="cpu")
    assert w.followers.shape[1] % SMALL.follower_multiple == 0
    deg = np.bincount(w.follows[w.follows != P], minlength=SMALL.num_authors)
    assert ((w.followers != P).sum(1) == deg).all()
    assert (np.sort(w.follows, axis=1) == w.follows).all()


# -- the slice as a whole: For You with the real who-to-follow flow ---------------


def test_for_you_mixer_with_frs_flow_matches_jax():
    from test_torch_batched_foryou import A, NOW
    from test_torch_home_pipeline import MAX_RESULTS, SEEN, USERS, _for_you, _scoreless

    from the_algorithm_tpu.mixers import home_mixer as jhm
    from the_algorithm_tpu.mixers import home_products as jhp
    from the_algorithm_tpu.pipeline import urt as jurt
    from the_algorithm_tpu_torch.mixers import home_mixer as hm
    from the_algorithm_tpu_torch.mixers import home_products as hp
    from the_algorithm_tpu_torch.pipeline import urt

    w = fw.build(SMALL, device="cpu")
    docs = []
    for port in (True, False):
        pkg, mixer_pkg, Cand, u = (hp, hm, Candidate, urt) if port else (jhp, jhm, JCandidate, jurt)
        store = fc.PreviouslyRecommendedStore() if port else jfc.PreviouslyRecommendedStore()
        cat = w.catalog(store) if port else jax_catalog(w, store)
        loc = (fc if port else jfc).DisplayLocation.HOME_TIMELINE
        mixer = pkg.build_for_you_mixer(scored_tweets_pipeline=_for_you(port, False), wtf_flow=cat.flow(loc),
                                        ads=[Cand(id=7001, features={"advertiser_id": 55})], wtf_position=3)
        out = []
        for uid in USERS:
            q = mixer_pkg.ForYouQuery(user_id=uid, followed_authors=list(range(0, A, 5)), seen_tweet_ids=SEEN,
                                      max_results=MAX_RESULTS, now=NOW)
            r = w.request(uid)
            q.followed_set, q.blocked_set = r.followed_set, r.blocked_set
            out.append(u.marshal_timeline(mixer.run(q)).to_json())
        docs.append(out)
    for got, want in zip(*docs):
        (g, gs), (wd, ws) = _scoreless(got), _scoreless(want)
        np.testing.assert_allclose(gs, ws, rtol=FLOW_RTOL, atol=1e-6)
        ge = g["timeline"]["instructions"][0]["addEntries"]["entries"]
        we = wd["timeline"]["instructions"][0]["addEntries"]["entries"]
        assert [e["entryId"] for e in ge] == [e["entryId"] for e in we]
        for a, b in zip(ge, we):
            if a["content"]["kind"] == "module":
                ai, bi = a["content"]["module"]["items"], b["content"]["module"]["items"]
                assert len(ai) == len(bi) >= 2
                assert [x["id"] for x in ai] == [x["id"] for x in bi] or \
                    sorted(x["id"] for x in ai) == sorted(x["id"] for x in bi)
            assert a == b or a["content"]["kind"] == "module", a["entryId"]
        assert any(e["content"]["kind"] == "module" for e in ge)
