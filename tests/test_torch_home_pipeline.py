"""The port's per-request For You product (the_algorithm_tpu_torch/mixers/
{wide_hydrators, feature_hydrators, home_mixer, home_products}.py) against the
JAX package's, on the seeded world of test_torch_hydration.py and
test_torch_batched_foryou.py (seed 3, 32 users, 48 authors, 4,096 tweets).

Tolerances:

- every wide hydrator's columns and the narrow hydrators' features: integers
  exactly, floats at rtol 1e-6 (the port's world folds its aggregate stores
  and RealGraph counts itself, at rtol 1e-6 of JAX's: test_torch_hydration);
- ``build_for_you_pipeline`` with a small f32 MaskNet, without and with
  Phoenix and its loop: the same ids in the same order, scores and head
  probabilities at rtol 1e-5, atol 1e-6 (f32 sums in another order);
- the products and the registry: the same entries, and the same URT JSON but
  for the score in an item's metadata, held at rtol 1e-5;
- the port's per-request pipeline against the port's batched engine: the
  JAX test's bounds (tests/test_batched_foryou.py:147-157): each shared id's
  score within 1e-5, and ranks apart only among scores within 2e-6.

Candidates carry creation times below 1,000 s, as in the batched tests:
bench.py's ~1e7-second times squeeze the random ranker's scores to a few
ulps, where summation orders rank near-ties apart.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batched_foryou import A, HEADS, NOW, WEIGHTS, WORLD, fixed_sources, lift
from test_torch_phoenix import SMALL as PHOENIX_SMALL

from the_algorithm_tpu.features import aggregation as jagg
from the_algorithm_tpu.mixers import batched_foryou as jbf
from the_algorithm_tpu.mixers import feature_hydrators as jfh
from the_algorithm_tpu.mixers import feature_schema as jfs
from the_algorithm_tpu.mixers import home_mixer as jhm
from the_algorithm_tpu.mixers import home_products as jhp
from the_algorithm_tpu.mixers import phoenix_loop as jpl
from the_algorithm_tpu.mixers import phoenix_scorer as jps
from the_algorithm_tpu.mixers import wide_hydrators as jwh
from the_algorithm_tpu.models import masknet as jmasknet
from the_algorithm_tpu.models import phoenix as jphoenix
from the_algorithm_tpu.pipeline import component as jcomp
from the_algorithm_tpu.pipeline import urt as jurt
from the_algorithm_tpu.search import earlybird as jeb
from the_algorithm_tpu_torch.features import aggregation
from the_algorithm_tpu_torch.mixers import batched_foryou as bf
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import feature_hydrators as fh
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.mixers import home_mixer as hm
from the_algorithm_tpu_torch.mixers import home_products as hp
from the_algorithm_tpu_torch.mixers import phoenix_loop as pl
from the_algorithm_tpu_torch.mixers import phoenix_scorer as ps
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.models import masknet, phoenix
from the_algorithm_tpu_torch.ops import gather
from the_algorithm_tpu_torch.pipeline import component as comp
from the_algorithm_tpu_torch.pipeline import urt
from the_algorithm_tpu_torch.search import earlybird

FOLD_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-6
PAIR_TOL, TIE_TOL = 1e-5, 2e-6  # tests/test_batched_foryou.py:147-157
USERS = (2, 7, 11)
MAX_RESULTS = 20
SEEN = frozenset({101, 205})
CAND_W = dict(num_heads=4, mask_blocks=1, block_dim=32, aggregation_dim=16, head_hidden=(16,), dtype="float32")


@functools.lru_cache(maxsize=None)
def _worlds():
    """(JAX world, the port's world without its device spec, that spec)."""
    jworld = jwh.synthetic_world(**WORLD)
    world = wh.synthetic_world(**WORLD, device="cpu")
    spec = world.pop("device_spec")
    return jworld, world, spec


def _candidates(Cand, seed=0, n=40):
    """Candidates with every key the catalog reads: missing and -1 authors,
    an id of -1, topic/language/media/conversation keys, four sources."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = {"author_id": int(rng.integers(-1, A)), "topic_id": int(rng.integers(0, 16)), "language_id": i % 8,
             "media_type": i % 4, "conversation_id": int(rng.integers(0, 4096)),
             "retrieval_score": float(rng.random()), "social_proof": i % 3, "engager_id": i % 32,
             "mentioned_user_id": i % 7, "created_ts": NOW - i * 100}
        if i % 2:
            f["original_author_id"] = i % 5
        if i == 5:
            del f["author_id"]
        source = ["DirectUteg", "EarlybirdInNetwork", "simclusters_interested_in", "not_a_source"][i % 4]
        out.append(Cand(id=int(rng.integers(0, 5000)) if i else -1, features=f, source=source))
    return out


def _queries():
    jq = jhm.ForYouQuery(user_id=7, followed_authors=[1, 5, 9, 14], now=NOW)
    q = hm.ForYouQuery(user_id=7, followed_authors=[1, 5, 9, 14], now=NOW)
    for x in (jq, q):
        x.list_id = 2
        x.served_tweet_ids = [3, 4]
        x.refresh_count = 2
    return jq, q


def _same_columns(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer) or np.array_equal(g, w):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=FOLD_RTOL, atol=0, err_msg=k)


@functools.lru_cache(maxsize=None)
def _catalogs():
    jworld, world, _ = _worlds()
    return jwh.build_wide_hydrators(**jworld), wh.build_wide_hydrators(**world)


N_HYDRATORS = 34  # 15 keyed crosses, 18 families, the viewer's InterestedIn projection


@pytest.mark.parametrize("i", range(N_HYDRATORS))
def test_wide_hydrator_columns_match_jax(i):
    jcat, cat = _catalogs()
    assert len(jcat) == len(cat) == N_HYDRATORS
    jh, h = jcat[i], cat[i]
    assert h.name == jh.name
    jq, q = _queries()
    jc, c = _candidates(jcomp.Candidate), _candidates(comp.Candidate)
    ids = np.asarray([x.id for x in c], np.int64)
    _same_columns(h.hydrate_columns(q, ids, c, None), jh.hydrate_columns(jq, ids, jc, None))


def test_wide_catalog_fills_the_schema_and_assembles_as_jax():
    """Every spec of WIDE_SCHEMA (6,823 columns) is filled, at its width, and
    the assembled [B, F] matrix is JAX's."""
    jcat, cat = _catalogs()
    jq, q = _queries()
    jc, c = _candidates(jcomp.Candidate, seed=1), _candidates(comp.Candidate, seed=1)
    for hyd, query, cands in ((jcat, jq, jc), (cat, q, c)):
        for h in hyd:
            h.hydrate(query, cands, None)
    store = fs.peek_store(q)
    assert len(fs.WIDE_SCHEMA) == 5831 and fs.total_width(fs.WIDE_SCHEMA) == 6823
    names = set(store.names())
    for spec in fs.WIDE_SCHEMA:
        assert spec.name in names, spec.name
    ids = np.asarray([x.id for x in c], np.int64)
    assert store.gather(fs.WIDE_SCHEMA[0].name, ids).shape == (len(c),)
    got = hm.FeatureMatrixAssembler(fs.WIDE_SCHEMA)(q, c)
    want = jhm.FeatureMatrixAssembler(jfs.WIDE_SCHEMA)(jq, jc)
    assert got.shape == want.shape == (len(c), 6823)
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=0)


def test_keyed_tables_read_in_one_multiget_per_group(monkeypatch):
    """The TwHIN and embedding-table hydrators of a request read the viewer,
    author and tweet groups once each, three 16-byte-row tables to a group:
    three row_gather launches on the card."""
    _, cat = _catalogs()
    calls = []
    real = gather.multiget

    def recording(group, key):
        calls.append((sorted(group), tuple(key.shape), gather.launch_groups(group)))
        return real(group, key)

    monkeypatch.setattr(gather, "multiget", recording)
    for _ in range(2):  # two requests
        q = _queries()[1]
        c = _candidates(comp.Candidate, seed=2)
        for h in cat:
            h.hydrate(q, c, None)
    assert len(calls) == 6
    assert [names for names, _, _ in calls[:3]] == [
        ["twhin_user", "twhin_user_negative", "user_interests_emb"],
        ["author_agg_emb", "twhin_author", "twhin_author_follow"],
        ["media_clip_clusters", "text_emb", "twhin_tweet"]]
    assert [shape for _, shape, _ in calls[:3]] == [(1,), (40,), (40,)]
    assert all(len(launches) == 1 for _, _, launches in calls)


def test_masknet_predict_fn_is_the_sigmoid_heads():
    F = 24
    model = masknet.MaskNet(masknet.MaskNetConfig(num_features=F, **CAND_W), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).normal(size=(5, F)).astype(np.float32)
    got = masknet.predict_fn(model)(x)
    with torch.inference_mode():
        want = torch.sigmoid(model(torch.from_numpy(x))).numpy()
    assert got.dtype == np.float32 and got.shape == (5, 4)
    np.testing.assert_array_equal(got, want)


# -- the narrow hydrators (mixers/feature_hydrators.py) ---------------------------


class _Q:
    def __init__(self, user_id=7, now=NOW):
        self.user_id, self.now, self.features = user_id, now, {}


def _narrow(pkg, world, Cand):
    """Every narrow hydrator and side effect of ``pkg`` over ``world``: the
    candidates' features, the query features and the side effects' output."""
    cands = _candidates(Cand, seed=3, n=24)
    for x in cands:
        x.score = 0.5 + x.id / 1e4
        x.features["predicted_fav"] = 0.25
    q = _Q()
    docs = {c.id: {"fav_count": 3.0, "reply_count": 1.0} for c in cands[::3]}
    pkg.EarlybirdFeatureHydrator(docs).hydrate(q, cands, None)
    pkg.EarlybirdFeatureHydrator(lambda ids: {"retweet_count": ids * 0.5, "created_ts": ids + 7}).hydrate(
        q, cands, None)
    pkg.RealGraphFeatureHydrator(lambda uid, a: a * 0.25 + uid).hydrate(q, cands, None)
    pkg.TweepcredFeatureHydrator(world["tweepcred"]).hydrate(q, cands, None)
    pkg.GraphFeatureServiceHydrator(world["gfs_tables"]).hydrate(q, cands, None)
    pkg.SimClustersEngagementSimilarityFeatureHydrator(world["tweet_embedding_fn"],
                                                       world["engagement_fn"]).hydrate(q, cands, None)
    pkg.TwhinEmbeddingFeatureHydrator(world["twhin_user"], world["twhin_tweet"],
                                      world["twhin_user_negative"]).hydrate(q, cands, None)
    store, resolver = world["author_agg"]
    group = (jwh if pkg is jfh else wh).make_aggregate_group("author_agg")
    pkg.AggregatesFeatureHydrator(group, store, resolver, prefix="a_").hydrate(q, cands, None)
    query_feats = pkg.RecentEngagementsQueryHydrator(world["signal_store"]).hydrate(q, None)
    lines, events = [], []
    pkg.ScribeServedCandidatesSideEffect(lines.append).run(q, cands[:5], None)
    pkg.ScribeClientEventSideEffect(events.append).run(q, cands[:5], None)
    bloom = pkg.ImpressionBloomFilterSideEffect()
    bloom.run(q, cands[:5], None)
    seen = [bloom.seen(7, c.id) for c in cands] + [bloom.seen(8, cands[0].id)]
    return ([(c.id, c.features) for c in cands], {k: np.asarray(v) for k, v in query_feats.items()},
            lines, events, seen, bloom.filters[7].bits)


def test_narrow_hydrators_and_side_effects_match_jax():
    jworld, world, _ = _worlds()
    got, want = _narrow(fh, world, comp.Candidate), _narrow(jfh, jworld, jcomp.Candidate)
    for (gi, gf), (wi, wf) in zip(got[0], want[0]):
        assert gi == wi and list(gf) == list(wf)
        for k in wf:
            np.testing.assert_allclose(gf[k], wf[k], rtol=FOLD_RTOL, atol=0, err_msg=k)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert got[2:5] == want[2:5]
    np.testing.assert_array_equal(got[5], want[5])


def test_bloom_filter_matches_jax():
    b, jb = fh.BloomFilter(n_bits=1 << 10, n_hashes=5), jfh.BloomFilter(n_bits=1 << 10, n_hashes=5)
    for k in (-1, 0, 7, 2 ** 40 + 3, 123456789):
        b.add(k)
        jb.add(k)
    np.testing.assert_array_equal(b.bits, jb.bits)
    assert [k in b for k in range(-5, 300)] == [k in jb for k in range(-5, 300)]


def test_aggregates_hydrator_reads_as_jax_on_a_fresh_store():
    """The JAX test's case (tests/test_feature_hydrators.py:114-139): one
    event a half-life ago reads 0.5; an unknown key reads 0."""
    out = []
    for agg, pkg, Cand, arr in ((jagg, jfh, jcomp.Candidate, jnp.asarray),
                                (aggregation, fh, comp.Candidate, torch.as_tensor)):
        group = agg.AggregateGroup(name="author_agg", features=("fav_count",), labels=("any",),
                                   metrics=("count", "sum"), half_lives_s=(86400.0,))
        kw = {} if agg is jagg else {"device": "cpu"}
        store = agg.init_store(group, capacity=8, **kw)
        resolver = agg.KeyResolver(capacity=8)
        rows = resolver.resolve([(100,)])
        store = agg.update(group, store, arr(rows), arr(np.asarray([[3.0]], np.float32)),
                           arr(np.asarray([[1.0]], np.float32)), arr(np.asarray([0], np.int32)))
        cands = [Cand(id=0, features={"author_id": 100}), Cand(id=1, features={"author_id": 999})]
        pkg.AggregatesFeatureHydrator(group, store, resolver).hydrate(_Q(now=86400), cands, None)
        out.append([c.features for c in cands])
    assert out[0] == out[1]


# -- build_for_you_pipeline -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models():
    """The small f32 MaskNet of the batched tests (JAX's init, carried across)
    and a small f32 Phoenix, each as (JAX predict, the port's predict)."""
    F = jfs.total_width(jfs.WIDE_SCHEMA)
    jmodel = jmasknet.MaskNet(jmasknet.MaskNetConfig(num_features=F, **CAND_W))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, F)))  # eager init's params, one compile
    model = masknet.MaskNet(masknet.MaskNetConfig(num_features=F, **CAND_W), device="cpu")
    model.load_state_dict(masknet.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    predict = jax.jit(lambda x: jax.nn.sigmoid(jmodel.apply(params, x)))

    L = PHOENIX_SMALL["max_history"]
    jpx = jphoenix.PhoenixModel(jphoenix.PhoenixConfig(**PHOENIX_SMALL, dtype="float32"))
    seq = jphoenix.UserActionSequence(*(jnp.zeros(L, dt) for dt in (jnp.int32, jnp.int32, jnp.int32, bool)))
    cands = jphoenix.CandidateFeatures(jnp.zeros(4, jnp.int32), jnp.zeros((4, jphoenix.NUM_BOOL_FEATURES)),
                                       jnp.ones(4, bool))
    pparams = jax.jit(jpx.init)(jax.random.PRNGKey(1), seq, cands)
    px = phoenix.PhoenixModel(phoenix.PhoenixConfig(**PHOENIX_SMALL, dtype="float32"), device="cpu")
    px.load_state_dict(phoenix.params_from_flax(pparams))

    phx = jax.jit(lambda ua, c: jphoenix.predict_next_actions(jpx, pparams, ua, c))

    def jax_phoenix(a, b, v, ua):  # candidates padded to one shape (each reads the history alone)
        n, P = len(a), 128
        c = jphoenix.CandidateFeatures(jnp.asarray(np.pad(a, (0, P - n))), jnp.asarray(np.pad(b, ((0, P - n), (0, 0)))),
                                       jnp.asarray(np.pad(v, (0, P - n))))
        return np.asarray(phx(ua, c))[:n]

    def jax_predict(x):  # rows padded to one shape: one compile (MaskNet's rows are independent)
        pad = np.zeros((-(-x.shape[0] // 128) * 128, x.shape[1]), np.float32)
        pad[:x.shape[0]] = x
        return np.asarray(predict(jnp.asarray(pad)))[:x.shape[0]]

    return ((jax_predict, masknet.predict_fn(model)),
            (jax_phoenix, phoenix.scorer_predict_fn(px)), model)


def _events(uid):
    """A user's raw action events: (ts_ms, action id, author hash)."""
    rng = np.random.default_rng(100 + uid)
    n = 40
    return list(zip((NOW * 1000 - rng.integers(0, 3 * 86400 * 1000, n)).tolist(),
                    rng.integers(1, phoenix.NUM_ACTIONS, n).tolist(), rng.integers(0, A, n).tolist()))


def _object_sources(pkg_bf, pkg_comp):
    """Each fixed batch source as a per-request candidate source, as the JAX
    test wraps them (tests/test_batched_foryou.py:89-106), with small
    creation times, and with the in-network flag the batched engine sets at
    retrieval (the_algorithm_tpu/mixers/batched_foryou.py:194-195), which the
    JAX test's wrapper leaves out: at these creation times that flag alone
    moves the small model's scores by up to 8.5e-4."""
    attach = lift(pkg_bf)

    class ObjSource(pkg_comp.CandidateSource):
        def __init__(self, batch_src):
            self._bs = batch_src

        @property
        def name(self):
            return self._bs.name

        def get(self, query, params):
            cc = self._bs.get_batch([query], params)[0]
            if self._bs.name in ("EarlybirdInNetwork", "FollowingEarlybird"):
                cc.cols["is_in_network"] = np.ones(len(cc), np.float32)
            cc = attach(cc)
            return [pkg_comp.Candidate(id=int(cc.ids[i]), source=self._bs.name,
                                       features={n: v[i].item() for n, v in cc.cols.items()})
                    for i in range(len(cc))]

    return [pkg_comp.CandidatePipeline(ObjSource(s)) for s in fixed_sources(pkg_bf)]


def _for_you(port: bool, with_phoenix: bool):
    jworld, world, _ = _worlds()
    (jpredict, predict), (jphx, phx), _ = _models()
    pkg, wide, bfm, cm, fhm, psm, plm, phm = (
        (hm, wh, bf, comp, fh, ps, pl, phoenix) if port else (jhm, jwh, jbf, jcomp, jfh, jps, jpl, jphoenix))
    kw = {}
    if with_phoenix:
        dev = {"device": "cpu"} if port else {}
        kw = dict(query_hydrators=[fhm.UserActionsQueryHydrator(_events, max_length=PHOENIX_SMALL["max_history"],
                                                                **dev)],
                  phoenix_scorer=psm.PhoenixScorer(phx if port else jphx),
                  phoenix_rescoring_store=plm.PhoenixScoreStore())
    return pkg.build_for_you_pipeline(
        candidate_pipelines=_object_sources(bfm, cm),
        hydrators=wide.build_wide_hydrators(**(world if port else jworld)),
        predict_fn=predict if port else jpredict, head_names=HEADS,
        head_weights=WEIGHTS if port else jnp.asarray(WEIGHTS),
        feature_schema=(fs if port else jfs).WIDE_SCHEMA, max_tweet_age_s=10 ** 9, **kw)


def _serve(pipe, pkg, passes=1):
    outs = []
    for _ in range(passes):
        for u in USERS:
            q = pkg.ForYouQuery(user_id=u, followed_authors=list(range(0, A, 5)), seen_tweet_ids=SEEN,
                                max_results=MAX_RESULTS, now=NOW)
            outs.append(pipe.run(q))
    return outs


def _same_served(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert not g.failures and not w.failures, (g.failures, w.failures)
        assert g.removed == w.removed
        assert [c.id for c in g.candidates] == [c.id for c in w.candidates]
        assert 0 < len(g.candidates) <= MAX_RESULTS
        np.testing.assert_allclose([c.score for c in g.candidates], [c.score for c in w.candidates],
                                   rtol=RTOL, atol=ATOL)
        for c, d in zip(g.candidates, w.candidates):
            assert c.source == d.source and sorted(c.features) == sorted(d.features)
            for n, v in d.features.items():
                if isinstance(v, float):
                    np.testing.assert_allclose(c.features[n], v, rtol=RTOL, atol=ATOL, err_msg=n)
                else:
                    assert c.features[n] == v, n


@pytest.mark.parametrize("with_phoenix", [False, True], ids=["masknet", "masknet_phoenix_loop"])
def test_for_you_pipeline_matches_jax(with_phoenix):
    """Three users (twice with Phoenix: the second pass reads the loop's
    store) through both packages' ``build_for_you_pipeline``."""
    passes = 2 if with_phoenix else 1
    got = _serve(_for_you(True, with_phoenix), hm, passes)
    want = _serve(_for_you(False, with_phoenix), jhm, passes)
    _same_served(got, want)
    for out in got:
        assert all(set(f"predicted_{h}" for h in HEADS) <= set(c.features) for c in out.candidates)
        assert not set(c.id for c in out.candidates) & SEEN
    if with_phoenix:
        assert all(any(k.startswith("phoenix_") for k in c.features) for out in got for c in out.candidates)
        assert any(c.features.get("phoenix_reranked") for out in got[len(USERS):] for c in out.candidates)


def test_per_request_pipeline_matches_the_batched_engine():
    """The port's pipeline against the port's batched engine on the same
    world and model (the JAX package's test_batched_matches_per_request_pipeline)."""
    _, world, spec = _worlds()
    tables, fns, res = dh.build_from_world(world, spec)
    model = _models()[2]
    engine = bf.BatchedForYouEngine(
        batch_sources=fixed_sources(bf), head_names=HEADS, lift=lift(bf), max_age_s=10 ** 9,
        scorer=dh.DeviceHydrationScorer(tables, fns, res, model, WEIGHTS, pad_b=128, compute_dtype=torch.float32))
    queries = [hm.ForYouQuery(user_id=u, followed_authors=list(range(0, A, 5)), seen_tweet_ids=SEEN,
                              max_results=MAX_RESULTS, now=NOW) for u in USERS]
    got = engine.serve_batch(queries)
    pipe = _for_you(True, False)
    for q, cands in zip(queries, got):
        want = pipe.run(q)
        assert not want.failures, want.failures
        got_s = {c.id: c.score for c in cands}
        want_s = {c.id: c.score for c in want.candidates}
        for i in got_s.keys() & want_s.keys():
            assert abs(got_s[i] - want_s[i]) < PAIR_TOL, (i, got_s[i], want_s[i])
        for r, (g, w) in enumerate(zip([c.id for c in cands], [c.id for c in want.candidates])):
            if g != w:
                assert abs(want_s[w] - want_s.get(g, got_s[g])) < TIE_TOL, (r, g, w)
        assert not set(got_s) & SEEN and 0 < len(cands) <= q.max_results


# -- the products and the registry (mixers/home_products.py) ---------------------


def _index_arrays():
    n = 10
    return dict(tokens=np.stack([jeb.tokenize(f"tweet number {i}", 4) for i in range(n)]),
                authors=np.asarray([10, 11, 12, 13, 10, 11, 99, 10, 12, 11], np.int32),
                ts=np.arange(100, 100 + n * 10, 10).astype(np.int32),
                feats=np.zeros((n, len(jeb.DOC_FEATURES)), np.float32),
                ids=np.arange(2001, 2001 + n).astype(np.int32))


def _index(port):
    a = _index_arrays()
    if port:
        index = earlybird.init_index(earlybird.EarlybirdConfig(capacity=32, max_tokens=4), device="cpu")
        return earlybird.ingest(index, *(torch.from_numpy(a[k]) for k in ("tokens", "authors", "ts", "feats", "ids")))
    index = jeb.init_index(jeb.EarlybirdConfig(capacity=32, max_tokens=4))
    return jeb.ingest(index, *(jnp.asarray(a[k]) for k in ("tokens", "authors", "ts", "feats", "ids")))


class _Flow:
    """A who-to-follow stand-in: any object with ``.run(request)``."""

    def __init__(self, Cand, n=4):
        self.Cand, self.n = Cand, n

    def run(self, request):
        return [self.Cand(id=900 + i, score=1.0 - 0.1 * i, features={"author_follows_viewer": 1})
                for i in range(self.n)]


class _EditChains:
    def __init__(self, edits):
        self.edits = edits

    def is_stale(self, tid):
        return tid in self.edits

    def latest(self, tid):
        return self.edits[tid]


def _resolver(Cand):
    """Replies: 2004 → 2002 → 2001, 2008 → 2003."""
    parents = {2004: 2002, 2002: 2001, 2008: 2003}

    def chain(c):
        out, tid = [c], c.id
        while tid in parents:
            tid = parents[tid]
            out.insert(0, Cand(id=tid, features={"author_id": 1}))
        return out

    return chain


def _products(port):
    """Every product, registered, each run once and marshalled."""
    pkg, Cand, u = (hp, comp.Candidate, urt) if port else (jhp, jcomp.Candidate, jurt)
    index = _index(port)
    ads = [Cand(id=7001, features={"advertiser_id": 55}), Cand(id=7002)]
    reg = pkg.HomeProductPipelineRegistry()
    reg.register("following", pkg.build_following_pipeline(
        index=index, conversation_resolver=_resolver(Cand), wtf_flow=_Flow(Cand), ads=ads,
        edit_chains=_EditChains({2003: 9003}), wtf_position=2, ad_spacing=3))
    reg.register("subscribed", pkg.build_subscribed_pipeline(index=index))
    reg.register("list_tweets", pkg.build_list_tweets_pipeline(index=index, list_members={5: [11, 12]}, ads=ads))
    reg.register("list_recommended_users", pkg.build_list_recommended_users_pipeline(wtf_flow=_Flow(Cand, 25)))
    queries = {
        "following": [pkg.TimelineQuery(user_id=10, followed_authors=[11, 12], served_tweet_ids=[2003],
                                        max_results=10, last_polling_ts=130),
                      pkg.TimelineQuery(user_id=10, followed_authors=[11, 12, 13], since_id=2002, max_id=2009,
                                        max_results=3)],
        "subscribed": [pkg.TimelineQuery(user_id=10, subscribed_authors=[13, 99], max_results=5)],
        "list_tweets": [pkg.TimelineQuery(user_id=10, list_id=5, max_results=8),
                        pkg.TimelineQuery(user_id=10, list_id=6)],
        "list_recommended_users": [pkg.TimelineQuery(user_id=10)],
    }
    out = {}
    for name, qs in queries.items():
        out[name] = [u.marshal_timeline(reg.get(name).run(q)).to_json() for q in qs]
    try:
        reg.get("for_you")
    except KeyError as e:
        out["unknown"] = str(e)
    out["products"] = reg.products()
    return out


def test_products_and_registry_match_jax():
    got, want = _products(True), _products(False)
    assert got == want
    following = json.loads(got["following"][0])["timeline"]["instructions"]
    assert [list(i)[0] for i in following] == ["addEntries", "replaceEntry", "showAlert"]


def _scoreless(doc):
    """A URT JSON document with each item's ``metadata.score`` taken out:
    (the rest, the scores in order)."""
    scores = []

    def walk(x):
        if isinstance(x, dict):
            if "metadata" in x and "score" in x["metadata"]:
                scores.append(x["metadata"].pop("score"))
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    d = json.loads(doc)
    walk(d)
    return d, scores


def test_for_you_mixer_matches_jax():
    """``build_for_you_mixer`` over each package's scored pipeline (MaskNet,
    Phoenix and the loop), with a who-to-follow stand-in, two ads and an
    edited tweet: the same entries and URT JSON."""
    outs = []
    for port in (True, False):
        pkg, mixer_pkg, Cand, u = (hp, hm, comp.Candidate, urt) if port else (jhp, jhm, jcomp.Candidate, jurt)
        mixer = pkg.build_for_you_mixer(
            scored_tweets_pipeline=_for_you(port, True), wtf_flow=_Flow(Cand),
            ads=[Cand(id=7001, features={"advertiser_id": 55}), Cand(id=7002)],
            edit_chains=_EditChains({101: 9101}), wtf_position=3)
        docs = []
        for _ in range(2):
            for uid in USERS:
                q = mixer_pkg.ForYouQuery(user_id=uid, followed_authors=list(range(0, A, 5)),
                                          seen_tweet_ids=SEEN, max_results=MAX_RESULTS, now=NOW)
                q.served_tweet_ids = [101]
                docs.append(u.marshal_timeline(mixer.run(q)).to_json())
        outs.append(docs)
    for got, want in zip(*outs):
        (g, gs), (w, ws) = _scoreless(got), _scoreless(want)
        assert g == w
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
        kinds = [e["content"]["kind"] for e in g["timeline"]["instructions"][0]["addEntries"]["entries"]]
        assert "module" in kinds and any(e["entryId"].startswith("promoted-tweet-")
                                         for e in g["timeline"]["instructions"][0]["addEntries"]["entries"])
