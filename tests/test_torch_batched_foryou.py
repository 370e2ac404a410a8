"""The port's batched For You engine and its scorer
(the_algorithm_tpu_torch/mixers/{batched_foryou, device_hydration}.py)
against the JAX package's, on the same seeded world and the same f32 MaskNet
(flax params carried across by ``params_from_flax``).

Ranked ids are compared exactly, in order; scores and head probabilities at
rtol 1e-5 (the model's f32 sums run in another order on each side). The
candidate sources are the JAX package's test doubles (fixed per-user ids)
and, on a small For You world, the ported earlybird and UTEG sources.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.graph import uteg as ju
from the_algorithm_tpu.mixers import batched_foryou as jbf
from the_algorithm_tpu.mixers import device_hydration as jdh
from the_algorithm_tpu.mixers import feature_schema as jfs
from the_algorithm_tpu.mixers import home_mixer as jhm
from the_algorithm_tpu.mixers import wide_hydrators as jwh
from the_algorithm_tpu.models import masknet as jmasknet
from the_algorithm_tpu.search import earlybird as je
from the_algorithm_tpu_torch.data import foryou_world
from the_algorithm_tpu_torch.mixers import batched_foryou as bf
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import home_mixer as hm
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig, RequestBatcher

NOW = 10_000_000
A = 48
WORLD = dict(seed=3, num_users=32, num_authors=A, num_tweets=1 << 12, engagement_width=8, now=NOW)
PB = 128
TOP_K = 20
HEADS = [f"h{i}" for i in range(4)]
WEIGHTS = [1.0, 2.0, -0.5, 0.25]
RTOL, ATOL = 1e-5, 1e-6
# a small For You candidate world: earlybird docs of 48 authors, a UTEG graph
SMALL = foryou_world.ForYouShape(num_users=64, num_authors=A, eb_docs=1024, events_per_user=6, tweet_space=600,
                                 uteg_width=8, seeds=4, follows=12, follow_width=16, utg_sources=8)


@functools.lru_cache(maxsize=None)
def _setup():
    """Both packages' worlds, models and scorers (host-rescore and
    device-select), and the small For You world."""
    jworld = jwh.synthetic_world(**WORLD, include_device_spec=True)
    jspec = jworld.pop("device_spec")
    jtables, jfns, jres = jdh.build_from_world(jworld, jspec)
    world = wh.synthetic_world(**WORLD, device="cpu")
    spec = world.pop("device_spec")
    tables, fns, res = dh.build_from_world(world, spec)

    F = jfs.total_width(jfs.WIDE_SCHEMA)
    cfg = dict(num_features=F, num_heads=4, mask_blocks=1, block_dim=32, aggregation_dim=16, head_hidden=(16,),
               dtype="float32")
    jmodel = jmasknet.MaskNet(jmasknet.MaskNetConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, F)))
    model = masknet.MaskNet(masknet.MaskNetConfig(**cfg), device="cpu")
    model.load_state_dict(masknet.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))

    def jscorer(k):
        return jdh.DeviceHydrationScorer(jtables, jfns, jres, jmodel, params, jnp.asarray(WEIGHTS), pad_b=PB,
                                         compute_dtype=jnp.float32, select_top_k=k)

    def scorer(k):
        return dh.DeviceHydrationScorer(tables, fns, res, model, WEIGHTS, pad_b=PB, compute_dtype=torch.float32,
                                        select_top_k=k)

    return {"jax": {None: jscorer(None), TOP_K: jscorer(TOP_K)}, "torch": {None: scorer(None), TOP_K: scorer(TOP_K)},
            "fy": foryou_world.build(SMALL, users=4)}


def fixed_source(pkg, name, base, n):
    """The JAX package's test double (tests/test_batched_foryou.py): per-user
    candidate ids with some overlap across sources, for either package."""

    class FixedBatchSource(pkg.BatchCandidateSource):
        def get_batch(self, queries, params):
            return [pkg.CandidateColumns(
                (base + 37 * int(q.user_id) + 13 * np.arange(n, dtype=np.int64)) % 4000 + 1,
                (1.0 / (1 + np.arange(n))).astype(np.float32)) for q in queries]

    src = FixedBatchSource()
    src.name = name
    return src


def fixed_sources(pkg):
    return [fixed_source(pkg, "simclusters_interested_in", 100, 40), fixed_source(pkg, "EarlybirdInNetwork", 120, 30),
            fixed_source(pkg, "DirectUteg", 140, 20), fixed_source(pkg, "TweetMixer", 160, 25)]


def query(pkg, u, follows=None):
    return pkg.ForYouQuery(user_id=u, followed_authors=list(range(0, A, 5)) if follows is None else follows,
                           seen_tweet_ids=frozenset({101, 205}), max_results=TOP_K, now=NOW)


def lift(pkg):
    """``ColumnsLift``, but with small creation times (and the engine's age
    filter opened to match): bench.py's ~1e7-second timestamps dominate the
    ranker's input layer norm and squeeze the random model's scores to within
    a few float32 ulps of each other, where two summation orders rank apart."""
    base = pkg.ColumnsLift(A, NOW)

    def attach(c):
        c.cols.setdefault("created_ts", c.ids % 1000)
        return base(c)

    return attach


def engines(sources_for, select):
    s = _setup()
    k = TOP_K if select else None
    return tuple(pkg.BatchedForYouEngine(batch_sources=sources_for(name), scorer=s[name][k], head_names=HEADS,
                                         lift=lift(pkg), max_age_s=10 ** 9)
                 for name, pkg in (("jax", jbf), ("torch", bf)))


def assert_same_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.id for c in g] == [c.id for c in w]
        assert 0 < len(g) <= TOP_K
        np.testing.assert_allclose([c.score for c in g], [c.score for c in w], rtol=RTOL, atol=0)
        for c, d in zip(g, w):
            assert set(c.features) == set(d.features)
            for n in c.features:
                np.testing.assert_allclose(c.features[n], d.features[n], rtol=RTOL, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("select", [False, True], ids=["host_rescore", "device_select"])
def test_engine_with_fixed_sources_matches_jax(select):
    jeng, eng = engines(lambda pkg: fixed_sources(jbf if pkg == "jax" else bf), select)
    users = (2, 7, 11)
    want = jeng.serve_batch([query(jhm, u) for u in users])
    got = eng.serve_batch([query(hm, u) for u in users])
    assert_same_lists(got, want)
    for g in got:
        assert not {c.id for c in g} & {101, 205}  # seen ids filtered



def test_scorer_columnar_paths_match_jax():
    """score_columnar (all candidates' probs and combined scores) and
    select_columnar (the device-selected top-K) on the same columnar batch."""
    s = _setup()
    _, eng = engines(lambda pkg: fixed_sources(bf), False)
    _, batch = eng.columns([query(hm, u) for u in (1, 4, 9, 30)])
    jbatch = [(query(jhm, q.user_id), cols, n) for q, cols, n in batch]
    for (gp, gc), (wp, wc), (_, _, n) in zip(s["torch"][None].score_columnar(batch),
                                             s["jax"][None].score_columnar(jbatch), batch):
        assert gp.shape == (n, 4) and gc.shape == (n,)
        np.testing.assert_allclose(gp, wp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gc, wc, rtol=RTOL, atol=0)
    for (gi, gs, gp), (wi, ws, wp) in zip(s["torch"][TOP_K].select_columnar(batch),
                                          s["jax"][TOP_K].select_columnar(jbatch)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=0)
        np.testing.assert_allclose(gp, wp, rtol=RTOL, atol=ATOL)


def _small_sources(pkg):
    """The ported earlybird and UTEG sources (or the JAX package's) over the
    small For You world, beside a fixed SANN-like leg."""
    fy = _setup()["fy"]
    arrays = (fy.eb_tokens, fy.eb_author, fy.eb_created, fy.eb_features, fy.eb_tweet_ids)
    seeds = lambda u: fy.seeds[u % SMALL.num_users]  # noqa: E731
    if pkg == "jax":
        graph = ju.record_engagements(ju.init_graph(SMALL.num_users, width=SMALL.uteg_width), fy.ev_users,
                                      fy.ev_tweets, fy.ev_types, fy.ev_ts)
        index = je.EarlybirdIndex(*(jnp.asarray(a) for a in arrays), jnp.int32(SMALL.eb_docs))
        return [fixed_source(jbf, "simclusters_interested_in", 100, 40),
                jbf.EarlybirdBatchSource(index, foryou_world.NOW, max_results=60, follow_width=SMALL.follow_width),
                jbf.UtegBatchSource(graph, seeds, max_results=50, n_seeds=SMALL.seeds)]
    return [fixed_source(bf, "simclusters_interested_in", 100, 40),
            bf.EarlybirdBatchSource(foryou_world.earlybird_index(fy, "cpu"), foryou_world.NOW, max_results=60,
                                    follow_width=SMALL.follow_width),
            bf.UtegBatchSource(foryou_world.engagement_graph(fy, "cpu"), seeds, max_results=50, n_seeds=SMALL.seeds)]


@pytest.mark.parametrize("select", [False, True], ids=["host_rescore", "device_select"])
def test_engine_with_earlybird_and_uteg_sources_matches_jax(select):
    fy = _setup()["fy"]
    follows = [[int(a) for a in row if a != PAD_ID] for row in fy.follows]
    jeng, eng = engines(_small_sources, select)
    users = (3, 8, 21)
    want = jeng.serve_batch([query(jhm, u, follows[i]) for i, u in enumerate(users)])
    got = eng.serve_batch([query(hm, u, follows[i]) for i, u in enumerate(users)])
    assert_same_lists(got, want)
    # every leg contributed: in-network candidates carry the flag, UTEG's its proof
    merged, _ = eng.columns([query(hm, u, follows[i]) for i, u in enumerate(users)])
    for c in merged:
        assert (c.cols["is_in_network"] == 1).any() and (c.cols["social_proof"] > 0).any()


def test_device_select_matches_host_rescore():
    """The on-device diversity rescore + top-K ranks like the host path."""
    _, host = engines(lambda pkg: fixed_sources(bf), False)
    _, dev = engines(lambda pkg: fixed_sources(bf), True)
    queries = [query(hm, u) for u in (3, 9)]
    for h, d in zip(host.serve_batch(queries), dev.serve_batch(queries)):
        assert [c.id for c in h] == [c.id for c in d]
        np.testing.assert_allclose([c.score for c in h], [c.score for c in d], rtol=RTOL)
        assert "predicted_h0" in d[0].features


def test_source_precedence_first_wins():
    """An id retrieved by two sources keeps the FIRST pipeline's columns."""

    class Overlap(bf.BatchCandidateSource):
        def __init__(self, name, score):
            self.name = name
            self._score = score

        def get_batch(self, queries, params):
            return [bf.CandidateColumns(np.asarray([500, 600]), np.asarray([self._score] * 2, np.float32))
                    for _ in queries]

    s = _setup()
    eng = bf.BatchedForYouEngine(batch_sources=[Overlap("simclusters_interested_in", 0.9),
                                                Overlap("EarlybirdInNetwork", 0.1)],
                                 scorer=s["torch"][None], head_names=HEADS, lift=bf.ColumnsLift(A, NOW))
    by_id = {c.id: c for c in eng.serve_batch([query(hm, 1)])[0]}
    assert set(by_id) == {500, 600}
    assert by_id[500].features["retrieval_score"] == pytest.approx(0.9)
    assert by_id[500].features["is_in_network"] == 0.0


def test_columns_helpers_match_jax():
    parts = [([5, 3, 5], [0.1, 0.2, 0.3], {"author_id": [1, 2, 3]}), ([3, 9], [0.5, 0.6], {"social_proof": [2, 1]}),
             ([], [], {})]
    got = bf.dedup_first_wins(bf.CandidateColumns.concat(
        [bf.CandidateColumns(np.asarray(i, np.int64), np.asarray(s), {k: np.asarray(v) for k, v in c.items()})
         for i, s, c in parts]))
    want = jbf.dedup_first_wins(jbf.CandidateColumns.concat(
        [jbf.CandidateColumns(np.asarray(i, np.int64), np.asarray(s), {k: np.asarray(v) for k, v in c.items()})
         for i, s, c in parts]))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert set(got.cols) == set(want.cols)
    for n in got.cols:
        np.testing.assert_array_equal(got.cols[n], want.cols[n])


def test_request_batcher_coalesces_engine_batches():
    """The serving front shares one serve_batch call among concurrent
    requests, and answers each with its own list."""
    _, eng = engines(lambda pkg: fixed_sources(bf), True)
    calls = []

    def serve(queries):
        calls.append(len(queries))
        return eng.serve_batch(queries)

    front = RequestBatcher(serve, BatcherConfig(max_batch_size=8, max_delay_ms=50.0), n_workers=2)
    try:
        with ThreadPoolExecutor(max_workers=6) as ex:
            outs = list(ex.map(lambda u: front.serve(query(hm, u), timeout=60), range(6)))
    finally:
        front.close()
    assert all(len(o) > 0 for o in outs) and max(calls) > 1
    alone = eng.serve_batch([query(hm, 4)])[0]
    assert [c.id for c in outs[4]] == [c.id for c in alone]


def test_score_requests_matches_jax():
    """The scorer's object-model path (per-candidate request building)."""
    from the_algorithm_tpu.pipeline.component import Candidate as JCandidate
    from the_algorithm_tpu_torch.pipeline.component import Candidate

    s = _setup()
    rng = np.random.default_rng(8)
    batch, jbatch = [], []
    for u in (2, 5, 6, 19):
        n = int(rng.integers(30, 150))
        ids = rng.integers(1, 1 << 20, n)
        feats = [{"author_id": int(i % A), "created_ts": int(i % 1000), "topic_id": int(i % 16),
                  "retrieval_score": float(rng.random())} for i in ids]
        src = ["simclusters_interested_in", "DirectUteg", "TweetMixer"]
        batch.append((query(hm, u), [Candidate(id=int(i), features=f, source=src[j % 3])
                                     for j, (i, f) in enumerate(zip(ids, feats))]))
        jbatch.append((query(jhm, u), [JCandidate(id=int(i), features=f, source=src[j % 3])
                                       for j, (i, f) in enumerate(zip(ids, feats))]))
    for (gp, gc), (wp, wc), (_, c) in zip(s["torch"][None].score_requests(batch),
                                          s["jax"][None].score_requests(jbatch), batch):
        assert gp.shape == (min(len(c), PB), 4)
        np.testing.assert_allclose(gp, wp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gc, wc, rtol=RTOL, atol=0)
