"""The port's hydration tier (the_algorithm_tpu_torch/{ops/sparse, features/*,
graph/realgraph, mixers/{feature_schema, wide_hydrators, device_hydration}}.py)
against the JAX package's on the same seeded numpy world.

Tolerances: numpy draws and host folds (USS rings, GFS rows, resolvers) are
bit-exact; the float folds (aggregate stores, RealGraph counts) are float32
sums and exp2 decays taken in another order or by another library: rtol
1e-6. The assembled [R, PB, 6,823] block is held per schema family at rtol
1e-5, atol 1e-6 (sums of ≤ 16 terms and exp2/log1p/sqrt of them), PAD rows
included; one-hot, count, copied and id columns come out exact anyway.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.features import aggregation as jagg
from the_algorithm_tpu.features import graph_features as jgf
from the_algorithm_tpu.features import representation_scorer as jrsx
from the_algorithm_tpu.features import user_signals as jus
from the_algorithm_tpu.graph import realgraph as jrg
from the_algorithm_tpu.mixers import device_hydration as jdh
from the_algorithm_tpu.mixers import feature_schema as jfs
from the_algorithm_tpu.mixers import wide_hydrators as jwh
from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu_torch.features import aggregation, graph_features, user_signals
from the_algorithm_tpu_torch.features import representation_scorer as rsx
from the_algorithm_tpu_torch.graph import realgraph
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.mixers.home_mixer import ForYouQuery
from the_algorithm_tpu_torch.ops import sparse
from the_algorithm_tpu_torch.pipeline.component import Candidate

NOW = 10_000_000
A = 48
WORLD = dict(seed=3, num_users=32, num_authors=A, num_tweets=1 << 12, engagement_width=8, now=NOW)
PB = 64
FOLD_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _worlds():
    """(JAX tables, fns, resolvers, port tables, fns, resolvers, port world)."""
    jworld = jwh.synthetic_world(**WORLD, include_device_spec=True)
    jspec = jworld.pop("device_spec")
    world = wh.synthetic_world(**WORLD, device="cpu")
    spec = world.pop("device_spec")
    return (*jdh.build_from_world(jworld, jspec), *dh.build_from_world(world, spec), world)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


EXACT_TABLES = ["doc_table", "rg_nbr_ids", "rg_last_ts", "rg_w", "rg_b", "twhin_user", "twhin_author", "twhin_tweet",
                "twhin_user_negative", "twhin_author_follow", "eng_ids", "eng_type", "eng_ts", "eng_valid",
                "user_interests", "author_agg_emb", "media_clip", "text_emb", "agg_last_ts", "uss_ids", "uss_ts",
                "gfs_neighbors", "tweepcred", "author_meta"]


@pytest.mark.parametrize("name", EXACT_TABLES)
def test_world_tables_equal_jax(name):
    jt, _, _, t, _, _, _ = _worlds()
    got, want = getattr(t, name), getattr(jt, name)
    for g, w in (zip(got, want) if isinstance(got, tuple) else [(got, want)]):
        np.testing.assert_array_equal(_np(g), np.asarray(w).astype(_np(g).dtype))


@pytest.mark.parametrize("name", ["rg_counts", "agg_values"])
def test_world_folded_stores_match_jax(name):
    jt, _, _, t, _, _, _ = _worlds()
    got, want = getattr(t, name), getattr(jt, name)
    for g, w in (zip(got, want) if isinstance(got, tuple) else [(got, want)]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=FOLD_RTOL, atol=0)


def test_world_resolvers_equal_jax():
    _, _, jres, _, _, res, _ = _worlds()
    assert list(res) == list(jres)
    for name in res:
        assert res[name]._map == jres[name]._map, name
        keys = list(jres[name]._map)[:5] + [(-7,), (-7, 3)]
        k0 = np.asarray([k[0] for k in keys[:5]])
        k1 = None if len(keys[0]) == 1 else np.asarray([k[1] for k in keys[:5]])
        np.testing.assert_array_equal(res[name].lookup(keys), jres[name].lookup(keys))
        np.testing.assert_array_equal(res[name].lookup_vec(k0, k1), jres[name].lookup_vec(k0, k1))


def test_synthetic_formulas_match_jax():
    _, jfns, _, _, fns, _, _ = _worlds()
    ids = np.asarray([[0, 1, 4095, 77_777, PAD_ID, -3]], np.int32)
    for g, w in zip(fns.tweet_emb(torch.from_numpy(ids)), jfns.tweet_emb(jnp.asarray(ids))):
        np.testing.assert_array_equal(_np(g), np.asarray(w))  # PAD's int32 product wraps alike
    authors = np.asarray([-1, 0, 7, 8, 47, -7], np.int32)
    np.testing.assert_array_equal(
        fns.author_follows_viewer(torch.tensor([3]), torch.from_numpy(authors)).numpy(),
        np.asarray(jfns.author_follows_viewer(jnp.asarray([3]), jnp.asarray(authors))))


def test_source_names_equal_jax():
    assert fs.candidate_source_names() == jfs.candidate_source_names()
    assert [(s.name, s.width) for s in fs.WIDE_SCHEMA] == [(s.name, s.width) for s in jfs.WIDE_SCHEMA]
    assert fs.total_width(fs.WIDE_SCHEMA) == 6823


# -- the sparse similarity block (ops/sparse.py:121-264) ------------------------------


def _embeddings(seed, n, k, clusters=12):
    """[n, k] embeddings with repeats across rows, a PAD tail in some rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, clusters, (n, k)).astype(np.int32)
    ids[::3, k - 2:] = PAD_ID
    scores = np.where(ids != PAD_ID, rng.random((n, k)), 0.0).astype(np.float32)
    return ids, scores


SIM_OPS = ["dot", "cosine", "log_norm_cosine", "exp_scaled_cosine", "jaccard", "fuzzy_jaccard", "euclidean",
           "manhattan"]


@pytest.mark.parametrize("op", SIM_OPS)
def test_pairwise_similarity_matches_jax(op):
    a_ids, a_sc = _embeddings(1, 7, 6)
    b_ids, b_sc = _embeddings(2, 5, 6)
    got = sparse.pairwise_matrix(getattr(sparse, op),
                                 sparse.SparseEmbedding(torch.from_numpy(a_ids), torch.from_numpy(a_sc)),
                                 sparse.SparseEmbedding(torch.from_numpy(b_ids), torch.from_numpy(b_sc)))
    want = js.pairwise_matrix(getattr(js, op), js.SparseEmbedding(jnp.asarray(a_ids), jnp.asarray(a_sc)),
                              js.SparseEmbedding(jnp.asarray(b_ids), jnp.asarray(b_sc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("capacity", [3, 8, 14])
def test_add_and_scale_match_jax(capacity):
    a_ids, a_sc = _embeddings(3, 4, 6, clusters=8)
    b_ids, b_sc = _embeddings(4, 4, 6, clusters=8)
    got = sparse.add(sparse.SparseEmbedding(torch.from_numpy(a_ids), torch.from_numpy(a_sc)),
                     sparse.SparseEmbedding(torch.from_numpy(b_ids), torch.from_numpy(b_sc)), capacity)
    for r in range(4):
        want = js.add(js.SparseEmbedding(jnp.asarray(a_ids[r]), jnp.asarray(a_sc[r])),
                      js.SparseEmbedding(jnp.asarray(b_ids[r]), jnp.asarray(b_sc[r])), capacity)
        np.testing.assert_array_equal(got.ids[r].numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.scores[r].numpy(), np.asarray(want.scores), rtol=RTOL, atol=ATOL)
    s = sparse.scale(got, 0.3)
    np.testing.assert_allclose(s.scores.numpy(), np.asarray(js.scale(js.SparseEmbedding(
        jnp.asarray(got.ids.numpy()), jnp.asarray(got.scores.numpy())), 0.3).scores), rtol=1e-7)


# -- features/* and graph/realgraph -------------------------------------------------


def test_rsx_engagement_features_match_jax():
    c_ids, c_sc = _embeddings(5, 9, 8)
    e_ids, e_sc = _embeddings(6, 11, 8)
    rng = np.random.default_rng(7)
    types = rng.integers(0, len(rsx.SIGNAL_TYPES), 11).astype(np.int32)
    ts = rng.integers(NOW - 9 * 86400, NOW, 11).astype(np.int32)
    valid = rng.random(11) < 0.8
    got = rsx.engagement_similarity_features(
        sparse.SparseEmbedding(torch.from_numpy(c_ids), torch.from_numpy(c_sc)),
        rsx.EngagementSet(sparse.SparseEmbedding(torch.from_numpy(e_ids), torch.from_numpy(e_sc)),
                          torch.from_numpy(types), torch.from_numpy(ts), torch.from_numpy(valid)),
        NOW, kinds=rsx.SIMILARITY_KINDS)
    want = jrsx.engagement_similarity_features(
        js.SparseEmbedding(jnp.asarray(c_ids), jnp.asarray(c_sc)),
        jrsx.EngagementSet(js.SparseEmbedding(jnp.asarray(e_ids), jnp.asarray(e_sc)), jnp.asarray(types),
                           jnp.asarray(ts), jnp.asarray(valid)),
        jnp.int32(NOW), kinds=jrsx.SIMILARITY_KINDS)
    assert list(got) == list(want) == list(rsx.feature_names(rsx.SIMILARITY_KINDS))
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=RTOL, atol=ATOL, err_msg=name)


def test_graph_feature_block_matches_jax():
    _, _, _, t, _, _, world = _worlds()
    nbrs = world["gfs_tables"].neighbors
    cands = np.asarray([0, 5, 31, 7, 7, 12], np.int32)
    for uid in (0, 9, 31):
        got = graph_features.feature_block(graph_features.GraphTables(nbrs), uid, torch.from_numpy(cands))
        want = jgf.feature_block(jgf.GraphTables(jnp.asarray(nbrs.numpy())), jnp.int32(uid), jnp.asarray(cands))
        assert list(got) == list(want)
        for name in got:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-7)


def test_user_signals_record_and_fetch_match_jax():
    rng = np.random.default_rng(11)
    n = 200
    ev = (rng.integers(0, 6, n), rng.integers(0, len(user_signals.SignalType), n), rng.integers(0, 999, n),
          np.sort(rng.integers(NOW - 5000, NOW, n)))
    got = user_signals.record(user_signals.init_store(6, width=5, device="cpu"), *ev)
    want = jus.record(jus.init_store(6, width=5), *ev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kinds = [user_signals.SignalType.TWEET_FAVORITE, user_signals.SignalType.RETWEET]
    for uid in range(6):
        g = user_signals.fetch_engagement_tweets(got, uid, kinds, min_timestamp=NOW - 2500)
        w = jus.fetch_engagement_tweets(want, jnp.int32(uid), [jus.SignalType(int(k)) for k in kinds],
                                        min_timestamp=jnp.int32(NOW - 2500))
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregation_update_with_repeated_rows_matches_jax(seed):
    """Two batches into one store, rows repeated inside each batch, every
    metric (the set metrics' last-qualifying-event rule included)."""
    group = aggregation.AggregateGroup("g", features=("a", "b"), labels=("x", "y", "z"), metrics=aggregation.METRICS,
                                       half_lives_s=(600.0, 86400.0))
    jgroup = jagg.AggregateGroup("g", features=("a", "b"), labels=("x", "y", "z"), metrics=jagg.METRICS,
                                 half_lives_s=(600.0, 86400.0))
    rng = np.random.default_rng(seed)
    store = aggregation.init_store(group, 10, device="cpu")
    jstore = jagg.init_store(jgroup, 10)
    t0 = NOW - 4000
    for b in range(2):
        rows = rng.integers(0, 6, 40).astype(np.int32)
        rows[:8] = 3  # one row hit eight times
        fv = rng.normal(0, 2, (40, 2)).astype(np.float32)
        lv = (rng.random((40, 3)) < 0.5).astype(np.float32)
        ts = np.sort(rng.integers(t0 + 1000 * b, t0 + 1000 * (b + 1), 40)).astype(np.int32)
        store = aggregation.update(group, store, torch.from_numpy(rows), torch.from_numpy(fv),
                                   torch.from_numpy(lv), torch.from_numpy(ts))
        jstore = jagg.update(jgroup, jstore, jnp.asarray(rows), jnp.asarray(fv), jnp.asarray(lv), jnp.asarray(ts))
        np.testing.assert_allclose(store.values.numpy(), np.asarray(jstore.values), rtol=FOLD_RTOL, atol=1e-6)
        np.testing.assert_array_equal(store.last_ts.numpy(), np.asarray(jstore.last_ts))
    rows = np.asarray([3, 0, 9, 3], np.int32)
    np.testing.assert_allclose(aggregation.read(group, store, torch.from_numpy(rows), NOW).numpy(),
                               np.asarray(jagg.read(jgroup, jstore, jnp.asarray(rows), jnp.int32(NOW))),
                               rtol=FOLD_RTOL, atol=1e-6)
    assert aggregation._layout(group)(1, 2, 3, 1) == jagg._layout(jgroup)(1, 2, 3, 1)
    assert group.output_names() == jgroup.output_names()


def test_realgraph_eviction_matches_jax():
    """Degree 3 rows fed more distinct neighbours than fit: the weakest edge
    goes, by decayed total (all distinct here); matches, empties and the
    decay as the JAX scan does."""
    rng = np.random.default_rng(4)
    n = 120
    src = rng.integers(0, 5, n).astype(np.int32)
    dst = rng.integers(0, 9, n).astype(np.int32)
    it = rng.integers(0, len(realgraph.INTERACTION_TYPES), n).astype(np.int32)
    ts = np.sort(rng.integers(NOW - 60 * 86400, NOW, n)).astype(np.int32)
    got = realgraph.apply_interactions(realgraph.init_table(5, 3, device="cpu"), src, dst, it, ts)
    want = jrg.apply_interactions(jrg.init_table(5, 3), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(it),
                                  jnp.asarray(ts))
    np.testing.assert_array_equal(got.neighbor_ids.numpy(), np.asarray(want.neighbor_ids))
    np.testing.assert_array_equal(got.last_ts.numpy(), np.asarray(want.last_ts))
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts), rtol=FOLD_RTOL, atol=0)
    feats = realgraph.edge_features(got, NOW)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jrg.edge_features(want, jnp.int32(NOW))), rtol=FOLD_RTOL)
    w = np.random.default_rng(5).normal(0, 0.3, len(realgraph.INTERACTION_TYPES)).astype(np.float32)
    got_p = realgraph.predict_edge_scores({"w": torch.from_numpy(w), "b": torch.tensor(0.2)}, feats)
    want_p = jrg.predict_edge_scores({"w": jnp.asarray(w), "b": jnp.float32(0.2)}, jnp.asarray(feats.numpy()))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=RTOL)


# -- device_hydration -------------------------------------------------------------


def _candidates(n, seed, sources=("simclusters_interested_in", "EarlybirdInNetwork", "DirectUteg", "TweetMixer")):
    """Object-model candidates; "TweetMixer" is no catalog source (one-hot
    all zeros); author -1 and missing features on some."""
    rng = np.random.default_rng(seed)
    cands = []
    for i in range(n):
        tid = int(rng.integers(1, 1 << 20)) if i % 5 else int(rng.integers(0, 4096))  # some hit tweet_agg
        feats = {"retrieval_score": float(rng.random()), "social_proof": float(i % 3),
                 "author_id": tid % A if i % 7 else -1, "created_ts": NOW - (tid % 86400),
                 "topic_id": tid % 16, "language_id": tid % 8, "media_type": tid % 4,
                 "conversation_id": tid // 2, "is_in_network": float(i % 2)}
        cands.append(Candidate(id=tid, source=sources[i % len(sources)], features=feats))
    return cands


def _queries():
    return [ForYouQuery(user_id=5, followed_authors=list(range(0, A, 5)), now=NOW),
            ForYouQuery(user_id=30, followed_authors=[1, 2, 40], now=NOW - 3 * 3600 - 17)]


@functools.lru_cache(maxsize=None)
def _assembled():
    """(port [R, PB, F], JAX [R, PB, F], port requests, JAX requests) for two
    requests: 37 candidates (PAD rows after them) and 80 (cut to PB)."""
    jt, jfns, jres, t, fns, res, _ = _worlds()
    batch = list(zip(_queries(), [_candidates(37, 9), _candidates(80, 10)]))
    jb = jdh.HostRequestBuilder(jres, pad_b=PB)
    b = dh.HostRequestBuilder(res, pad_b=PB)
    jreq = jdh.batch_requests([jb.build(q, c) for q, c in batch])
    req = dh.batch_requests([b.build(q, c) for q, c in batch])
    want = jax.jit(lambda tt, r: jdh.assemble(tt, jfns, r, n_sources=jb.n_sources))(
        jt, jax.tree_util.tree_map(jnp.asarray, jreq))
    treq = dh.DeviceRequests(*(torch.from_numpy(a) for a in req))
    got = dh.assemble(t, fns, treq, n_sources=b.n_sources, agg_packed=t.agg_packed)
    return got.numpy(), np.asarray(want), req, jreq


def _family_ranges():
    """(family, start, end) per contiguous run of a schema name prefix."""
    out, col, cur, start = [], 0, None, 0
    for s in fs.WIDE_SCHEMA:
        fam = s.name.split("_")[0]
        if fam != cur:
            if cur is not None:
                out.append((cur, start, col))
            cur, start = fam, col
        col += s.width
    out.append((cur, start, col))
    return out


def test_request_builders_match_jax():
    _, _, req, jreq = _assembled()
    for name, g, w in zip(req._fields, req, jreq):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (req.source_idx == -1).any() and (req.author_ids[:, :37] == -1).any()


@pytest.mark.parametrize("family,start,end", _family_ranges())
def test_assemble_matches_jax_by_family(family, start, end):
    got, want, _, _ = _assembled()
    assert got.shape == want.shape == (2, PB, fs.total_width(fs.WIDE_SCHEMA))
    np.testing.assert_allclose(got[..., start:end], want[..., start:end], rtol=RTOL, atol=ATOL,
                               err_msg=f"{family} columns {start}:{end}")


def test_agg_packed_read_equals_unpacked():
    _, _, _, t, fns, res, _ = _worlds()
    _, _, req, _ = _assembled()
    treq = dh.DeviceRequests(*(torch.from_numpy(a) for a in req))
    n = len(fs.candidate_source_names())
    packed = dh.assemble(t, fns, treq, n_sources=n, agg_packed=t.agg_packed)
    plain = dh.assemble(t, fns, treq, n_sources=n)
    assert torch.equal(packed, plain)


def test_agg_stores_packed_once_and_shared():
    """build_from_world packs the stores once, each store a view into the
    pack; scorers read that pack, and ``to`` packs the copy again."""
    _, _, _, t, fns, res, _ = _worlds()
    pack = t.agg_packed
    for i, (v, last) in enumerate(zip(t.agg_values, t.agg_last_ts)):
        assert v.untyped_storage().data_ptr() == pack.values.untyped_storage().data_ptr()
        assert last.untyped_storage().data_ptr() == pack.last_ts.untyped_storage().data_ptr()
        assert torch.equal(pack.values[int(pack.offsets[i]):int(pack.offsets[i]) + v.shape[0]], v)
    scorers = [dh.DeviceHydrationScorer(t, fns, res, None, None, pad_b=PB) for _ in range(2)]
    assert all(s.tables.agg_packed is pack for s in scorers)
    moved = t.to("cpu")
    assert moved.agg_packed is not pack
    for g, w in zip(moved.agg_packed, pack):
        assert torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip(moved.agg_values, t.agg_values))


def test_multiget_launch_groups():
    """Every keyed table read through the multiget: 16-byte rows in launches
    of up to three, the 4-byte rows (rg_last, tweepcred, agg last_ts) apart."""
    _, _, _, t, _, _, _ = _worlds()
    launches = []
    for (flavor, cap), group in dh.keyed_table_plan(t).items():
        groups = dh.launch_groups({n: dh._as_rows(x) for n, x in group.items()})
        assert sorted(n for g in groups for n in g) == sorted(group)
        launches += groups
    agg = t.agg_packed
    launches += dh.launch_groups({"av": agg.values, "al": dh._as_rows(agg.last_ts)})
    assert all(1 <= len(g) <= 3 for g in launches)
    assert ["rg_last"] in launches and ["tweepcred"] in launches and ["al"] in launches
    assert len(launches) == 15


@pytest.mark.parametrize("compact", [False, True])
def test_pack_unpack_requests_match_jax(compact):
    _, _, _, _, _, res, _ = _worlds()
    _, _, jres, _, _, _, _ = _worlds()
    batch = list(zip(_queries(), [_candidates(37, 9), _candidates(200, 10)]))
    req = dh.batch_requests([dh.HostRequestBuilder(res, pad_b=128).build(q, c) for q, c in batch])
    jreq = jdh.batch_requests([jdh.HostRequestBuilder(jres, pad_b=128).build(q, c) for q, c in batch])
    packed = dh.pack_requests(req, compact_rows=compact)
    want = jdh.pack_requests(jreq, compact_rows=compact)
    n_meta = 5 + 4 + 64 + 4  # the metadata column's written rows (JAX leaves the rest unset)
    np.testing.assert_array_equal(packed[..., :-1], want[..., :-1])
    np.testing.assert_array_equal(packed[:, :n_meta, -1], want[:, :n_meta, -1])
    got = dh.unpack_requests(torch.from_numpy(packed), 64, compact_rows=compact)
    want = jdh.unpack_requests(jnp.asarray(packed), 64, compact_rows=compact)
    for name, g, w, r in zip(got._fields, got, want, req):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


@pytest.mark.parametrize("decay,floor", [(0.5, 0.25), (0.7, 0.1)])
def test_diversity_select_matches_jax(decay, floor):
    """Tied scores (steps of 1/8), -inf and PAD slots, unknown and repeated
    authors; k covers slots past the last valid one."""
    rng = np.random.default_rng(12)
    R, P, k = 3, 40, 30
    combined = (rng.integers(0, 6, (R, P)) / 8).astype(np.float32)
    combined[0, 3] = -np.inf
    authors = rng.integers(-1, 5, (R, P)).astype(np.int32)
    ids = rng.integers(0, 10_000, (R, P)).astype(np.int32)
    ids[1, 25:] = PAD_ID
    ids[2, ::4] = PAD_ID
    got = dh.diversity_select(torch.from_numpy(combined), torch.from_numpy(authors), torch.from_numpy(ids), k,
                              decay=decay, floor=floor)
    want = jdh.diversity_select(jnp.asarray(combined), jnp.asarray(authors), jnp.asarray(ids), k,
                                decay=decay, floor=floor)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-7)
    assert np.isneginf(got[2].numpy()).any()


def test_assemble_features_matches_jax():
    """The scorer's object-model debug path: one request's [B, F] block."""
    jt, jfns, jres, t, fns, res, _ = _worlds()
    q, cands = _queries()[0], _candidates(23, 13)
    got = dh.DeviceHydrationScorer(t, fns, res, None, None, pad_b=PB).assemble_features(q, cands)
    want = jdh.DeviceHydrationScorer(jt, jfns, jres, model=None, params=None, head_weights=None,
                                     pad_b=PB).assemble_features(q, cands)
    assert got.shape == want.shape == (23, fs.total_width(fs.WIDE_SCHEMA))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_columnar_feature_store_matches_jax():
    """The host copy of the columnar store: blocks keyed by id, assembled in
    schema order with zeros for absent ids and names and width fixes."""
    rng = np.random.default_rng(14)
    schema = [fs.FeatureSpec("a"), fs.FeatureSpec("v", 3), fs.FeatureSpec("missing", 2), fs.FeatureSpec("w", 4),
              fs.FeatureSpec("b")]
    ids = rng.permutation(20)[:12]
    cols = {"a": rng.random(12), "v": rng.random((12, 3)), "w": rng.random((12, 2))}
    block = rng.random((7, 1))
    stores = []
    for mod in (fs, jfs):
        store = mod.ColumnarFeatureStore()
        store.add(ids, cols)
        store.add_block(ids[:7], ["b"], block)
        stores.append(store)
    want_ids = np.concatenate([ids[::-1], [99, 100]])
    np.testing.assert_array_equal(stores[0].assemble(want_ids, schema), stores[1].assemble(want_ids, schema))
    np.testing.assert_array_equal(stores[0].gather("v", want_ids), stores[1].gather("v", want_ids))
    assert fs.expand(schema) == jfs.expand(schema) and stores[0].names() == stores[1].names()
