"""The port's partitioned candidate sources against the JAX package's on
meshes of the same shape (1x4, 2x2, 1x2, 1x1): earlybird's
``search_sharded`` (relevance with the default and a custom ranking, a
model score that ties whole classes of docs, recency), a SuperRoot whose
realtime tier is partitioned over the mesh, and GFS's ``shard_tables`` /
``feature_block_sharded`` — mirroring tests/test_search.py:99 and
tests/test_features.py:229,256.

The port runs on 4 gloo ranks (tests/torch_mesh_ranks.py, once for the
file), JAX on a sub-mesh of its 8 CPU devices. Ranked ids are exact, tie
order included (the merge ranks the gathered lists in shard order, then
ring slot, as ``lax.top_k``); scores at rtol 1e-5 / atol 1e-5 as
tests/test_torch_earlybird.py holds the single index (the corpus statistics
are whole-number float32 sums over the partitions, exact; the per-doc
score's float32 sums run in another order). GFS counts and the sharded
adjacency are exact; the normalized features at rtol 1e-6. The SuperRoot
over a partitioned tier is held to JAX's over the same tier unsharded,
which JAX's own test holds equal to its sharded scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_earlybird import RELEVANCE, corpus
from torch_mesh_programs import SEARCH_CASES
from torch_mesh_ranks import run_ranks
from torch_port_util import PAD_ID

from the_algorithm_tpu.core.mesh import MeshSpec, make_mesh
from the_algorithm_tpu.features import graph_features as jgf
from the_algorithm_tpu.search import earlybird as je
from the_algorithm_tpu.search import root as jrt

KEYS = ["1x4", "2x2", "1x2", "1x1"]
RTOL = ATOL = 1e-5
GFS_RTOL = 1e-6
F = len(je.DOC_FEATURES)
QUERIES = {
    "relevance": dict(tokens=np.asarray([3, 5, PAD_ID], np.int32), require_all=False, min_ts=0, max_ts=915),
    "custom": dict(tokens=np.asarray([3, 5, PAD_ID], np.int32), require_all=False, min_ts=0, max_ts=915,
                   exclude_tokens=np.asarray([7, PAD_ID], np.int32)),
    "model": dict(tokens=np.asarray([3, 5, PAD_ID], np.int32), require_all=False, min_ts=0, max_ts=2**31 - 1),
    "recency": dict(tokens=np.full(2, PAD_ID, np.int32), require_all=False, min_ts=0, max_ts=915),
    "root": dict(tokens=np.asarray([4, PAD_ID], np.int32), require_all=False, min_ts=850, max_ts=990),
}
MAX_RESULTS = {"relevance": 40, "custom": 40, "model": 60, "recency": 25}


def _archive():
    tokens, author, created, feats, ids = corpus(1)
    return tokens, author, created - 100, feats, ids + 10_000


def _gfs():
    rng = np.random.default_rng(3)
    E, U, D = len(jgf.EdgeType), 32, 12
    nbrs = np.full((E, U, D), PAD_ID, np.int32)
    for e in range(E):
        for u in range(U):
            deg = int(rng.integers(1, D))
            nbrs[e, u, :deg] = np.sort(rng.choice(U, size=deg, replace=False))
    return nbrs, rng.integers(0, U, 16).astype(np.int32)


def _jquery(fields):
    return je.SearchQuery(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else
                                 jnp.int32(v) if isinstance(v, int) and not isinstance(v, bool) else v)
                             for k, v in fields.items()})


def _relevance():
    w = np.random.default_rng(3).normal(0, 1, F).astype(np.float32)
    return je.RelevanceParams(jnp.asarray(w), **{k: jnp.float32(v) for k, v in RELEVANCE.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    nbrs, cands = _gfs()
    inputs = {"corpus": corpus(0), "archive": _archive(), "queries": QUERIES, "max_results": MAX_RESULTS,
              "relevance": tuple(np.asarray(x) for x in _relevance()), "gfs": nbrs, "uid": 5, "cands": cands}
    return inputs, run_ranks("sharded_search", 4, tmp_path_factory.mktemp("sharded_search"), inputs)


def _mesh(key):
    d, m = (int(x) for x in key.split("x"))
    return make_mesh(MeshSpec(data=d, model=m), jax.devices()[:d * m])


def _ranks(key):
    d, m = (int(x) for x in key.split("x"))
    return range(d * m)


def _jindex(arrays):
    return je.EarlybirdIndex(*(jnp.asarray(a) for a in arrays), jnp.int32(0))


@pytest.mark.parametrize("case", SEARCH_CASES)
@pytest.mark.parametrize("key", KEYS)
def test_search_over_partitions_matches_jax(runs, key, case):
    inputs, outs = runs
    mesh = _mesh(key)
    opts = {"relevance": dict(), "custom": dict(relevance=_relevance()),
            "model": dict(model_score_fn=lambda f: jnp.zeros(f.shape[0])), "recency": dict(rank_by="recency")}[case]
    index, q = _jindex(inputs["corpus"]), _jquery(QUERIES[case])
    ids, scores = (np.asarray(x) for x in jax.jit(lambda: je.search_sharded(
        mesh, index, q, max_results=MAX_RESULTS[case], **opts))())
    assert (ids != PAD_ID).sum() > 10
    if case == "model":  # the cut falls inside a tie
        assert (scores[:-1] == scores[1:]).sum() > 20
    for r in _ranks(key):
        got_ids, got_scores = outs[r][f"search/{case}/{key}"]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_allclose(got_scores, scores, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key", KEYS)
def test_superroot_over_a_partitioned_tier_matches_jax(runs, key):
    inputs, outs = runs
    root = jrt.SuperRoot([jrt.Tier("realtime", _jindex(inputs["corpus"]), 900, 999),
                          jrt.Tier("archive", _jindex(inputs["archive"]), 800, 899)])
    q = _jquery(QUERIES["root"])
    ids, scores, per_tier = root.search(q, max_results=30)
    pages = list(root.paginate(q, page_size=16, max_pages=6))
    assert len(pages) >= 2
    for r in _ranks(key):
        got_ids, got_scores, tiers = outs[r][f"root/{key}"]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_allclose(got_scores, scores, rtol=RTOL, atol=ATOL)
        assert tiers == [t.tier for t in per_tier]
        got_pages = outs[r][f"pages/{key}"]
        assert len(got_pages) == len(pages)
        for (gi, gs), (wi, ws) in zip(got_pages, pages):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key", KEYS)
def test_gfs_shard_tables_match_jax(runs, key):
    inputs, outs = runs
    m = int(key.split("x")[1])
    want = np.asarray(jgf.shard_tables(jgf.GraphTables(jnp.asarray(inputs["gfs"])), m))
    for r in _ranks(key):
        np.testing.assert_array_equal(outs[r][f"gfs_tables/{key}"], want)


@pytest.mark.parametrize("key", KEYS)
def test_gfs_feature_block_over_workers_matches_jax(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    tables = jgf.GraphTables(jnp.asarray(inputs["gfs"]))
    sharded = jgf.shard_tables(tables, mesh.shape["model"])
    uid, cands = jnp.int32(inputs["uid"]), jnp.asarray(inputs["cands"])
    want = jax.jit(lambda: jgf.feature_block_sharded(mesh, sharded, uid, cands))()
    single = jgf.feature_block(tables, uid, cands)
    for r in _ranks(key):
        got = outs[r][f"gfs/{key}"]
        assert set(got) == set(want)
        for k in want:
            exact = not k.endswith("_normalized")
            for w in (want[k], single[k]):
                np.testing.assert_allclose(got[k], np.asarray(w), rtol=0 if exact else GFS_RTOL, err_msg=k)
        assert got["follows_who_follow"].sum() > 0
