"""The port's sharded SimClusters-ANN (the_algorithm_tpu_torch/simclusters/
ann.py: ``shard_index``, ``fetch_cluster_rows`` and the index-sharded,
query-sharded and hybrid query forms) against the JAX package's on meshes
of the same shape (1x4, 2x2, 1x2, 1x1), mirroring
tests/test_tweet_embeddings_ann.py:174-211,342 and
tests/test_retrieval.py:213.

The port runs on 4 gloo ranks (tests/torch_mesh_ranks.py, once for the
file), JAX on a sub-mesh of its 8 CPU devices; each rank's output is held
against the block of JAX's that its coordinates give it, as
tests/test_torch_ann.py holds the batch path: the score columns at rtol
1e-6, the ids as score-aligned sets (the port's and JAX's compiled
programs round a few products in other ulps, and a query's single-cluster
candidates tie on cosine, so near-ties may trade places at the cut). Every scoring algorithm, the age
window and a partials cut below N·M are covered. The fetched cluster rows
are exact, the requests carrying PAD_ID and ids past both ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_retrieval import make_index, make_sources
from torch_mesh_programs import ANN_CASES
from torch_mesh_ranks import run_ranks
from torch_port_util import PAD_ID, assert_same_topk

from the_algorithm_tpu.core.mesh import MeshSpec, make_mesh
from the_algorithm_tpu.ops import retrieval as jr
from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu.simclusters import ann as jax_ann

C, M, Q, N_IN = 64, 16, 8, 12
CONFIG = dict(max_scan_clusters=8, max_top_tweets_per_cluster=12, max_num_results=20,
              max_tweet_candidate_age_hours=1, min_tweet_candidate_age_hours=0)
NOW = 3600 + 600  # the window keeps timestamps in [600, 4200] of make_index's [100, 1000)
SCORE_RTOL = 1e-6
CASES = [(form, variant, key) for (form, variant), (_, _, keys) in ANN_CASES.items() for key in keys]
KEYS = ["1x4", "2x2", "1x2", "1x1"]


def _inputs():
    ids, scores = make_sources(Q=Q, N=N_IN, C=C, seed=4)
    scores[1, :4] = 0.5  # ties at the truncation boundary keep input order
    fetch = np.asarray([0, 63, 7, 7, 16, PAD_ID, -1, 64, 31, 2, 30, 12], np.int32)
    return {"index": make_index(C=C, M=M, T=300, seed=9), "sources": (ids, scores), "config": CONFIG,
            "now": NOW, "fetch_ids": fetch}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("ann_sharded", 4, tmp_path_factory.mktemp("ann_sharded"), inputs)


def _mesh(key):
    d, m = (int(x) for x in key.split("x"))
    return make_mesh(MeshSpec(data=d, model=m), jax.devices()[:d * m])


def _ranks(key):
    d, m = (int(x) for x in key.split("x"))
    return [(r, r // m, r % m) for r in range(d * m)]


def _block(x, n, i):
    x = np.asarray(x)
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def _jax_case(inputs, form, variant, key):
    fields, opts, _ = ANN_CASES[(form, variant)]
    fields = dict(CONFIG, **fields)
    if "scoring_algorithm" in fields:
        fields["scoring_algorithm"] = jr.ScoringAlgorithm[fields["scoring_algorithm"]]
    cfg = jax_ann.SimClustersANNConfig(**fields)
    mesh = _mesh(key)
    index = jax_ann.shard_index(mesh, jr.ClusterTweetIndex(*(jnp.asarray(a) for a in inputs["index"])))
    sources = js.SparseEmbedding(*(jnp.asarray(a) for a in inputs["sources"]))
    now = jnp.int32(NOW) if opts.get("now") else None
    pps = opts.get("partials_per_shard")
    fn = {"index": lambda: jax_ann.get_tweet_candidates_sharded(mesh, index, sources, cfg, now=now,
                                                                partials_per_shard=pps),
          "query": lambda: jax_ann.get_tweet_candidates_query_sharded(mesh, index, sources, cfg, now=now),
          "hybrid": lambda: jax_ann.get_tweet_candidates_hybrid(mesh, index, sources, cfg, now=now,
                                                                partials_per_shard=pps)}[form]
    return jax.jit(fn)()  # one compiled program: shard_map run eagerly takes ~25 s a call on the CPU


@pytest.mark.parametrize("form,variant,key", CASES)
def test_query_forms_match_jax(runs, form, variant, key):
    inputs, outs = runs
    want_ids, want_scores = (np.asarray(x) for x in _jax_case(inputs, form, variant, key))
    assert (want_ids != PAD_ID).sum() > Q * 3  # neither the window nor the score floor emptied the lists
    d, m = (int(x) for x in key.split("x"))
    for r, di, mi in _ranks(key):
        # the index form answers every query on every rank; the query form
        # each rank's block over 'model', the hybrid its block over 'data'
        n, i = {"index": (1, 0), "query": (m, mi), "hybrid": (d, di)}[form]
        got_ids, got_scores = outs[r][f"{form}/{variant}/{key}"]
        assert_same_topk(got_ids, got_scores, _block(want_ids, n, i), _block(want_scores, n, i), rtol=SCORE_RTOL)


def test_the_partials_cut_drops_what_jax_drops(runs):
    """At R=24 < N·M the index form keeps each shard's top-24 partials by
    dot: candidates drop out against the exact default, the same on both."""
    _, outs = runs
    exact = outs[0]["index/cosine/1x4"][0]
    cut = outs[0]["index/few_partials/1x4"][0]
    assert any(set(a[a != PAD_ID]) != set(b[b != PAD_ID]) for a, b in zip(exact, cut))


@pytest.mark.parametrize("key", KEYS)
def test_fetch_cluster_rows_matches_jax(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    index = jax_ann.shard_index(mesh, jr.ClusterTweetIndex(*(jnp.asarray(a) for a in inputs["index"])))
    want = jax.jit(lambda: jax_ann.fetch_cluster_rows(mesh, index, jnp.asarray(inputs["fetch_ids"])))()
    E = mesh.shape["model"]
    for r, _, mi in _ranks(key):
        for got, w in zip(outs[r][f"fetch/{key}"], want):
            np.testing.assert_array_equal(got, _block(w, E, mi))


@pytest.mark.parametrize("key", KEYS)
def test_shard_index_needs_rows_that_divide(runs, key):
    _, outs = runs
    E = int(key.split("x")[1])
    assert outs[0][f"errors/{key}"] == (None if 63 % E == 0 else f"clusters=63 not divisible by {E} shards")
