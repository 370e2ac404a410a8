"""The port's slice whole at a small size — seeded SANN world → index →
batched retrieval → ranker served over HTTP — against the JAX package's
functions on the same inputs; the port's copies of bench.py's data builders
against bench.py's own code; and the port's freedom from JAX."""

import ast
import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_util import assert_same_topk

from the_algorithm_tpu.models import masknet as jax_masknet
from the_algorithm_tpu.ops import retrieval as jr
from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu.simclusters import ann as jax_ann
from the_algorithm_tpu.training import metrics as jax_metrics
from the_algorithm_tpu_torch.data import sann_world
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig
from the_algorithm_tpu_torch.serving.model_registry import ModelRegistry, save_params_npz
from the_algorithm_tpu_torch.serving.server import InferenceServer
from the_algorithm_tpu_torch.simclusters import ann
from the_algorithm_tpu_torch.training import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = sann_world.WorldShape(n_comm=8, cpc=40, M=16, N=8, X=20, T=3000, KT=6, Q=4, n_pool=16)


def _bench_code():
    """bench.py's builders and query draw, compiled from its source (importing
    bench.py would turn on its persistent compilation cache)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    body = fns["main"].body
    start = next(i for i, n in enumerate(body) if "default_rng(1)" in ast.unparse(n))
    end = next(i for i, n in enumerate(body) if ast.unparse(n).startswith("q_scores ="))
    builders = ast.Module([fns["build_corpus"], fns["build_index"]], type_ignores=[])
    draw = ast.Module(body[start : end + 1], type_ignores=[])
    return compile(builders, "bench.py", "exec"), compile(draw, "bench.py", "exec")


def test_world_builders_reproduce_bench_draw_for_draw():
    builders, draw = _bench_code()
    s = SHAPE
    ns = dict(np=np, PAD_ID=np.int32(PAD_ID), N_COMM=s.n_comm, CPC=s.cpc, C=s.C, M=s.M, T=s.T,
              KT=s.KT, Q=s.Q, N=s.N)
    exec(builders, ns)
    shape = sann_world.WorldShape(**{**s.__dict__, "n_pool": 256})  # bench.py fixes n_pool
    want = ns["build_corpus"]()
    got = sann_world.build_corpus(shape)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(sann_world.build_index(shape, got[0], got[1]), ns["build_index"](want[0], want[1])):
        np.testing.assert_array_equal(g, w)
    ns["comm_clusters"] = want[3]
    exec(draw, ns)
    q_ids, q_scores = sann_world.draw_queries(shape, got[3])
    np.testing.assert_array_equal(q_ids, ns["q_ids"].astype(np.int32))
    np.testing.assert_array_equal(q_scores, ns["q_scores"])


def test_slice_end_to_end_matches_jax(tmp_path):
    s = SHAPE
    tweet_ids, tweet_scores, _, comm = sann_world.build_corpus(s)
    index_np = sann_world.build_index(s, tweet_ids, tweet_scores)
    q_ids, q_scores = sann_world.draw_queries(s, comm)

    # retrieval: the port's batch path against the JAX package's
    cfg = ann.SimClustersANNConfig(max_scan_clusters=s.N, max_top_tweets_per_cluster=s.M,
                                   max_num_results=s.X)
    index = retrieval.ClusterTweetIndex(*(torch.from_numpy(a) for a in index_np))
    got_ids, got_scores = ann.get_tweet_candidates_batch(
        index, SparseEmbedding(torch.from_numpy(q_ids), torch.from_numpy(q_scores)), cfg)
    jcfg = jax_ann.SimClustersANNConfig(max_scan_clusters=s.N, max_top_tweets_per_cluster=s.M,
                                        max_num_results=s.X)
    want_ids, want_scores = jax_ann.get_tweet_candidates_batch(
        jr.ClusterTweetIndex(*(jnp.asarray(a) for a in index_np)),
        js.SparseEmbedding(jnp.asarray(q_ids), jnp.asarray(q_scores)), jcfg)
    assert_same_topk(got_ids.numpy(), got_scores.numpy(), np.asarray(want_ids), np.asarray(want_scores))

    # recall@10 against the exact scan, as bench.py measures it
    ti, tsc = sann_world.padded_corpus(tweet_ids, tweet_scores, block=512)
    truth, _ = retrieval.exact_cosine_scan(
        torch.from_numpy(ti), torch.from_numpy(tsc),
        SparseEmbedding(torch.from_numpy(q_ids), torch.from_numpy(q_scores)),
        num_clusters=s.C, max_results=10, block=512)
    recall = float(metrics.recall_at_k(got_ids[:, :10], truth, pad_id=PAD_ID))
    want_recall = float(jax_metrics.recall_at_k(
        jnp.asarray(got_ids[:, :10].numpy()), jnp.asarray(truth.numpy()), pad_id=PAD_ID))
    assert recall == want_recall and 0.2 < recall <= 1.0

    # ranking: flax params → a registry version → the HTTP predict front
    mcfg = dict(num_features=32, num_heads=15, mask_blocks=2, block_dim=16,
                aggregation_dim=8, head_hidden=(16,), dtype="float32")
    flax_model = jax_masknet.MaskNet(jax_masknet.MaskNetConfig(**mcfg))
    params = flax_model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32)))
    sd = masknet.params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    save_params_npz(str(tmp_path / "ranker" / "1"), {k: v.numpy() for k, v in sd.items()})

    def build(arrays):
        model = masknet.MaskNet(masknet.MaskNetConfig(**mcfg), device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()})
        return masknet.score_fn(model, masknet.DEFAULT_HEAD_WEIGHTS)

    reg = ModelRegistry(str(tmp_path))
    reg.scan_once()
    srv = InferenceServer(reg, build, batcher_config=BatcherConfig(max_delay_ms=1.0))
    srv.start()
    x = np.random.default_rng(0).normal(size=(s.X, 32)).astype(np.float32)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/ranker:predict",
            data=json.dumps({"instances": x.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            preds = np.asarray(json.loads(r.read())["predictions"])
    finally:
        srv.close()
    want = jax_masknet.weighted_model_score(
        jax.nn.sigmoid(flax_model.apply(params, jnp.asarray(x))), jax_masknet.DEFAULT_HEAD_WEIGHTS)
    np.testing.assert_allclose(preds, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without JAX
    (this test process has JAX loaded by tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import the_algorithm_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "new = {'core.device', 'core.hashing', 'search.analyzer', 'search.earlybird', 'search.root',\n"
        "       'graph.uteg', 'graph.graphjet', 'data.foryou_world', 'features.aggregation',\n"
        "       'features.graph_features', 'features.user_signals', 'features.representation_scorer',\n"
        "       'graph.realgraph', 'mixers.feature_schema', 'mixers.wide_hydrators', 'mixers.device_hydration',\n"
        "       'mixers.home_mixer', 'mixers.batched_foryou', 'pipeline.component'}\n"
        "assert {pkg.__name__ + '.' + n for n in new} <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'the_algorithm_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
