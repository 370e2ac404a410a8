"""What each gloo rank of the mesh tests computes (tests/torch_mesh_ranks.py).

One function per test file. A function takes the inputs the test pickled
(numpy arrays and plain values), builds its meshes over the ranks of the
group — ``make_mesh`` on the CPU — runs the port's sharded functions on
this rank's blocks, and returns this rank's local outputs as numpy, keyed
by case. Imports no JAX: it runs in the rank processes.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from the_algorithm_tpu_torch.core import mesh as meshlib
from the_algorithm_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, MeshSpec, make_mesh, shard_rows

# (data, model) shapes a file's cases run on, over the first data·model ranks
SHAPES = ((1, 4), (2, 2), (1, 2), (1, 1))


def build_meshes(shapes=SHAPES):
    """{(data, model): this rank's Mesh, or None where the rank is outside
    it}. Every rank builds every mesh: making one is collective."""
    out = {}
    for d, m in shapes:
        try:
            out[(d, m)] = make_mesh(MeshSpec(data=d, model=m), ranks=range(d * m), device_type="cpu")
        except ValueError:
            out[(d, m)] = None
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_np(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def _error(fn):
    """The ValueError text ``fn()`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# -- tests/test_torch_mesh.py ---------------------------------------------------


def mesh(inputs):
    """Layout, coordinates and each collective on every mesh shape."""
    meshes = build_meshes()
    rank = dist.get_rank()
    out = {"rank": rank}
    for shape, m in meshes.items():
        if m is None:
            continue
        key = f"{shape[0]}x{shape[1]}"
        x = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * rank
        out[key] = {
            "coord": (m.coord(DATA_AXIS), m.coord(MODEL_AXIS)),
            "shape": (m.shape[DATA_AXIS], m.shape[MODEL_AXIS]),
            "model_ranks": dist.get_process_group_ranks(m.group(MODEL_AXIS)),
            "data_ranks": dist.get_process_group_ranks(m.group(DATA_AXIS)),
            "gather_model_0": _np(m.all_gather(x, MODEL_AXIS, dim=0)),
            "gather_model_1": _np(m.all_gather(x, MODEL_AXIS, dim=1)),
            "gather_data_1": _np(m.all_gather(x, DATA_AXIS, dim=-1)),
            "psum_model": _np(m.psum(x, MODEL_AXIS)),
            "psum_data": _np(m.psum(x.float(), DATA_AXIS)),
            "all_to_all": _np(m.all_to_all(torch.arange(m.shape[MODEL_AXIS] * 2).reshape(-1, 2) + 10 * rank,
                                           MODEL_AXIS)),
            "rows_model": _np(shard_rows(inputs["rows"], m)),
            "rows_joint": _np(shard_rows(inputs["rows"], m, over=(DATA_AXIS, MODEL_AXIS))),
            "rows_axis1": _np(shard_rows(inputs["rows"], m, axis=1)),
            "no_pad": _error(lambda: shard_rows(inputs["rows"][:7], m, pad=False, what="batch")),
        }
        with meshlib.local_mesh(m):
            out[key]["global_is_local"] = meshlib.get_mesh() is m
    out["no_card"] = None
    if not torch.cuda.is_available():
        try:
            make_mesh(MeshSpec(data=1, model=dist.get_world_size()))
        except RuntimeError as e:
            out["no_card"] = str(e)
    return out


# -- tests/test_torch_sharded_table.py ------------------------------------------


def sharded_table(inputs):
    from the_algorithm_tpu_torch.parallel import distributed_topk
    from the_algorithm_tpu_torch.parallel import sharded_table as st

    meshes = build_meshes()
    out = {}
    for shape, m in meshes.items():
        if m is None:
            continue
        key = f"{shape[0]}x{shape[1]}"
        r = {}
        r["create"] = _np(st.create(m, 16, 8).local)
        r["create_padded"] = _np(st.create(m, 18, 4, init=inputs["small"]).local)
        t = st.create(m, 32, 8, init=inputs["data32"])
        r["lookup"] = _np(st.lookup(m, t, torch.from_numpy(inputs["lookup_ids"])))
        r["onehot"] = _np(st.lookup_onehot_psum(m, t, torch.from_numpy(inputs["onehot_ids"])))
        r["onehot_rows"] = _error(lambda: st.lookup_onehot_psum(m, st.create(m, 18, 4), torch.zeros(2, dtype=torch.int32)))
        t16 = st.create(m, 16, 4, init=inputs["base16"])
        r["scatter_add"] = _np(st.scatter_add(m, t16, torch.from_numpy(inputs["scatter_ids"]),
                                              torch.from_numpy(inputs["scatter_updates"])).local)
        r["row_decay"] = _np(st.row_decay(t16, 0.5).local)
        r["topk"] = _np(distributed_topk.sharded_topk(
            m, shard_rows(inputs["topk_scores"], m, axis=1), shard_rows(inputs["topk_payload"], m, axis=1), 8))
        items = shard_rows(inputs["items"], m)
        query = torch.from_numpy(inputs["query"])
        r["argtopk"] = _np(distributed_topk.sharded_argtopk_batched(m, lambda s: s @ query, items, 5))
        t64 = st.create(m, 64, 8, init=inputs["data64"])
        for case in ("uniform", "skewed", "clamped", "repeats"):
            ids = shard_rows(inputs[f"{case}_ids"], m, pad=False, what="batch")
            r[case] = _np(st.lookup_all_to_all(m, t64, ids, return_overflow=True))
        ids = shard_rows(inputs["overflow_ids"], m, pad=False, what="batch")
        r["overflow"] = _np(st.lookup_all_to_all(m, t64, ids, capacity=2, return_overflow=True))
        tables = {"scores": shard_rows(inputs["pytree_scores"], m), "ids": shard_rows(inputs["pytree_ids"], m)}
        r["pytree"] = _np(st.multiget_all_to_all(m, tables, shard_rows(inputs["pytree_req"], m, pad=False)))
        tc = st.create(m, 64, 16, init=inputs["data64x16"])
        joint = shard_rows(inputs["joint_ids"], m, over=(DATA_AXIS, MODEL_AXIS), pad=False, what="batch")
        r["collective"] = _np(st.lookup_collective(tc, joint, m))
        r["batch_error"] = _error(lambda: shard_rows(inputs["uniform_ids"][:-1], m, pad=False, what="batch"))
        r["rows_error"] = _error(lambda: st.multiget_all_to_all(m, st.create(m, 18, 4), torch.zeros(
            2, dtype=torch.int32)))
        out[key] = r
    return out


# -- tests/test_torch_ann_sharded.py --------------------------------------------

# (form, variant) → the config fields and options the case runs with, and the
# mesh shapes it runs on (tests/test_torch_ann_sharded.py holds the JAX side)
ANN_CASES = {
    ("index", "cosine"): (dict(), {}, ("1x4", "2x2", "1x2", "1x1")),
    ("index", "dot_window"): (dict(scoring_algorithm="DOT_PRODUCT"), {"now": True}, ("1x4",)),
    ("index", "log_cosine"): (dict(scoring_algorithm="LOG_COSINE"), {}, ("2x2",)),
    ("index", "no_source_norm"): (dict(scoring_algorithm="COSINE_NO_SOURCE_NORM", min_score=0.2), {}, ("1x2",)),
    ("index", "few_partials"): (dict(), {"partials_per_shard": 24}, ("1x4", "2x2")),
    ("query", "cosine_window"): (dict(), {"now": True}, ("1x4", "2x2", "1x2", "1x1")),
    ("query", "log_cosine"): (dict(scoring_algorithm="LOG_COSINE"), {}, ("1x4",)),
    ("hybrid", "cosine"): (dict(), {}, ("2x2", "1x4", "1x2", "1x1")),
    ("hybrid", "dot_window"): (dict(scoring_algorithm="DOT_PRODUCT"), {"now": True}, ("2x2",)),
    ("hybrid", "few_partials"): (dict(), {"partials_per_shard": 24}, ("2x2", "1x4")),
    ("hybrid", "no_source_norm"): (dict(scoring_algorithm="COSINE_NO_SOURCE_NORM"), {"now": True}, ("1x2",)),
}


def ann_sharded(inputs):
    from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, ScoringAlgorithm
    from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
    from the_algorithm_tpu_torch.simclusters import ann

    meshes = {f"{d}x{m}": mesh for (d, m), mesh in build_meshes().items()}
    index = ClusterTweetIndex(*(torch.from_numpy(a) for a in inputs["index"]))
    sources = SparseEmbedding(*(torch.from_numpy(a) for a in inputs["sources"]))
    out = {}
    for key, m in meshes.items():
        if m is None:
            continue
        local = ann.shard_index(m, index)
        for (form, variant), (fields, opts, keys) in ANN_CASES.items():
            if key not in keys:
                continue
            fields = dict(inputs["config"], **fields)
            if "scoring_algorithm" in fields:
                fields["scoring_algorithm"] = ScoringAlgorithm[fields["scoring_algorithm"]]
            cfg = ann.SimClustersANNConfig(**fields)
            now = inputs["now"] if opts.get("now") else None
            if form == "index":
                got = ann.get_tweet_candidates_sharded(m, local, sources, cfg, now=now,
                                                       partials_per_shard=opts.get("partials_per_shard"))
            elif form == "query":
                block = SparseEmbedding(*(shard_rows(t, m, pad=False) for t in sources))
                got = ann.get_tweet_candidates_query_sharded(m, local, block, cfg, now=now)
            else:
                block = SparseEmbedding(*(shard_rows(t, m, over=(DATA_AXIS,), pad=False) for t in sources))
                got = ann.get_tweet_candidates_hybrid(m, local, block, cfg, now=now,
                                                      partials_per_shard=opts.get("partials_per_shard"))
            out[f"{form}/{variant}/{key}"] = _np(got)
        ids = shard_rows(inputs["fetch_ids"], m, pad=False)
        out[f"fetch/{key}"] = _np(tuple(ann.fetch_cluster_rows(m, local, ids)))
        out[f"errors/{key}"] = _error(lambda: ann.shard_index(m, ClusterTweetIndex(*(t[:-1] for t in index))))
    return out


# -- tests/test_torch_sharded_serve.py ------------------------------------------

# 33 users and 50 authors: tables whose rows divide neither 2 nor 4 shards,
# so keys must be taken modulo the logical capacities, not the padded shards
SERVE_WORLD = dict(seed=3, num_users=33, num_authors=50, num_tweets=1 << 12, engagement_width=8, now=10_000_000)
SERVE_PB = 128
SERVE_K = 8
SERVE_SHAPES = ((1, 2), (2, 2), (1, 4))


def serve_batch(ForYouQuery, Candidate, n_req=4):
    """[(query, candidates)] of ``n_req`` requests (the JAX package's
    tests/test_sharded_serve.py batch over this file's world): seeded
    candidates with small creation times, where the random ranker's scores
    spread (PERF.md §2); user and author ids past their tables' rows, read
    modulo the logical row counts."""
    A, now = SERVE_WORLD["num_authors"], SERVE_WORLD["now"]
    batch = []
    for u in range(1, n_req + 1):
        rng = np.random.default_rng(9)
        cands = []
        for i in range(20 + u):
            tid = int(rng.integers(1, 1 << 20))
            cands.append(Candidate(id=tid, source=("simclusters_interested_in", "EarlybirdInNetwork",
                                                   "DirectUteg")[i % 3], features={
                "retrieval_score": float(rng.random()), "social_proof": float(i % 3), "author_id": tid % (A + 10),
                "created_ts": tid % 900, "topic_id": tid % 16, "language_id": tid % 8, "media_type": tid % 4,
                "conversation_id": tid // 2, "is_in_network": float(i % 2)}))
        q = ForYouQuery(user_id=(8, 16, 35, 70)[u - 1], followed_authors=[int(a) for a in range(0, A, 5)], max_results=50,
                        now=now)
        batch.append((q, cands))
    return batch


def serve_columns(ForYouQuery):
    """[(query, cols, n)] for the device-selected path (the JAX package's
    test_sharded_select_columnar_parity)."""
    rng = np.random.default_rng(11)
    batch = []
    for u in range(1, 5):
        q = ForYouQuery(user_id=u, followed_authors=[1, 2, 3], max_results=SERVE_K, now=SERVE_WORLD["now"])
        n = 30
        cols = {"ids": rng.integers(1, 1 << 20, n), "author_id": rng.integers(0, 60, n),
                "retrieval_score": rng.random(n).astype(np.float32)}
        batch.append((q, cols, n))
    return batch


def sharded_serve(inputs):
    from the_algorithm_tpu_torch.mixers import device_hydration as dh
    from the_algorithm_tpu_torch.mixers import sharded_serve as ss
    from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
    from the_algorithm_tpu_torch.mixers.home_mixer import ForYouQuery
    from the_algorithm_tpu_torch.models import masknet
    from the_algorithm_tpu_torch.pipeline.component import Candidate

    world = wh.synthetic_world(**SERVE_WORLD, device="cpu")
    tables, fns, resolvers = dh.build_from_world(world, world.pop("device_spec"))
    model = masknet.MaskNet(masknet.MaskNetConfig(**inputs["model_cfg"]), device="cpu")
    model.load_state_dict(masknet.params_from_flax(inputs["params"]))
    weights = inputs["weights"]
    out = {}
    for (d, e), m in build_meshes(SERVE_SHAPES).items():
        if m is None:
            continue
        key = f"{d}x{e}"
        eng = ss.ShardedServeEngine(tables, fns, resolvers, model, weights, m, pad_b=SERVE_PB,
                                    compute_dtype=torch.float32)
        out[f"score/{key}"] = eng.score_requests(serve_batch(ForYouQuery, Candidate))
        out[f"score3/{key}"] = eng.score_requests(serve_batch(ForYouQuery, Candidate, 3))
        sel = ss.ShardedServeEngine(tables, fns, resolvers, model, weights, m, pad_b=SERVE_PB,
                                    compute_dtype=torch.float32, select_top_k=SERVE_K)
        out[f"select/{key}"] = sel.select_columnar(serve_columns(ForYouQuery))
        placed, axes = ss.place_tables(tables, m)
        out[f"placed/{key}"] = {"doc_table": _np(placed.doc_table), "gfs_neighbors": _np(placed.gfs_neighbors),
                                "twhin_author": _np(placed.twhin_author), "axes": axes}
        out[f"resident/{key}"] = sum(t.numel() for p in eng._packs.values() for t in p.values())
    out["caps"] = ss.table_capacities(tables)
    out["bad_pad"] = _error(lambda: ss.ShardedServeEngine(
        tables, fns, resolvers, model, weights, build_meshes(((1, 4),))[(1, 4)], pad_b=SERVE_PB + 2))
    return out


# -- tests/test_torch_sharded_search.py -----------------------------------------

SEARCH_CASES = ("relevance", "custom", "model", "recency")


def sharded_search(inputs):
    from the_algorithm_tpu_torch.features import graph_features as gf
    from the_algorithm_tpu_torch.search import earlybird as eb
    from the_algorithm_tpu_torch.search import root as rt

    def query(fields):
        return eb.SearchQuery(**{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                                 for k, v in fields.items()})

    index = eb.EarlybirdIndex.from_numpy(*inputs["corpus"], 0, device="cpu")
    archive = eb.EarlybirdIndex.from_numpy(*inputs["archive"], 0, device="cpu")
    rel = eb.RelevanceParams.from_numpy(*inputs["relevance"], device="cpu")
    opts = {"relevance": dict(), "custom": dict(relevance=rel),
            "model": dict(model_score_fn=lambda f: torch.zeros(f.shape[0])), "recency": dict(rank_by="recency")}
    nbrs = gf.GraphTables(torch.from_numpy(inputs["gfs"]))
    out = {}
    for (d, e), m in build_meshes().items():
        if m is None:
            continue
        key = f"{d}x{e}"
        local = eb.shard_index(m, index)
        for case in SEARCH_CASES:
            out[f"search/{case}/{key}"] = _np(eb.search_sharded(
                m, local, query(inputs["queries"][case]), max_results=inputs["max_results"][case], **opts[case]))
        sharded = gf.shard_tables(nbrs, e)
        out[f"gfs_tables/{key}"] = _np(sharded)
        out[f"gfs/{key}"] = _np(gf.feature_block_sharded(m, shard_rows(sharded, m), inputs["uid"],
                                                         torch.from_numpy(inputs["cands"])))
        root = rt.SuperRoot([rt.Tier("realtime", local, 900, 999, mesh=m), rt.Tier("archive", archive, 800, 899)])
        q = query(inputs["queries"]["root"])
        ids, scores, per_tier = root.search(q, max_results=30)
        out[f"root/{key}"] = (ids, scores, [t.tier for t in per_tier])
        out[f"pages/{key}"] = list(root.paginate(q, page_size=16, max_pages=6))
    return out


# -- tests/test_torch_partition.py and tests/test_torch_mesh_training.py --------

# the three models with partition rules, at small widths (the tests draw their
# flax params with JAX's init and pass them in)
SMALL = {
    "masknet": dict(num_features=24, num_heads=3, mask_blocks=2, block_dim=8, aggregation_dim=4, head_hidden=(8, 4),
                    dtype="float32"),
    "two_tower": dict(num_users=32, num_items=64, embed_dim=8, tower_hidden=(16,), temperature=0.1),
    "twhin": dict(num_users=32, num_items=64, embed_dim=8, temperature=1.0),
}
TRAIN_SHAPES = ((2, 2), (4, 1), (1, 4))


class Pair(NamedTuple):
    """A NamedTuple in a partitioned tree: its leaves are named by field."""

    left: Any
    right: Any


def port_model(kind, flax_params, explicit=False):
    """(the port's model of ``kind`` on the CPU holding ``flax_params``, its
    partition rules)."""
    from the_algorithm_tpu_torch.models import masknet, twhin, two_tower

    if kind == "masknet":
        model = masknet.MaskNet(masknet.MaskNetConfig(**SMALL[kind]), device="cpu")
        model.load_state_dict(masknet.params_from_flax(flax_params))
        return model, masknet.PARTITION_RULES
    mod, cfg = (two_tower, two_tower.TwoTowerConfig) if kind == "two_tower" else (twhin, twhin.TwhinConfig)
    model = (mod.TwoTower if kind == "two_tower" else mod.Twhin)(cfg(**SMALL[kind], explicit_lookup=explicit),
                                                                  device="cpu")
    model.load_state_dict(mod.params_from_flax(flax_params))
    return model, mod.PARTITION_RULES


def port_loss(kind):
    """The loss_fn each model trains with (the tests' JAX losses' twins)."""
    from the_algorithm_tpu_torch.models import masknet, twhin, two_tower

    if kind == "masknet":
        return lambda m, b: (masknet.multi_task_loss(m(b["x"]), b["y"]), {})
    if kind == "two_tower":
        return lambda m, b: (two_tower.in_batch_softmax_loss(
            *m(b["users"], b["items"]), SMALL[kind]["temperature"], b["items"]), {})
    return lambda m, b: (twhin.twhin_loss(*m(b["users"], b["relations"], b["items"]), b["items"],
                                          SMALL[kind]["temperature"]), {})


def partition(inputs):
    from the_algorithm_tpu_torch.core import partition as part

    out = {}
    for (d, mm), m in build_meshes(TRAIN_SHAPES).items():
        if m is None:
            continue
        key = f"{d}x{mm}"
        for kind in SMALL:
            model, rules = port_model(kind, inputs["params"][kind])
            specs = part.shard_module(model, m, rules)
            out[f"{kind}/{key}"] = {
                "specs": {n: tuple(s) for n, s in specs.items()},
                "blocks": {n: _np(p) for n, p in model.named_parameters()},
                "gathered": {n: _np(part.gather_block(p, m, specs[n])) for n, p in model.named_parameters()},
            }
        specs = part.match_partition_rules(inputs["tree_rules"], inputs["tree"])
        out[f"tree/{key}"] = _np(part.shard_tree(inputs["tree"], m, specs))
        out[f"indivisible/{key}"] = _error(lambda: part.local_block(np.zeros((6, 2)), m, part.P(("data", "model"))))
    return out


# Trainer runs: (model, explicit_lookup, TrainerConfig fields, mesh shapes)
TRAIN_CASES = {
    "two_tower": ("two_tower", False, dict(learning_rate=1e-2), ("2x2", "4x1", "1x4")),
    "two_tower_x": ("two_tower", True, dict(learning_rate=1e-2), ("2x2", "4x1", "1x4")),
    "twhin_x": ("twhin", True, dict(learning_rate=1e-2), ("2x2", "4x1", "1x4")),
    "masknet": ("masknet", False, dict(learning_rate=1e-2), ("2x2", "4x1", "1x4")),
    "two_tower_x_clip": ("two_tower", True, dict(learning_rate=1e-2, max_grad_norm=0.2), ("2x2",)),
    "masknet_clip": ("masknet", False, dict(learning_rate=1e-2, max_grad_norm=0.2), ("1x4",)),
    "twhin_adagrad": ("twhin", False, dict(learning_rate=5e-2, optimizer="adagrad"), ("1x4",)),
    "two_tower_x_sgd": ("two_tower", True, dict(learning_rate=5e-2, optimizer="sgd"), ("4x1",)),
}
EVAL_METRICS = (0.5, 0.7, 0.6, 0.65, 0.8, 0.9)  # rank 0's evals: best at the 2nd, stale at the 3rd and 4th


def _optimizer_state(tr):
    names = {p: n for n, p in tr.model.named_parameters()}
    return {names[p]: {k: _np(v) for k, v in st.items() if k != "count"} for p, st in tr.optimizer.state.items()}


def _grads(tr, batch):
    """The Trainer's gradients of one batch after its gradient rule, gathered
    into global arrays (no step taken)."""
    from the_algorithm_tpu_torch.core import partition as part

    tr.optimizer.zero_grad(set_to_none=True)
    b = tr.shard_batch(batch)
    with meshlib.local_mesh(tr.mesh), part.batch_split(tr.mesh, tr.batch_axes):
        loss, _ = tr.loss_fn(tr.model, b)
    loss.backward()
    tr._reduce_grads()
    return {n: _np(part.gather_block(p.grad, tr.mesh, tr.specs[n])) for n, p in tr.model.named_parameters()}


def _fault5(inputs, m):
    """Finding 1 and 3's table gradients of Σ w_i·t[ids_i]: the whole table
    read by table_read and the table sharded P('model', None) read by
    lookup, ids split over 'data'; the row exchange, ids split over both
    axes. Each summed over 'data' (the Trainer's share of the rule)."""
    from the_algorithm_tpu_torch.ops.gather import table_read
    from the_algorithm_tpu_torch.parallel import sharded_table as st

    t, ids, w = (torch.from_numpy(inputs[k]) for k in ("f5_table", "f5_ids", "f5_w"))
    n = t.shape[0]
    ids_d, w_d = (shard_rows(x, m, over=(DATA_AXIS,), pad=False) for x in (ids, w))
    ids_j, w_j = (shard_rows(x, m, over=(DATA_AXIS, MODEL_AXIS), pad=False) for x in (ids, w))
    out = {}
    whole = t.clone().requires_grad_()
    (w_d[:, None] * table_read(whole, ids_d)).sum().backward()
    out["table_read"] = _np(m.all_reduce_(whole.grad, DATA_AXIS))
    local = shard_rows(t, m).requires_grad_()
    (w_d[:, None] * st.lookup(m, st.ShardedTable(local, n), ids_d)).sum().backward()
    out["lookup"] = _np(m.all_reduce_(local.grad, DATA_AXIS))
    local = shard_rows(t, m).requires_grad_()
    rows = st.lookup_collective(st.ShardedTable(local, n), ids_j, m)
    (w_j[:, None] * rows).sum().backward()
    out["collective_rows"] = _np(rows)
    out["collective"] = _np(m.all_reduce_(local.grad, DATA_AXIS))
    local = shard_rows(t, m).requires_grad_()  # capacity 1: each requester keeps one id an owner, the rest train nothing
    (st.lookup_collective(st.ShardedTable(local, n), ids_j, m, capacity=1)).sum().backward()
    out["collective_cap1"] = _np(m.all_reduce_(local.grad, DATA_AXIS))
    return out


def mesh_training(inputs):
    import os

    from the_algorithm_tpu_torch.training.data_record_trainer import DataRecordTrainer, DataRecordTrainerConfig
    from the_algorithm_tpu_torch.training.trainer import Trainer, TrainerConfig

    meshes = {f"{d}x{mm}": m for (d, mm), m in build_meshes(TRAIN_SHAPES).items()}
    rank = dist.get_rank()
    out = {}

    def trainer(kind, explicit, cfg, m, **kw):
        model, rules = port_model(kind, inputs["params"][kind], explicit)
        return Trainer(port_loss(kind), model, TrainerConfig(**cfg), mesh=m, partition_rules=rules, **kw)

    for key, m in meshes.items():
        if m is None:
            continue
        if key in ("2x2", "1x4"):
            out[f"fault5/{key}"] = _fault5(inputs, m)
        for case, (kind, explicit, cfg, keys) in TRAIN_CASES.items():
            if key not in keys:
                continue
            tr = trainer(kind, explicit, cfg, m)
            losses = [float(tr.train_step(b)["loss"]) for b in inputs["batches"][kind]]
            out[f"{case}/{key}"] = {"loss": losses, "params": {n: _np(p) for n, p in tr.model.named_parameters()},
                                    "state": _optimizer_state(tr)}
            if case == "two_tower_x" and key == "2x2":  # every rank exports; the first writes the file
                flat = tr.export(os.path.join(inputs["dir"], "export", "1"), extra={"note": np.arange(3)})
                out["export"] = flat if rank == 0 else None
        for kind in ("two_tower", "twhin"):
            if key in ("2x2", "1x4"):
                tr = trainer(kind, True, dict(optimizer="sgd"), m)
                b = inputs["batches"][kind][0]
                names = ("users", "items") if kind == "two_tower" else ("users", "relations", "items")
                sb = tr.shard_batch(b)
                with meshlib.local_mesh(m), torch.no_grad():
                    out[f"explicit_fwd/{kind}/{key}"] = _np(tr.model(*(sb[k] for k in names)))
                out[f"explicit_grad/{kind}/{key}"] = _grads(tr, b)
    m = meshes["4x1"]
    if m is not None:  # each rank feeds its own quarter of the batch
        tr = trainer("two_tower", False, TRAIN_CASES["two_tower"][2], m, local_batches=True)
        blocks = [{k: v[rank * 4:(rank + 1) * 4] for k, v in b.items()} for b in inputs["batches"]["two_tower"]]
        out["local/4x1"] = {"loss": [float(tr.train_step(b)["loss"]) for b in blocks],
                            "params": {n: _np(p) for n, p in tr.model.named_parameters()}}
    m = meshes["2x2"]
    if m is not None:
        ckpt = os.path.join(inputs["dir"], "ckpt")
        cfg = dict(learning_rate=1e-2, checkpoint_dir=ckpt, keep_checkpoints=2)
        tr = trainer("two_tower", True, cfg, m)
        batches = inputs["batches"]["two_tower"]
        for b in batches[:2]:
            tr.train_step(b)
        tr.save()
        out["ckpt_global"] = _global_state(tr)
        _drop_specs(os.path.join(ckpt, "2"), os.path.join(inputs["dir"], "ckpt_without_specs", "2"))
        saved = (tr.model.state_dict(), tr.optimizer.state_dict())
        saved = (copy.deepcopy(saved[0]), copy.deepcopy(saved[1]))
        tr.train_step(batches[2])
        tr.restore(2)
        fresh = trainer("two_tower", True, cfg, m)
        fresh.restore()
        same = [tr.step == fresh.step == 2]
        for t in (tr, fresh):
            same.append(all(torch.equal(v, saved[0][k]) for k, v in t.model.state_dict().items()))
            st = t.optimizer.state_dict()["state"]
            same.append(all(torch.equal(v, saved[1]["state"][i][k]) for i, s in st.items() for k, v in s.items()))
        tr.train_step(batches[2])
        fresh.train_step(batches[2])
        same.append(all(torch.equal(a, b) for a, b in zip(tr.model.parameters(), fresh.model.parameters())))
        out["ckpt"] = {"same": same, "steps": tr.checkpoint_steps()}
        # fit with the prefetch feeder and an eval whose metric differs by rank: rank 0's counts everywhere
        evals = iter(EVAL_METRICS if rank == 0 else EVAL_METRICS[::-1])
        cfg = dict(learning_rate=1e-2, eval_metric="m", early_stopping_patience=2)
        tr = trainer("two_tower", False, cfg, m)
        got = tr.fit(iter(batches * 4), num_steps=12, eval_fn=lambda model: {"m": next(evals)}, eval_every=2)
        out["fit"] = {"step": tr.step, "best": tr.best_or_latest_step(), "m": got["m"]}
    out["ckpt_other_mesh"] = _restore_elsewhere(inputs, meshes, trainer, Trainer, TrainerConfig)
    m = meshes["2x2"]
    if m is not None:
        out["drt"] = _drt(inputs, m, DataRecordTrainer, DataRecordTrainerConfig, TrainerConfig)
    return out


def _copy(t):
    """A numpy copy of ``t`` (``_np`` of a CPU tensor shares its memory,
    which a later step updates in place)."""
    return np.array(_np(t), copy=True)


def _global_state(tr):
    """A sharded Trainer's params and Adam moments as global arrays, and its
    Adam count (collective)."""
    from the_algorithm_tpu_torch.core import partition as part

    out = {"params": {}, "mu": {}, "nu": {}, "count": {}}
    for n, p in tr.model.named_parameters():
        out["params"][n] = _copy(part.gather_block(p, tr.mesh, tr.specs[n]))
        st = tr.optimizer.state[p]
        for k in ("mu", "nu"):
            out[k][n] = _copy(part.gather_block(st[k], tr.mesh, tr.specs[n]))
        out["count"][n] = int(st["count"])
    return out


def _local_state(tr):
    """A Trainer's params and Adam moments as it holds them (a rank's blocks,
    or the whole arrays on one device), its counts and its step."""
    names = {p: n for n, p in tr.model.named_parameters()}
    st = {names[p]: s for p, s in tr.optimizer.state.items()}
    return {"params": {n: _copy(p) for n, p in tr.model.named_parameters()},
            "mu": {n: _copy(s["mu"]) for n, s in st.items()}, "nu": {n: _copy(s["nu"]) for n, s in st.items()},
            "count": {n: (int(s["count"]), str(s["count"].dtype)) for n, s in st.items()}, "step": tr.step}


def _drop_specs(src, dst):
    """A copy of a step directory as it was written before checkpoints
    recorded their specs (rank 0 writes it)."""
    import os

    if dist.get_rank() == 0:
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            state = torch.load(os.path.join(src, name))
            del state["specs"]
            torch.save(state, os.path.join(dst, name))
    dist.barrier()


def _restore_elsewhere(inputs, meshes, trainer, Trainer, TrainerConfig):
    """The 2x2 checkpoint of step 2 restored on 1x4, on 4x1 and into a
    one-device Trainer (the implicit two-tower: the explicit row exchange
    needs a mesh): each one's state after the restore and its params after
    the next step; the same from the copy without specs, on 2x2 and 1x4;
    the errors of Trainers whose names (TwHIN) or shapes (48 users) differ."""
    import os

    from the_algorithm_tpu_torch.models import two_tower

    ckpt = os.path.join(inputs["dir"], "ckpt")
    cfg = dict(learning_rate=1e-2, checkpoint_dir=ckpt)
    batch = inputs["batches"]["two_tower"][2]
    out = {}
    for key in ("1x4", "4x1", "one_device", "2x2/without_specs", "1x4/without_specs"):
        mesh_key, _, kind = key.partition("/")
        c = dict(cfg, checkpoint_dir=os.path.join(inputs["dir"], "ckpt_without_specs")) if kind else cfg
        if key == "one_device":
            model, _ = port_model("two_tower", inputs["params"]["two_tower"])
            tr = Trainer(port_loss("two_tower"), model, TrainerConfig(**c), device="cpu")
        else:
            tr = trainer("two_tower", True, c, meshes[mesh_key])
        tr.restore()
        got = _local_state(tr)
        tr.train_step(batch)
        got["next"] = {n: _np(p) for n, p in tr.model.named_parameters()}
        out[key] = got
    other = two_tower.TwoTower(two_tower.TwoTowerConfig(**dict(SMALL["two_tower"], num_users=48)), device="cpu")
    out["error/shapes"] = _error(lambda: Trainer(port_loss("two_tower"), other, TrainerConfig(**cfg),
                                                 device="cpu").restore(2))
    out["error/names"] = _error(lambda: trainer("twhin", True, cfg, meshes["1x4"]).restore(2))
    return out


def _drt(inputs, m, DataRecordTrainer, DataRecordTrainerConfig, TrainerConfig):
    """The light ranker's DataRecordTrainer on a mesh: 40 adagrad steps of the
    test's files (tests/test_torch_data_record_trainer.py's lifecycle)."""
    from the_algorithm_tpu_torch.core.partition import P
    from the_algorithm_tpu_torch.data import datarecord
    from the_algorithm_tpu_torch.models import light_ranker
    from the_algorithm_tpu_torch.ops import hashed_lr
    from the_algorithm_tpu_torch.training import data_record_trainer as drt

    d = inputs["drt"]
    cfg = light_ranker.LightRankerConfig(n_bins=8, output_bits=12)
    dataset = datarecord.TRecDataset(d["paths"], seed=0)
    hd = drt.calibrate_from_files(dataset, d["vocab"], cfg.n_bins, cfg.output_bits, max_records=1024)
    transform = datarecord.hashed_lr_transform(d["vocab"], hd.bins.bin_vals, cfg.output_bits, max_width=12,
                                               label_vocab=d["label_vocab"])

    def batch_fn(raw):
        return (hashed_lr.SparseBatch(raw["indices"], raw["sparse_values"], raw["sparse_mask"]), raw["labels"][:, 0])

    trainer = DataRecordTrainer(
        lambda model, b: (light_ranker.loss_fn(model, b[0], b[1], l2=cfg.l2), {}),
        light_ranker.init_params(cfg, device="cpu"), transform, batch_fn,
        DataRecordTrainerConfig(batch_size=256, n_bins=cfg.n_bins, output_bits=cfg.output_bits,
                                trainer=TrainerConfig(learning_rate=0.5, optimizer="adagrad")),
        device="cpu", mesh=m, partition_rules=[(r".*", P())])
    got = trainer.fit_from_files(dataset, num_steps=40)
    return {"weights": _np(trainer.params.weights), "bias": _np(trainer.params.bias), "loss": got["loss"]}
