"""The port's sharded serve engine (the_algorithm_tpu_torch/mixers/
sharded_serve.py: ``table_capacities``, ``place_tables`` and
``ShardedServeEngine``) against the JAX package's on meshes of the same
shape (1x2, 2x2, 1x4), mirroring tests/test_sharded_serve.py.

The world has 33 users and 50 authors, rows that divide neither 2 nor 4
shards, and the requests carry user and author ids past those rows: a key
taken modulo a padded shard's row count instead of the logical capacity
(``device_hydration._cap_of``) reads another row. The port runs on 4 gloo
ranks (tests/torch_mesh_ranks.py, once for the file), each holding its
blocks and answering the whole batch; JAX runs each engine on a sub-mesh of
its 8 CPU devices. Both score in f32 from the same flax weights: probs and
combined scores agree at rtol 1e-5 / atol 1e-6 (the hydrated features are
held to that tolerance in tests/test_torch_hydration.py, and MaskNet's
products sum in another order); the device selection's ids exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_mesh_programs import SERVE_K, SERVE_PB, SERVE_WORLD, serve_batch, serve_columns
from torch_mesh_ranks import run_ranks

from the_algorithm_tpu.core.mesh import MeshSpec, make_mesh
from the_algorithm_tpu.mixers import device_hydration as jdh
from the_algorithm_tpu.mixers import feature_schema as jfs
from the_algorithm_tpu.mixers import home_mixer as jhm
from the_algorithm_tpu.mixers import sharded_serve as jss
from the_algorithm_tpu.mixers import wide_hydrators as jwh
from the_algorithm_tpu.models import masknet as jmasknet
from the_algorithm_tpu.pipeline.component import Candidate

KEYS = ["1x2", "2x2", "1x4"]
RTOL, ATOL = 1e-5, 1e-6
MODEL = dict(num_heads=4, mask_blocks=1, block_dim=32, aggregation_dim=16, head_hidden=(16,), dtype="float32")
WEIGHTS = np.asarray([1.0, 0.5, 0.25, 0.125], np.float32)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    world = jwh.synthetic_world(**SERVE_WORLD, include_device_spec=True)
    tables, fns, resolvers = jdh.build_from_world(world, world.pop("device_spec"))
    cfg = dict(MODEL, num_features=jfs.total_width(jfs.WIDE_SCHEMA))
    model = jmasknet.MaskNet(jmasknet.MaskNetConfig(**cfg))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg["num_features"])))
    inputs = {"model_cfg": cfg, "params": jax.tree_util.tree_map(np.asarray, params), "weights": WEIGHTS}
    outs = run_ranks("sharded_serve", 4, tmp_path_factory.mktemp("sharded_serve"), inputs)
    return (tables, fns, resolvers, model, params), outs


def _engine(jworld, key, **kw):
    tables, fns, resolvers, model, params = jworld
    d, m = (int(x) for x in key.split("x"))
    mesh = make_mesh(MeshSpec(data=d, model=m), jax.devices()[:d * m])
    return jss.ShardedServeEngine(tables, fns, resolvers, model, params, jnp.asarray(WEIGHTS), mesh,
                                  pad_b=SERVE_PB, compute_dtype=jnp.float32, **kw)


def _ranks(key):
    d, m = (int(x) for x in key.split("x"))
    return range(d * m)


@pytest.mark.parametrize("n_req", [4, 3])
@pytest.mark.parametrize("key", KEYS)
def test_score_requests_matches_jax(worlds, key, n_req):
    jworld, outs = worlds
    want = _engine(jworld, key).score_requests(serve_batch(jhm.ForYouQuery, Candidate, n_req))
    case = "score" if n_req == 4 else "score3"  # 3 requests: the data axis pads with the first row
    for r in _ranks(key):
        got = outs[r][f"{case}/{key}"]
        assert len(got) == len(want) == n_req
        for (gp, gc), (wp, wc) in zip(got, want):
            np.testing.assert_allclose(gp, np.asarray(wp), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(gc, np.asarray(wc), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key", KEYS)
def test_select_columnar_matches_jax(worlds, key):
    jworld, outs = worlds
    want = _engine(jworld, key, select_top_k=SERVE_K).select_columnar(serve_columns(jhm.ForYouQuery))
    for r in _ranks(key):
        for (gi, gs, gp), (wi, ws, wp) in zip(outs[r][f"select/{key}"], want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(gp, wp, rtol=RTOL, atol=ATOL)


def test_table_capacities_match_jax(worlds):
    jworld, outs = worlds
    want = jss.table_capacities(jworld[0])
    assert outs[0]["caps"] == want
    assert want["tw_user"] == 33 and want["tw_author"] == 50


@pytest.mark.parametrize("key", KEYS)
def test_tables_are_partitioned(worlds, key):
    """Each rank holds rows/E (padded) of every sharded leaf, as JAX's
    place_tables lays it out."""
    jworld, outs = worlds
    d, m = (int(x) for x in key.split("x"))
    placed, _ = jss.place_tables(jworld[0], make_mesh(MeshSpec(data=d, model=m), jax.devices()[:d * m]))
    for r in _ranks(key):
        got = outs[r][f"placed/{key}"]
        for name, axis in (("doc_table", 0), ("gfs_neighbors", 1), ("twhin_author", 0)):
            arr = getattr(placed, name)
            block = [s for s in arr.addressable_shards if s.device == jax.devices()[r]][0].data
            np.testing.assert_array_equal(got[name], np.asarray(block))
            assert got[name].shape[axis] == arr.shape[axis] // m
        assert got["axes"]["gfs_neighbors"] == 1 and got["axes"]["rg_w"] is None


@pytest.mark.parametrize("key", KEYS)
def test_each_rank_keeps_its_share_of_the_packed_tables(worlds, key):
    """The packed routes replace the tables: each rank keeps 1/E of them
    (rows padded), and the E shards together hold every route once."""
    _, outs = worlds
    m = int(key.split("x")[1])
    per_rank = [outs[r][f"resident/{key}"] for r in _ranks(key)]
    assert len(set(per_rank)) == 1
    whole = outs[0]["resident/1x2"] * 2
    assert whole <= per_rank[0] * m <= whole * 1.01


def test_pad_b_must_divide_over_the_model_axis(worlds):
    _, outs = worlds
    assert outs[0]["bad_pad"] == f"pad_b={SERVE_PB + 2} not divisible by model=4"
