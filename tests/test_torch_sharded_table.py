"""The port's row-sharded tables and distributed top-K
(the_algorithm_tpu_torch/parallel/) against the JAX package's on meshes of
the same shape: 1x4, 2x2, 1x2 and 1x1.

The port runs on 4 gloo ranks (tests/torch_mesh_ranks.py, once for the
file); JAX runs each case on a sub-mesh of its 8 CPU devices. Each rank's
local output is held against the block of JAX's global output that its
coordinates give it. Gathered rows, routing, ids, overflow counts and
top-K order are exact; only the scatter-add's sums (an initial row plus
repeated updates, added in another order) take rtol 1e-6. Every routing
case carries ids past both ends and PAD_ID: the multiget clamps them as
JAX does (-1 reads row 0, PAD_ID the last row), which a wrap of negative
ids (``gather.jax_rows``) would get wrong.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_mesh_ranks import run_ranks
from torch_port_util import PAD_ID

from the_algorithm_tpu.core.mesh import MeshSpec, make_mesh
from the_algorithm_tpu.parallel import distributed_topk, sharded_table

SHAPES = ((1, 4), (2, 2), (1, 2), (1, 1))
KEYS = [f"{d}x{m}" for d, m in SHAPES]
SCATTER_RTOL = 1e-6


def _inputs():
    rng = np.random.default_rng(10)
    scores = rng.normal(size=(2, 64)).astype(np.float32)
    scores[0, [3, 17, 40, 41]] = 5.0  # ties across shards: lower index first
    return {
        "small": rng.normal(size=(18, 4)).astype(np.float32),
        "data32": rng.normal(size=(32, 8)).astype(np.float32),
        "lookup_ids": np.asarray([0, 31, 7, 7, 16, -1, 40, PAD_ID], np.int32),
        "onehot_ids": np.asarray([3, 12, 28, 0, 31, 15, -1, 32, PAD_ID], np.int32),
        "base16": rng.normal(size=(16, 4)).astype(np.float32),
        "scatter_ids": np.asarray([2, 2, 5, 15, 15, 15, -1, 16, -17, PAD_ID], np.int32),
        "scatter_updates": rng.normal(size=(10, 4)).astype(np.float32),
        "topk_scores": scores,
        "topk_payload": np.tile(np.arange(64, dtype=np.int32) * 3, (2, 1)),
        "items": rng.normal(size=(64, 16)).astype(np.float32),
        "query": rng.normal(size=(16,)).astype(np.float32),
        "data64": rng.normal(size=(64, 8)).astype(np.float32) + 1.0,
        "uniform_ids": rng.integers(0, 64, 40).astype(np.int32),
        # every id owned by one shard of the 4-way axis: the default cap is exact
        "skewed_ids": rng.integers(32, 48, 16).astype(np.int32),
        "clamped_ids": np.asarray([-1, PAD_ID, 64, 70, -5, 0, 63, 31, -64, 2**31 - 2, 15, 16], np.int32),
        "repeats_ids": np.asarray([5, 5, 5, 5, 60, 60, 1, 1], np.int32),
        # per requester (4 ids on the 4-way axis) all owned by shard 0: cap 2 drops 2 each
        "overflow_ids": np.asarray([1, 2, 3, 4] * 4, np.int32),
        "pytree_scores": rng.normal(size=(32, 8)).astype(np.float32),
        "pytree_ids": rng.integers(0, 100, size=(32, 5)).astype(np.int32),
        "pytree_req": np.concatenate([rng.integers(0, 32, 20), [-1, PAD_ID, 32, 40]]).astype(np.int32),
        "data64x16": rng.normal(size=(64, 16)).astype(np.float32),
        "joint_ids": np.concatenate([rng.integers(0, 64, 28), [-1, PAD_ID, 64, 99]]).astype(np.int32),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("sharded_table", 4, tmp_path_factory.mktemp("sharded_table"), inputs)


def _mesh(key):
    d, m = (int(x) for x in key.split("x"))
    return make_mesh(MeshSpec(data=d, model=m), jax.devices()[:d * m])


def _ranks(key):
    """(rank, data coordinate, model coordinate) of every rank in the mesh."""
    d, m = (int(x) for x in key.split("x"))
    return [(r, r // m, r % m) for r in range(d * m)]


def _block(x, n, i, axis=0):
    x = np.asarray(x)
    per = x.shape[axis] // n
    return np.take(x, range(i * per, (i + 1) * per), axis=axis)


def _put(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _run(fn):
    """``fn()`` as one compiled program (shard_map run eagerly compiles op by
    op, tens of times slower on the CPU)."""
    return jax.jit(fn)()


def _table(mesh, data):
    return sharded_table.create(mesh, data.shape[0], data.shape[1], init=data)


@pytest.mark.parametrize("key", KEYS)
def test_create_holds_each_rank_its_block(runs, key):
    inputs, outs = runs
    E = _mesh(key).shape["model"]
    padded = np.concatenate([inputs["small"], np.zeros(((-18) % E, 4), np.float32)])
    for r, _, m in _ranks(key):
        got = outs[r][key]
        np.testing.assert_array_equal(got["create"], np.zeros((16 // E, 8), np.float32))
        np.testing.assert_array_equal(got["create_padded"], _block(padded, E, m))


@pytest.mark.parametrize("key", KEYS)
def test_lookup_matches_jax(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    t = _table(mesh, inputs["data32"])
    want = np.asarray(_run(lambda: sharded_table.lookup(t, jnp.asarray(inputs["lookup_ids"]))))
    for r, _, _ in _ranks(key):
        np.testing.assert_array_equal(outs[r][key]["lookup"], want)


@pytest.mark.parametrize("key", KEYS)
def test_lookup_onehot_psum_matches_jax(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    t = _table(mesh, inputs["data32"])
    want = np.asarray(_run(lambda: sharded_table.lookup_onehot_psum(mesh, t, jnp.asarray(inputs["onehot_ids"]))))
    assert not want[6:].any()  # ids no shard owns: zero rows
    err = None
    try:  # an unsharded 18-row table: JAX's own check, not device_put's
        sharded_table.lookup_onehot_psum(mesh, sharded_table.ShardedTable(jnp.zeros((18, 4))), jnp.zeros(2, jnp.int32))
    except ValueError as e:
        err = str(e)
    for r, _, _ in _ranks(key):
        np.testing.assert_array_equal(outs[r][key]["onehot"], want)
        assert outs[r][key]["onehot_rows"] == err
    if mesh.shape["model"] == 4:
        assert err == "rows=18 not divisible by 4 shards"


@pytest.mark.parametrize("key", KEYS)
def test_scatter_add_accumulates_duplicates(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    E = mesh.shape["model"]
    t = _table(mesh, inputs["base16"])
    want = np.asarray(_run(lambda: sharded_table.scatter_add(t, jnp.asarray(inputs["scatter_ids"]),
                                                             jnp.asarray(inputs["scatter_updates"])).array))
    np.testing.assert_allclose(want[15], inputs["base16"][15] + inputs["scatter_updates"][[3, 4, 5, 6]].sum(0),
                               rtol=SCATTER_RTOL)  # -1 counts from the end; 16, -17 and PAD_ID are dropped
    for r, _, m in _ranks(key):
        np.testing.assert_allclose(outs[r][key]["scatter_add"], _block(want, E, m), rtol=SCATTER_RTOL, atol=0)


@pytest.mark.parametrize("key", KEYS)
def test_row_decay(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    t = _table(mesh, inputs["base16"])
    want = np.asarray(_run(lambda: sharded_table.row_decay(t, 0.5).array))
    for r, _, m in _ranks(key):
        np.testing.assert_array_equal(outs[r][key]["row_decay"], _block(want, mesh.shape["model"], m))


@pytest.mark.parametrize("key", KEYS)
def test_topk_over_shards_matches_jax(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    spec = P(None, "model")
    scores, payload = _put(mesh, inputs["topk_scores"], spec), _put(mesh, inputs["topk_payload"], spec)
    want = _run(lambda: distributed_topk.sharded_topk(mesh, scores, payload, k=8))
    assert np.asarray(want[1])[0, :4].tolist() == [9, 51, 120, 123]  # the tied top scores, lower index first
    for r, _, _ in _ranks(key):
        got = outs[r][key]["topk"]
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("key", KEYS)
def test_argtopk_matches_jax(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    query = jnp.asarray(inputs["query"])
    items = _put(mesh, inputs["items"], P("model"))
    want = _run(lambda: distributed_topk.sharded_argtopk_batched(mesh, lambda s: s @ query, items, k=5))
    np.testing.assert_array_equal(np.asarray(want[1]), np.argsort(-(inputs["items"] @ inputs["query"]))[:5])
    for r, _, _ in _ranks(key):
        got = outs[r][key]["argtopk"]
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6)


@pytest.mark.parametrize("case", ["uniform", "skewed", "clamped", "repeats"])
@pytest.mark.parametrize("key", KEYS)
def test_all_to_all_lookup_matches_jax(runs, key, case):
    inputs, outs = runs
    mesh = _mesh(key)
    E = mesh.shape["model"]
    t = _table(mesh, inputs["data64"])
    rows, overflow = _run(lambda: sharded_table.lookup_all_to_all(mesh, t, jnp.asarray(inputs[f"{case}_ids"]),
                                                                  return_overflow=True))
    rows = np.asarray(rows)
    assert int(overflow) == 0  # the default capacity is exact
    if case == "clamped":  # JAX's clamp: -1 → row 0, PAD_ID and 70 → the last row
        np.testing.assert_array_equal(rows[[0, 1, 3]], inputs["data64"][[0, 63, 63]])
    for r, _, m in _ranks(key):
        got_rows, got_overflow = outs[r][key][case]
        np.testing.assert_array_equal(got_rows, _block(rows, E, m))
        assert int(got_overflow) == 0


@pytest.mark.parametrize("key", KEYS)
def test_capacity_overflow_zeroed_and_counted(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    E = mesh.shape["model"]
    t = _table(mesh, inputs["data64"])
    rows, overflow = _run(lambda: sharded_table.lookup_all_to_all(mesh, t, jnp.asarray(inputs["overflow_ids"]),
                                                                  capacity=2, return_overflow=True))
    rows = np.asarray(rows)
    if E == 4:
        assert int(overflow) == 8  # 2 dropped per requester shard × 4 shards
    for r, _, m in _ranks(key):
        got_rows, got_overflow = outs[r][key]["overflow"]
        np.testing.assert_array_equal(got_rows, _block(rows, E, m))
        assert int(got_overflow) == int(overflow)


@pytest.mark.parametrize("key", KEYS)
def test_multiget_pytree_shares_routing(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    E = mesh.shape["model"]
    tables = {"scores": _put(mesh, inputs["pytree_scores"], P("model", None)),
              "ids": _put(mesh, inputs["pytree_ids"], P("model", None))}
    want = _run(lambda: sharded_table.multiget_all_to_all(mesh, tables, jnp.asarray(inputs["pytree_req"])))
    for r, _, m in _ranks(key):
        got = outs[r][key]["pytree"]
        for name in ("scores", "ids"):
            np.testing.assert_array_equal(got[name], _block(want[name], E, m))


@pytest.mark.parametrize("key", KEYS)
def test_lookup_collective_joint_batch(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    n = mesh.shape["data"] * mesh.shape["model"]
    arr = _put(mesh, inputs["data64x16"], P("model", None))
    want = np.asarray(jax.jit(lambda t: sharded_table.lookup_collective(t, jnp.asarray(inputs["joint_ids"]),
                                                                        mesh))(arr))
    for r, d, m in _ranks(key):
        np.testing.assert_array_equal(outs[r][key]["collective"], _block(want, n, d * mesh.shape["model"] + m))


@pytest.mark.parametrize("key", KEYS)
def test_divisibility_errors_match_jax(runs, key):
    inputs, outs = runs
    mesh = _mesh(key)
    E = mesh.shape["model"]
    errs = []
    for tables, ids in ((_put(mesh, np.zeros((64, 8), np.float32), P("model", None)), inputs["uniform_ids"][:-1]),
                        (jnp.zeros((18, 4), jnp.float32), np.zeros(E * 2, np.int32))):
        try:
            sharded_table.multiget_all_to_all(mesh, tables, jnp.asarray(ids))
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    for r, _, _ in _ranks(key):
        assert outs[r][key]["batch_error"] == errs[0]
        assert outs[r][key]["rows_error"] == errs[1]
    if E == 4:
        assert errs == ["batch=39 not divisible by 4 shards", "rows=18 not divisible by 4 shards"]
