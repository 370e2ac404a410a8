"""The port's partition rules (the_algorithm_tpu_torch/core/partition.py)
against the JAX package's (the_algorithm_tpu/core/partition.py): path names,
rule matching and its errors on the same flax params, the JAX names of the
port's MaskNet, two-tower and TwHIN parameters with a flax kernel's [in, out]
layout against a torch weight's [out, in], and each rank's blocks under the
models' rules on 2x2, 4x1 and 1x4 meshes against the shard JAX's
``NamedSharding`` puts on the device of the same coordinates.

The port's blocks run on 4 gloo ranks (tests/torch_mesh_ranks.py, once for
the file). Everything is compared exactly: a partition moves values, it
computes nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from torch_mesh_programs import SMALL, Pair, port_model
from torch_mesh_ranks import run_ranks

from the_algorithm_tpu.core import mesh as jmesh
from the_algorithm_tpu.core import partition as jpart
from the_algorithm_tpu.models import masknet as jmn
from the_algorithm_tpu.models import twhin as jtw
from the_algorithm_tpu.models import two_tower as jtt
from the_algorithm_tpu_torch.core import partition
from the_algorithm_tpu_torch.core.partition import P
from the_algorithm_tpu_torch.models import masknet, twhin, two_tower

KINDS = ["masknet", "two_tower", "twhin"]
KEYS = ["2x2", "4x1", "1x4"]
JAX_RULES = {"masknet": jmn.PARTITION_RULES, "two_tower": jtt.PARTITION_RULES, "twhin": jtw.PARTITION_RULES}
PORT_RULES = {"masknet": masknet.PARTITION_RULES, "two_tower": two_tower.PARTITION_RULES,
              "twhin": twhin.PARTITION_RULES}
# a tree with a scalar, a size-1 leaf, a joint ('data', 'model') split and a NamedTuple's field names
TREE_RULES = [(r"^a/w$", P(("data", "model"), None)), (r"b/0", P(None, "model")), (r"^pair/left$", P("data")),
              (r".*", P())]


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX package's flax params of each model (drawn once; read only)."""
    x = jnp.zeros((2, 24))
    ids = jnp.zeros((4,), jnp.int32)
    return {
        "masknet": jax.tree_util.tree_map(np.asarray, jmn.MaskNet(jmn.MaskNetConfig(**SMALL["masknet"])).init(
            jax.random.PRNGKey(0), x)),
        "two_tower": jax.tree_util.tree_map(np.asarray, jtt.TwoTower(jtt.TwoTowerConfig(**SMALL["two_tower"])).init(
            jax.random.PRNGKey(1), ids, ids)),
        "twhin": jax.tree_util.tree_map(np.asarray, jtw.Twhin(jtw.TwhinConfig(**SMALL["twhin"])).init(
            jax.random.PRNGKey(2), ids, ids, ids)),
    }


def _tree():
    rng = np.random.default_rng(3)
    return {"a": {"w": rng.normal(size=(8, 3)).astype(np.float32), "s": np.float32(2.0)},
            "b": [rng.normal(size=(2, 8)).astype(np.float32), np.ones((1, 1), np.float32)],
            "pair": Pair(rng.normal(size=(4, 2)).astype(np.float32), np.arange(5, dtype=np.int32))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = {"params": _params(), "tree": _tree(), "tree_rules": TREE_RULES}
    return inputs, run_ranks("partition", 4, tmp_path_factory.mktemp("partition"), inputs)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_partition_spec_is_jaxs():
    assert tuple(P("model", None)) == tuple(JP("model", None))
    assert tuple(P(("data", "model"))) == tuple(JP(("data", "model")))
    assert P() == () and repr(P("model")) == "PartitionSpec('model',)"


@pytest.mark.parametrize("kind", KINDS)
def test_tree_path_names_match_jax(kind):
    params = _params()[kind]
    assert _flat(partition.tree_path_names(params)) == _flat(jpart.tree_path_names(params))


@pytest.mark.parametrize("kind", KINDS)
def test_model_rules_are_jaxs_verbatim(kind):
    assert [(pat, tuple(s)) for pat, s in PORT_RULES[kind]] == [(pat, tuple(s)) for pat, s in JAX_RULES[kind]]


@pytest.mark.parametrize("kind", KINDS)
def test_match_partition_rules_matches_jax(kind):
    """The same spec for every leaf of the JAX package's params (twin of
    tests/test_twhin.py:81-95: the tables ``P('model', None)``, the relation
    table and the towers ``P()``)."""
    params = _params()[kind]
    got = {k: tuple(v) for k, v in _flat(partition.match_partition_rules(PORT_RULES[kind], params)).items()}
    want = {k: tuple(v) for k, v in _flat(jpart.match_partition_rules(JAX_RULES[kind], params)).items()}
    assert got == want
    if kind != "masknet":
        assert got["params/user_table"] == ("model", None) and got["params/item_table"] == ("model", None)
    if kind == "twhin":
        assert got["params/relation_table"] == ()
    if kind == "masknet":
        assert {k for k, v in got.items() if v} == {"params/hidden/kernel", "params/mask_agg/kernel",
                                                    "params/trunk_0/kernel"}


def test_match_partition_rules_never_splits_scalars_and_raises_as_jax():
    tree = _tree()
    got = partition.match_partition_rules(TREE_RULES, tree)
    assert got["a"]["s"] == () and got["b"][1] == ()  # scalar, size 1
    assert got["a"]["w"] == (("data", "model"), None) and got["pair"].left == ("data",)
    params = _params()["two_tower"]
    with pytest.raises(ValueError) as port_err:
        partition.match_partition_rules([(r"user_table", P("model", None))], params)
    with pytest.raises(ValueError) as jax_err:
        jpart.match_partition_rules([(r"user_table", JP("model", None))], params)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kind", KINDS)
def test_flax_layout_names_every_param_as_jax(kind):
    """Each port parameter's JAX name, and its tensor (transposed where a
    flax kernel is [in, out]) equal to the JAX param."""
    params = _params()[kind]
    model, _ = port_model(kind, params)
    layout = partition.flax_layout(model)
    flat = _flat(params)
    assert {jn for jn, _ in layout.values()} == set(flat)
    for name, p in model.named_parameters():
        jn, transposed = layout[name]
        t = p.detach().numpy()
        np.testing.assert_array_equal(t.T if transposed else t, flat[jn])
        assert transposed == (name.endswith(".weight") and jn.endswith("/kernel"))


def test_masknets_kernel_rules_split_the_torch_weights_dim_0():
    """P(None, 'model') on a flax [in, out] kernel splits the torch [out, in]
    weight's dim 0: the translation of hidden, mask_agg and trunk_0."""
    model, rules = port_model("masknet", _params()["masknet"])
    specs = partition.module_specs(model, rules)
    for name in ("hidden.weight", "mask_agg.weight", "trunk.0.weight"):
        assert tuple(specs[name]) == ("model", None), name
    assert all(not partition.spec_axes(s) for n, s in specs.items()
               if n not in ("hidden.weight", "mask_agg.weight", "trunk.0.weight"))
    assert tuple(partition.torch_spec(P(None, "model"), True, 2)) == ("model", None)
    assert tuple(partition.torch_spec(P("model"), False, 2)) == ("model", None)


def _jax_block(array, spec, key, rank):
    d, m = (int(x) for x in key.split("x"))
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=d, model=m), jax.devices()[:d * m])
    placed = jax.device_put(jnp.asarray(array), NamedSharding(mesh, JP(*spec)))
    (block,) = [np.asarray(s.data) for s in placed.addressable_shards if s.device == jax.devices()[rank]]
    return block


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", KEYS)
def test_each_rank_holds_jaxs_block(runs, kind, key):
    """``shard_module`` under the model's rules: every rank's block of each
    parameter (transposed back where a flax kernel) is the shard JAX's
    NamedSharding of the JAX spec gives the device at the same coordinates,
    and ``gather_block`` puts the global array back."""
    inputs, outs = runs
    params = inputs["params"][kind]
    jspecs = _flat(jpart.match_partition_rules(JAX_RULES[kind], params))
    model, _ = port_model(kind, params)
    layout = partition.flax_layout(model)
    flat = _flat(params)
    d, m = (int(x) for x in key.split("x"))
    for r in range(d * m):
        got = outs[r][f"{kind}/{key}"]
        for name, (jn, transposed) in layout.items():
            want = _jax_block(flat[jn], jspecs[jn], key, r)
            block = got["blocks"][name]
            np.testing.assert_array_equal(block.T if transposed else block, want, err_msg=name)
            g = got["gathered"][name]
            np.testing.assert_array_equal(g.T if transposed else g, flat[jn], err_msg=name)


@pytest.mark.parametrize("key", KEYS)
def test_shard_tree_matches_jax(runs, key):
    """``shard_tree`` of a tree with a joint ('data', 'model') split, a
    NamedTuple and unsplit leaves: JAX's ``shard_tree`` blocks. A dim the
    blocks do not divide raises."""
    inputs, outs = runs
    tree = inputs["tree"]
    names = partition.tree_path_names(tree)
    assert names["pair"] == Pair("pair/left", "pair/right") and names["b"] == ["b/0", "b/1"]
    port_specs = partition.match_partition_rules(TREE_RULES, tree)
    d, m = (int(x) for x in key.split("x"))
    for r in range(d * m):
        got = outs[r][f"tree/{key}"]
        np.testing.assert_array_equal(got["a"]["w"], _jax_block(tree["a"]["w"], port_specs["a"]["w"], key, r))
        np.testing.assert_array_equal(got["b"][0], _jax_block(tree["b"][0], port_specs["b"][0], key, r))
        np.testing.assert_array_equal(got["pair"][0], _jax_block(tree["pair"][0], port_specs["pair"].left, key, r))
        np.testing.assert_array_equal(got["pair"][1], tree["pair"][1])
        assert float(got["a"]["s"]) == 2.0
        assert "not divisible" in outs[r][f"indivisible/{key}"]


BLOCK_SPECS = [P("model", None), P(None, "model"), P(("data", "model"), None), P("data", "model"),
               P(None, ("model", "data")), P()]


@pytest.mark.parametrize("key", KEYS + ["1x1"])
@pytest.mark.parametrize("spec", BLOCK_SPECS, ids=str)
def test_block_slices_are_where_jax_places_each_block(key, spec):
    """``block_slices`` (the region a checkpoint restore copies for each
    rank) against the index JAX's ``NamedSharding`` gives the shard on the
    device of the same mesh coordinates; ``global_shape`` from one block's
    shape back to the global one."""
    d, m = (int(v) for v in key.split("x"))
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=d, model=m), jax.devices()[:d * m])
    shape = (8, 12)
    x = jax.device_put(jnp.zeros(shape), NamedSharding(mesh, JP(*spec)))
    sizes = {"data": d, "model": m}
    for shard in x.addressable_shards:
        (i, j), = np.argwhere(mesh.devices == shard.device)
        got = partition.block_slices(shape, spec, sizes, {"data": int(i), "model": int(j)})
        assert tuple((s.start, s.stop) for s in got) == tuple(
            (s.start or 0, shape[k] if s.stop is None else s.stop) for k, s in enumerate(shard.index))
        assert partition.global_shape(shard.data.shape, spec, sizes) == shape
