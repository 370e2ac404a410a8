"""The mesh layer's training half (the_algorithm_tpu_torch/training/trainer.py
with a mesh, parallel/sharded_table.lookup_collective's backward, the models'
mesh paths) against the JAX package's ``Trainer`` and ``jax.grad`` on meshes
of the same shape: 2x2, 4x1 and 1x4.

The port runs on 4 gloo ranks (tests/torch_mesh_ranks.py, once for the
file; the programs and the small models are in tests/torch_mesh_programs.py);
JAX runs each case on a sub-mesh of its 8 CPU devices under ``jax.jit``.
Each rank's parameter blocks are held against the shard JAX's ``Trainer``
keeps on the device of the same coordinates (a flax kernel transposed).

Tolerances:

- table gradients of Σ w_i·t[ids_i] with whole-number weights: exact (sums
  of whole numbers);
- after adam steps, the Adam rule of the card checks (PERF.md §2): no entry
  off by more than 2·steps·lr, and at most 0.1% of a rank's entries off by
  more than 1e-5: Adam's first step moves an entry by ±lr·sign(g), so an
  entry whose gradient cancels to f32 noise moves 2·lr apart between two
  summation orders (fault 5, restated: JAX's partitioned ``Trainer`` does
  the same against eager ``jax.grad``);
- after sgd or adagrad steps rtol 1e-5, atol 1e-6 of the parameter's
  largest entry (an entry near 0 is a difference of two f32 numbers, each
  a gradient summed in another order);
- forward rows rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6, the JAX
  package's own explicit-lookup tests' tolerances
  (tests/test_parallel.py:185-205, tests/test_twhin.py:97-150);
- the loss rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as JP
from torch_mesh_programs import EVAL_METRICS, SMALL, TRAIN_CASES, port_model
from torch_mesh_ranks import run_ranks
from torch_port_util import PAD_ID

from the_algorithm_tpu.core import mesh as jmesh
from the_algorithm_tpu.data import datarecord as jax_datarecord
from the_algorithm_tpu.models import light_ranker as jax_lr
from the_algorithm_tpu.models import masknet as jmn
from the_algorithm_tpu.models import twhin as jtw
from the_algorithm_tpu.models import two_tower as jtt
from the_algorithm_tpu.ops import hashed_lr as jax_hashed_lr
from the_algorithm_tpu.parallel import sharded_table as jst
from the_algorithm_tpu.serving.model_registry import load_params_npz
from the_algorithm_tpu.training import data_record_trainer as jax_drt
from the_algorithm_tpu.training.trainer import Trainer as JaxTrainer
from the_algorithm_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from the_algorithm_tpu_torch.core import partition
from the_algorithm_tpu_torch.data import datarecord
from the_algorithm_tpu_torch.training import data_record_trainer as drt
from test_torch_data_record_trainer import LABEL_FID, _make_shards

STEPS = 3
SGD_RTOL, SGD_SHARE = 1e-5, 1e-6
ADAM_ATOL, ADAM_SHARE = 1e-5, 1e-3
FWD_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
LOSS_RTOL = 1e-5
B = 16
# finding 1 and 3: a [32, 4] table, ids past both ends and PAD_ID, weights 1..8
F5_IDS = np.array([1, 5, 31, 32, 40, -1, -33, PAD_ID], np.int32)


def _jax_models():
    return {
        "masknet": jmn.MaskNet(jmn.MaskNetConfig(**SMALL["masknet"])),
        "two_tower": jtt.TwoTower(jtt.TwoTowerConfig(**SMALL["two_tower"])),
        "twhin": jtw.Twhin(jtw.TwhinConfig(**SMALL["twhin"])),
    }


def _batches(rng):
    out = {"masknet": [], "two_tower": [], "twhin": []}
    tt, tw = SMALL["two_tower"], SMALL["twhin"]
    for _ in range(STEPS):
        out["masknet"].append({"x": rng.normal(size=(B, 24)).astype(np.float32),
                               "y": (rng.random((B, 3)) < 0.4).astype(np.float32)})
        # ids past both ends and PAD_ID in every batch: each path's own rule applies
        users = rng.integers(-tt["num_users"] - 4, tt["num_users"] + 8, B).astype(np.int32)
        users[3] = PAD_ID
        items = rng.integers(-4, tt["num_items"] + 4, B).astype(np.int32)
        out["two_tower"].append({"users": users, "items": items})
        out["twhin"].append({"users": rng.integers(-2, tw["num_users"] + 2, B).astype(np.int32),
                             "relations": rng.integers(0, 6, B).astype(np.int32),
                             "items": rng.integers(-3, tw["num_items"] + 3, B).astype(np.int32)})
    return out


def _init(models, batches):
    b = batches
    return {
        "masknet": models["masknet"].init(jax.random.PRNGKey(0), jnp.asarray(b["masknet"][0]["x"])),
        "two_tower": models["two_tower"].init(jax.random.PRNGKey(1), jnp.asarray(b["two_tower"][0]["users"]),
                                              jnp.asarray(b["two_tower"][0]["items"])),
        "twhin": models["twhin"].init(jax.random.PRNGKey(2), *(jnp.asarray(b["twhin"][0][k])
                                                              for k in ("users", "relations", "items"))),
    }


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _drt_inputs(tmp):
    paths, fids, _, _ = _make_shards(tmp)
    return {"paths": paths, "vocab": np.sort(fids), "label_vocab": np.asarray([LABEL_FID], np.int64)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(12)
    batches = _batches(rng)
    models = _jax_models()
    params = _host(_init(models, batches))
    tmp = tmp_path_factory.mktemp("mesh_training")
    inputs = {"params": params, "batches": batches, "dir": str(tmp), "drt": _drt_inputs(tmp),
              "f5_table": rng.normal(size=(32, 4)).astype(np.float32), "f5_ids": F5_IDS,
              "f5_w": np.arange(1, 9, dtype=np.float32)}
    return inputs, run_ranks("mesh_training", 4, tmp, inputs)


def _mesh(key):
    d, m = (int(x) for x in key.split("x"))
    return jmesh.make_mesh(jmesh.MeshSpec(data=d, model=m), jax.devices()[:d * m])


def _ranks(key):
    d, m = (int(x) for x in key.split("x"))
    return list(range(d * m))


JAX_RULES = {"masknet": jmn.PARTITION_RULES, "two_tower": jtt.PARTITION_RULES, "twhin": jtw.PARTITION_RULES}


def _jax_loss(kind, model):
    if kind == "masknet":
        return lambda p, b: (jmn.multi_task_loss(model.apply(p, b["x"]), b["y"]), {})
    if kind == "two_tower":
        return lambda p, b: (jtt.in_batch_softmax_loss(*model.apply(p, b["users"], b["items"]),
                                                       SMALL[kind]["temperature"], b["items"]), {})
    return lambda p, b: (jtw.twhin_loss(*model.apply(p, b["users"], b["relations"], b["items"]), b["items"],
                                        SMALL[kind]["temperature"]), {})


def _jax_model(kind, explicit):
    if kind == "masknet":
        return jmn.MaskNet(jmn.MaskNetConfig(**SMALL[kind]))
    if kind == "two_tower":
        return jtt.TwoTower(jtt.TwoTowerConfig(**SMALL[kind], explicit_lookup=explicit))
    return jtw.Twhin(jtw.TwhinConfig(**SMALL[kind], explicit_lookup=explicit))


_JAX_RUNS = {}


def _jax_trainer(inputs, kind, explicit, cfg, key):
    """JAX's Trainer on the sub-mesh of ``key`` after STEPS steps, and its
    losses (fresh host copies of the params: the step donates them); each
    run once for the file."""
    run = (kind, explicit, tuple(sorted(cfg.items())), key)
    if run not in _JAX_RUNS:
        _JAX_RUNS[run] = _run_jax_trainer(inputs, kind, explicit, cfg, key)
    return _JAX_RUNS[run]


def _run_jax_trainer(inputs, kind, explicit, cfg, key):
    mesh = _mesh(key)
    model = _jax_model(kind, explicit)
    with jmesh.local_mesh(mesh):
        jt = JaxTrainer(_jax_loss(kind, model), _host(inputs["params"][kind]), mesh, JAX_RULES[kind],
                        JaxTrainerConfig(**cfg))
        losses = [float(jt.train_step(b)["loss"]) for b in inputs["batches"][kind]]
    return jt, losses


def _leaf(tree, jax_name):
    for part in jax_name.split("/"):
        tree = tree[part]
    return tree


def _shard(leaf, rank, transposed, spec, key):
    """Rank ``rank``'s block of a JAX global array under the port's ``spec``
    (its torch layout). The values are JAX's; where the blocks lie is the
    rules' (XLA may leave a step's output placed otherwise: a bias under
    ``P()`` comes back split like its kernel)."""
    x = np.asarray(leaf)
    x = x.T if transposed else x
    d, m = (int(v) for v in key.split("x"))
    coord = {"data": rank // m, "model": rank % m}
    size = {"data": d, "model": m}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        pos, n = 0, 1
        for a in axes:
            pos, n = pos * size[a] + coord[a], n * size[a]
        per = x.shape[dim] // n
        x = np.take(x, range(pos * per, (pos + 1) * per), axis=dim)
    return x


def layout(inputs, kind):
    """The port model's parameter names → (JAX name, transposed)."""
    return partition.flax_layout(port_model(kind, inputs["params"][kind])[0])


def specs_of(inputs, kind):
    """The port model's parameter names → its spec (torch layout)."""
    model, rules = port_model(kind, inputs["params"][kind])
    return partition.module_specs(model, rules)


def assert_adam_rule(got: dict, want: dict, steps: float, lr: float):
    """The Adam rule over a rank's blocks (name → array): no entry off by
    more than 2·steps·lr, and at most ADAM_SHARE of all entries off by more
    than ADAM_ATOL."""
    total = beyond = 0
    for n in want:
        diff = np.abs(np.asarray(got[n], np.float64) - np.asarray(want[n], np.float64))
        assert diff.max(initial=0) <= 2 * steps * lr, (n, diff.max())
        total += diff.size
        beyond += int((diff > ADAM_ATOL).sum())
    assert beyond <= ADAM_SHARE * total, f"{beyond} of {total} entries off by more than {ADAM_ATOL}"


# -- fault 5, restated ----------------------------------------------------------


def _f5_jax_grads(inputs, key):
    t, ids, w = (jnp.asarray(inputs[k]) for k in ("f5_table", "f5_ids", "f5_w"))
    mesh = _mesh(key)
    ts = jax.device_put(t, jax.sharding.NamedSharding(mesh, JP("model", None)))
    ids_s = jax.device_put(ids, jax.sharding.NamedSharding(mesh, JP("data")))
    implicit = jax.jit(jax.grad(lambda tb: jnp.sum(w[:, None] * tb[ids_s])))(ts)
    explicit = jax.jit(jax.grad(lambda tb: jnp.sum(w[:, None] * jst.lookup_collective(tb, ids, mesh))))(ts)
    return np.asarray(jax.grad(lambda tb: jnp.sum(w[:, None] * tb[ids]))(t)), np.asarray(implicit), \
        np.asarray(explicit)


@pytest.mark.parametrize("key", ["2x2", "1x4"])
def test_fault5_implicit_table_gradient_is_jax_grad_split_or_not(world, key):
    """Finding 1: the table sharded P('model', None), ids P('data'): jitted
    ``jax.grad`` gives eager ``jax.grad``'s gradient exactly, nonzero only on
    rows 1, 5 and 31 (31 takes ids 31 and -1: 3 + 6); 32, 40, -33 and
    PAD_ID are dropped. The port's ``table_read`` and sharded ``lookup``
    give each rank that gradient (its block), exactly."""
    inputs, outs = world
    eager, implicit, _ = _f5_jax_grads(inputs, key)
    np.testing.assert_array_equal(implicit, eager)
    assert np.nonzero(eager[:, 0])[0].tolist() == [1, 5, 31] and eager[31, 0] == 9.0
    E = int(key.split("x")[1])
    for r in _ranks(key):
        got = outs[r][f"fault5/{key}"]
        np.testing.assert_array_equal(got["table_read"], eager)
        np.testing.assert_array_equal(got["lookup"], eager.reshape(E, -1, 4)[r % E])


@pytest.mark.parametrize("key", ["2x2", "1x4"])
def test_fault5_explicit_lookup_trains_the_clipped_row(world, key):
    """Finding 3: through ``lookup_collective`` JAX clips, and the clip's
    gradient follows the clipped row: row 0 takes -1 and -33 (6 + 7), row 31
    takes 31, 32, 40 and PAD_ID (3 + 4 + 5 + 8). The port's backward gives
    each rank its block of that gradient exactly, and rows read as JAX's."""
    inputs, outs = world
    _, _, explicit = _f5_jax_grads(inputs, key)
    rows = {int(i): float(explicit[i, 0]) for i in np.nonzero(explicit[:, 0])[0]}
    assert rows == {0: 13.0, 1: 1.0, 5: 2.0, 31: 20.0}
    mesh = _mesh(key)
    want_rows = np.asarray(jax.jit(lambda: jst.lookup_collective(jnp.asarray(inputs["f5_table"]),
                                                                 jnp.asarray(F5_IDS), mesh))())
    E = int(key.split("x")[1])
    for r in _ranks(key):
        got = outs[r][f"fault5/{key}"]
        np.testing.assert_array_equal(got["collective"], explicit.reshape(E, -1, 4)[r % E])
        np.testing.assert_array_equal(got["collective_rows"], want_rows.reshape(len(_ranks(key)), -1, 4)[r])


def test_fault5_overflowed_requests_train_nothing(world):
    """``capacity`` 1 on the 1x4 mesh: each requester keeps its first id for
    each owner; the requests it drops read zeros and train no row."""
    _, outs = world
    ids = F5_IDS.reshape(4, 2)  # each rank's two ids
    want = np.zeros((32, 4), np.float32)
    for req in ids:
        owners = np.clip(req // 8, 0, 3)
        kept = [i for j, i in enumerate(req) if owners[j] not in owners[:j]]
        for i in kept:
            want[np.clip(i, 0, 31)] += 1.0
    for r in range(4):
        np.testing.assert_array_equal(outs[r]["fault5/1x4"]["collective_cap1"], want.reshape(4, 8, 4)[r])


def test_fault5_jax_trainer_is_off_eager_grad_only_by_adam_noise():
    """Finding 2: one adamw(1e-2) step of JAX's Trainer on 2x4, 8x1 and 1x8
    meshes against eager ``jax.grad`` then ``optax.adamw``, with ids past
    both ends: every entry within 2·lr; the entries off by more than 1e-5
    sit in rows whose eager gradient is f32 noise (below 1e-5 of the
    largest), in-range ids whose Adam step ±lr·sign(g) flips with the
    summation order (on 8x1 too, where no table is split); the rows read by
    past-the-end ids agree."""
    cfg = jtt.TwoTowerConfig(num_users=32, num_items=32, embed_dim=8, tower_hidden=(8,))
    model = jtt.TwoTower(cfg)
    users = np.array([0, 1, 2, 3, 31, 32, 40, -1, -33, PAD_ID, 5, 6, 7, 8, 9, 10], np.int32)
    items = (np.arange(16) * 3 % 32).astype(np.int32)
    params = _host(model.init(jax.random.PRNGKey(0), jnp.asarray(users), jnp.asarray(items)))
    batch = {"users": users, "items": items}

    def loss(p, b):
        u, v = model.apply(p, b["users"], b["items"])
        return jtt.in_batch_softmax_loss(u, v, 0.1, b["items"]), {}

    g = jax.grad(lambda p: loss(p, batch)[0])(params)
    tx = optax.adamw(1e-2, weight_decay=0.0)
    eager = _host(optax.apply_updates(params, tx.update(g, tx.init(params), params)[0]))
    flat_g = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(g)}
    largest = max(np.abs(v).max() for v in flat_g.values())
    noisy_rows = {n: np.abs(v).max(axis=1) < 1e-5 * largest for n, v in flat_g.items() if n.endswith("_table")}
    assert any(r.any() for r in noisy_rows.values()), "the batch should hold an in-range row with a noise gradient"
    for d, m in ((2, 4), (8, 1), (1, 8)):
        mesh = jmesh.make_mesh(jmesh.MeshSpec(data=d, model=m), jax.devices()[:d * m])
        jt = JaxTrainer(loss, _host(params), mesh, [(r"(user|item)_table", JP("model", None)), (r".*", JP())],
                        JaxTrainerConfig(learning_rate=1e-2))
        jt.train_step(batch)
        got = _host(jt.params)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(eager)):
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            diff = np.abs(a - b)
            assert diff.max() <= 2 * 1e-2 + 1e-7, (d, m, name)
            if name in noisy_rows:
                off_rows = diff.max(axis=1) > 1e-5
                assert not (off_rows & ~noisy_rows[name]).any(), (d, m, name, np.nonzero(off_rows)[0])
                for row in (0, 31):  # the rows past-the-end and far-negative ids read
                    if not noisy_rows[name][row]:
                        assert diff[row].max() <= 1e-5, (d, m, name, row)
            else:
                assert (diff > 1e-5).mean() <= ADAM_SHARE, (d, m, name)


# -- the Trainer on a mesh against JAX's ------------------------------------------


CASE_KEYS = [(case, key) for case, (_, _, _, keys) in TRAIN_CASES.items() for key in keys]


@pytest.mark.parametrize("case,key", CASE_KEYS, ids=[f"{c}-{k}" for c, k in CASE_KEYS])
def test_trainer_steps_follow_the_jax_trainer_on_a_mesh(world, case, key):
    """Three steps of the port's Trainer with the model's PARTITION_RULES
    against JAX's Trainer on the same mesh shape: each step's loss (the
    global batch's), and each rank's parameter blocks and adam moments (or
    adagrad's sums) against JAX's blocks on the same device coordinates."""
    inputs, outs = world
    kind, explicit, cfg, _ = TRAIN_CASES[case]
    jt, losses = _jax_trainer(inputs, kind, explicit, cfg, key)
    lay = layout(inputs, kind)
    opt = cfg.get("optimizer", "adam")
    jax_states = jax.tree_util.tree_leaves(
        jt.opt_state, is_leaf=lambda x: isinstance(x, (optax.ScaleByAdamState, optax.ScaleByRssState)))
    (jstate,) = [s for s in jax_states if isinstance(s, (optax.ScaleByAdamState, optax.ScaleByRssState))] or [None]
    specs = specs_of(inputs, kind)
    for r in _ranks(key):
        got = outs[r][f"{case}/{key}"]
        np.testing.assert_allclose(got["loss"], losses, rtol=LOSS_RTOL)
        want = {n: _shard(_leaf(jt.params, jn), r, tr, specs[n], key) for n, (jn, tr) in lay.items()}
        assert {n: v.shape for n, v in got["params"].items()} == {n: v.shape for n, v in want.items()}
        if opt == "adam":
            assert_adam_rule(got["params"], want, STEPS, cfg["learning_rate"])
            for moment in ("mu", "nu"):
                jm = {n: _shard(_leaf(getattr(jstate, moment), jn), r, tr, specs[n], key) for n, (jn, tr) in lay.items()}
                for n in jm:
                    scale = max(np.abs(jm[n]).max(), 1e-30)
                    np.testing.assert_allclose(got["state"][n][moment], jm[n], rtol=0, atol=1e-4 * scale,
                                               err_msg=f"{moment} {n}")
        else:
            for n in want:
                np.testing.assert_allclose(got["params"][n], want[n], rtol=SGD_RTOL,
                                           atol=SGD_SHARE * np.abs(want[n]).max(), err_msg=n)
            if opt == "adagrad":
                for n, (jn, tr) in lay.items():
                    np.testing.assert_allclose(got["state"][n]["sum_of_squares"],
                                               _shard(_leaf(jstate.sum_of_squares, jn), r, tr, specs[n], key),
                                               rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("kind", ["two_tower", "twhin"])
@pytest.mark.parametrize("key", ["2x2", "1x4"])
def test_explicit_lookup_forward_and_gradient_match_jax(world, kind, key):
    """The explicit-lookup forward on this rank's block of the joint batch,
    against JAX's jitted apply under the same mesh (its joint block), and the
    Trainer's gradients after the gradient rule against ``jax.grad`` of the
    global loss (tests/test_parallel.py:185-205, tests/test_twhin.py:97-150)."""
    inputs, outs = world
    mesh = _mesh(key)
    model = _jax_model(kind, True)
    b = inputs["batches"][kind][0]
    names = ("users", "items") if kind == "two_tower" else ("users", "relations", "items")
    params = _host(inputs["params"][kind])
    with jmesh.local_mesh(mesh):
        fwd = jax.jit(lambda p: model.apply(p, *(jnp.asarray(b[k]) for k in names)))(params)
        g = jax.jit(jax.grad(lambda p: _jax_loss(kind, model)(p, b)[0]))(params)
    fwd = [np.asarray(x) for x in fwd]
    lay = layout(inputs, kind)
    n_ranks = len(_ranks(key))
    for r in _ranks(key):
        got_fwd = outs[r][f"explicit_fwd/{kind}/{key}"]
        for got_x, want_x in zip(got_fwd, fwd):
            np.testing.assert_allclose(got_x, want_x.reshape(n_ranks, -1, want_x.shape[-1])[r], rtol=FWD_RTOL,
                                       atol=1e-7)
        grads = outs[r][f"explicit_grad/{kind}/{key}"]
        for n, (jax_name, tr) in lay.items():
            want = np.asarray(_leaf(g, jax_name))
            np.testing.assert_allclose(grads[n], want.T if tr else want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)


@pytest.mark.parametrize("clipped,plain", [("two_tower_x_clip/2x2", "two_tower_x/2x2"),
                                           ("masknet_clip/1x4", "masknet/1x4")])
def test_the_global_norm_clip_bites_on_a_mesh(world, clipped, plain):
    """max_grad_norm 0.2 is below these gradients' global norm (the clipped
    runs, held to JAX's above, move other params than the plain runs)."""
    _, outs = world
    for r in range(4):
        got, base = outs[r][clipped]["params"], outs[r][plain]["params"]
        assert any(not np.array_equal(got[n], base[n]) for n in got)


def test_local_batches_give_the_global_batch_step(world):
    """4x1, each rank feeding its own quarter of every batch
    (``local_batches``, JAX's process-local path): the reported loss is the
    global batch's (JAX's, rtol 1e-5) and the params equal those of the
    same mesh fed the global batch, bit for bit."""
    inputs, outs = world
    _, losses = _jax_trainer(inputs, "two_tower", False, TRAIN_CASES["two_tower"][2], "4x1")
    for r in range(4):
        got, full = outs[r]["local/4x1"], outs[r]["two_tower/4x1"]
        np.testing.assert_allclose(got["loss"], losses, rtol=LOSS_RTOL)
        assert got["loss"] == full["loss"]
        for n in full["params"]:
            np.testing.assert_array_equal(got["params"][n], full["params"][n])


def test_checkpoint_round_trip_on_a_mesh(world):
    """2x2: each rank saves its blocks; ``restore`` on the same mesh shape,
    in the same Trainer or a fresh one, gives the saved bits (params and
    optimizer state) and the same next step; another mesh shape restores
    the same step (its bits: the tests below)."""
    _, outs = world
    for r in range(4):
        assert all(outs[r]["ckpt"]["same"]), outs[r]["ckpt"]
        assert outs[r]["ckpt"]["steps"] == [2]
        assert outs[r]["ckpt_other_mesh"]["1x4"]["step"] == 2


RESTORES = ("1x4", "4x1", "one_device", "2x2/without_specs", "1x4/without_specs")


def _restored_blocks(got, saved, rank, key, specs):
    """Each restored block of ``got`` (params, Adam's moments) against the
    saved global arrays' block of ``rank`` under the restoring mesh ``key``
    (the whole array on one device), bit for bit; the counts int32 and equal."""
    mesh_key = key.partition("/")[0]
    for part in ("params", "mu", "nu"):
        for n, want in saved[part].items():
            block = want if mesh_key == "one_device" else _shard(want, rank, False, specs[n], mesh_key)
            np.testing.assert_array_equal(got[part][n], block, err_msg=f"{part} {n}")
    assert got["count"] == {n: (c, "torch.int32") for n, c in saved["count"].items()}
    assert got["step"] == 2


@pytest.mark.parametrize("key", RESTORES)
def test_checkpoint_restores_on_another_mesh_with_the_saved_bits(world, key):
    """The 2x2 checkpoint of step 2 restored on 1x4, on 4x1 and into a
    one-device Trainer, and (as written before checkpoints recorded their
    specs) on its own 2x2 and on 1x4 by the Trainer's rules: every rank
    holds the saved global arrays' values in its own blocks, params and
    Adam moments, bit for bit, the int32 count and the step."""
    inputs, outs = world
    specs = specs_of(inputs, "two_tower")
    ranks = range(1) if key == "one_device" else range(4)
    for r in ranks:
        _restored_blocks(outs[r]["ckpt_other_mesh"][key], outs[0]["ckpt_global"], r, key, specs)


_JAX_RESTORES = {}


def _jax_restored_step(inputs, tmp, key):
    """JAX's Trainer saved by orbax on 2x2 after two steps (explicit
    two-tower, adam 1e-2), restored on the mesh of ``key`` (a 1x1 mesh and
    the implicit model for one device) and stepped on the third batch: its
    params. The save runs once for the file."""
    cfg = TRAIN_CASES["two_tower_x"][2]
    batches = inputs["batches"]["two_tower"]
    ckpt = str(tmp / "jax_ckpt")
    if not _JAX_RESTORES:
        mesh, model = _mesh("2x2"), _jax_model("two_tower", True)
        with jmesh.local_mesh(mesh):
            jt = JaxTrainer(_jax_loss("two_tower", model), _host(inputs["params"]["two_tower"]), mesh,
                            JAX_RULES["two_tower"], JaxTrainerConfig(**cfg, checkpoint_dir=ckpt))
            for b in batches[:2]:
                jt.train_step(b)
            jt.save()
    if key not in _JAX_RESTORES:
        mesh_key = "1x1" if key == "one_device" else key
        mesh, model = _mesh(mesh_key), _jax_model("two_tower", key != "one_device")
        with jmesh.local_mesh(mesh):
            jt = JaxTrainer(_jax_loss("two_tower", model), _host(inputs["params"]["two_tower"]), mesh,
                            JAX_RULES["two_tower"], JaxTrainerConfig(**cfg, checkpoint_dir=ckpt))
            jt.restore(2)
            jt.opt_state = _replicated_scalars(jt.opt_state, mesh)  # fault 12
            jt.train_step(batches[2])
        _JAX_RESTORES[key] = _host(jt.params)
    return _JAX_RESTORES[key]


def _replicated_scalars(tree, mesh):
    """``tree`` with its scalars replicated over ``mesh``: orbax restores
    adam's count on the first device alone (fault 12)."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, jax.sharding.NamedSharding(mesh, JP())) if np.ndim(x) == 0 else x, tree)


def test_fault_12_jax_restore_then_step_raises_on_a_mesh(world, tmp_path_factory):
    """In the reference: JAX's ``Trainer.restore`` on a mesh of more than one
    device (here the 2x2 it saved on) brings adam's scalar count back on the
    first device alone, beside params spread over the mesh, so the next
    ``train_step`` raises. The port's restored Trainers step (above)."""
    inputs, outs = world
    _jax_restored_step(inputs, tmp_path_factory.getbasetemp(), "one_device")  # the 2x2 save
    mesh, model = _mesh("2x2"), _jax_model("two_tower", True)
    with jmesh.local_mesh(mesh):
        jt = JaxTrainer(_jax_loss("two_tower", model), _host(inputs["params"]["two_tower"]), mesh,
                        JAX_RULES["two_tower"], JaxTrainerConfig(**TRAIN_CASES["two_tower_x"][2],
                                                                 checkpoint_dir=str(tmp_path_factory.getbasetemp()
                                                                                    / "jax_ckpt")))
        jt.restore(2)
        with pytest.raises(ValueError, match="incompatible devices"):
            jt.train_step(inputs["batches"]["two_tower"][2])
    for r in range(4):
        assert all("next" in outs[r]["ckpt_other_mesh"][key] for key in RESTORES)


@pytest.mark.parametrize("key", ["1x4", "4x1", "one_device"])
def test_restored_step_follows_jax_orbax_restore(world, tmp_path_factory, key):
    """The step after the restore against JAX's own: orbax restores the 2x2
    checkpoint on the same mesh shape (``StandardRestore`` reshards) and
    takes the same batch; each rank's blocks within the Adam rule of JAX's
    (three steps in all)."""
    inputs, outs = world
    params = _jax_restored_step(inputs, tmp_path_factory.getbasetemp(), key)
    lay, specs = layout(inputs, "two_tower"), specs_of(inputs, "two_tower")
    for r in range(1) if key == "one_device" else range(4):
        want = {n: (np.asarray(_leaf(params, jn)).T if tr else np.asarray(_leaf(params, jn)))
                if key == "one_device" else _shard(_leaf(params, jn), r, tr, specs[n], key)
                for n, (jn, tr) in lay.items()}
        assert_adam_rule(outs[r]["ckpt_other_mesh"][key]["next"], want, STEPS,
                         TRAIN_CASES["two_tower_x"][2]["learning_rate"])


def test_restore_of_other_names_or_shapes_raises(world):
    """A Trainer whose parameters are named otherwise (TwHIN on 1x4) or
    shaped otherwise (48 users, one device) refuses the 2x2 checkpoint with
    a ValueError naming both layouts and the parameters apart."""
    _, outs = world
    for r in range(4):
        got = outs[r]["ckpt_other_mesh"]
        assert "saved on a {'data': 2, 'model': 2} mesh" in got["error/names"]
        assert "here on a {'data': 1, 'model': 4} mesh" in got["error/names"]
        assert "relation_table" in got["error/names"] and "user_tower" in got["error/names"]
        assert "here on one device" in got["error/shapes"] and "user_table" in got["error/shapes"]
        assert "(48, 8)" in got["error/shapes"] and "(32, 8)" in got["error/shapes"]


def test_export_on_a_mesh_writes_the_jax_trainers_npz(world, tmp_path):
    """2x2 after three steps: the first rank writes the npz JAX's export
    writes for its Trainer: the same names and shapes, the global arrays
    within the Adam rule, the extras equal."""
    inputs, outs = world
    jt, _ = _jax_trainer(inputs, "two_tower", True, TRAIN_CASES["two_tower_x"][2], "2x2")
    want = jt.export(str(tmp_path / "jax" / "1"), extra={"note": np.arange(3)})
    got = outs[0]["export"]
    written = load_params_npz(f"{inputs['dir']}/export/1")
    assert set(got) == set(want) == set(written)
    for k in got:
        assert got[k].shape == np.asarray(want[k]).shape
        np.testing.assert_array_equal(written[k], got[k])
    np.testing.assert_array_equal(got["note"], np.arange(3))
    assert_adam_rule({k: v for k, v in got.items() if k != "note"},
                     {k: np.asarray(v) for k, v in want.items() if k != "note"}, STEPS, 1e-2)


def test_fit_on_a_mesh_takes_the_first_ranks_metrics(world):
    """``fit`` with the prefetch feeder and an eval every 2 steps whose
    metric differs by rank: every rank takes rank 0's (best at its 2nd eval,
    stopped after two stale ones: step 8), as JAX's single-program fit does."""
    _, outs = world
    for r in range(4):
        assert outs[r]["fit"] == {"step": 8, "best": 4, "m": EVAL_METRICS[3]}


def test_data_record_trainer_on_a_mesh_follows_jax(world):
    """The light ranker's DataRecordTrainer on 2x2 (replicated weights, the
    batch split over 'data'), 40 adagrad steps, against JAX's
    DataRecordTrainer on the same mesh shape and files: weights within atol
    1e-5 (tests/test_torch_data_record_trainer.py's tolerance), the same on
    every rank."""
    inputs, outs = world
    d = inputs["drt"]
    cfg = jax_lr.LightRankerConfig(n_bins=8, output_bits=12)
    dataset = jax_datarecord.TRecDataset(d["paths"], seed=0)
    hd = drt.calibrate_from_files(_port_dataset(d), d["vocab"], 8, 12, max_records=1024)

    def jbatch_fn(raw):
        return (jax_hashed_lr.SparseBatch(jnp.asarray(raw["indices"]), jnp.asarray(raw["sparse_values"]),
                                          jnp.asarray(raw["sparse_mask"])), jnp.asarray(raw["labels"][:, 0]))

    jtrainer = jax_drt.DataRecordTrainer(
        lambda p, b: (jax_lr.loss_fn(p, b[0], b[1], l2=cfg.l2), {}), jax_lr.init_params(cfg), _mesh("2x2"),
        [(r".*", JP())], jax_datarecord.hashed_lr_transform(d["vocab"], hd.bins.bin_vals, 12, 12, d["label_vocab"]),
        jbatch_fn, jax_drt.DataRecordTrainerConfig(batch_size=256, n_bins=8, output_bits=12,
                                                   trainer=JaxTrainerConfig(learning_rate=0.5, optimizer="adagrad")))
    jtrainer.fit_from_files(dataset, num_steps=40)
    for r in range(4):  # the weights replicated: whole on every rank
        got = outs[r]["drt"]
        np.testing.assert_allclose(got["weights"], np.asarray(jtrainer.params["weights"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["bias"], np.asarray(jtrainer.params["bias"]), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["weights"], outs[0]["drt"]["weights"])


def _port_dataset(d):
    return datarecord.TRecDataset(d["paths"], seed=0)
