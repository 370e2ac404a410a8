"""Embedding-table training in the port against the JAX package: the
in-batch softmax losses, the table gradient (the D-wide run collapse behind
``ops/gather.table_read``), the ``Trainer`` over a two-tower model, and the
JAX tests' planted preferences.

Same numpy ids and the same flax params on both sides. Tolerances: losses
rtol 1e-5 (f32 logits of D-term products and a log-softmax over B, summed
in another order); gradients rtol 1e-5 of each entry or 1e-6 of the
parameter's largest entry (f32 sums over the batch of terms up to 1/τ = 20
times an entry, which cancel, in another order); the collapse's plain version against the JAX
Pallas kernel (interpret mode) rtol 1e-5, atol 1e-5 (f32 sums of up to ~120
unit-normal terms, in slot order against the Pallas scan's tree: a few
units of 2⁻²⁴ times the terms' total); ``Trainer`` params after adam
steps under the Adam rule of PERF.md §2 (no entry off by more than
2·steps·lr, at most 0.1% off by more than 1e-5: each step moves a weight by
at most lr = 1e-2, and an entry whose gradient sits near 0 in f32 noise may
take the other sign).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_util  # noqa: F401  (pins torch to one thread)
from jax.sharding import PartitionSpec as P

from the_algorithm_tpu.models import twhin as jtw
from the_algorithm_tpu.models import two_tower as jtt
from the_algorithm_tpu.ops import seg_scan as jseg
from the_algorithm_tpu.training.trainer import Trainer as JaxTrainer
from the_algorithm_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from the_algorithm_tpu_torch.models import twhin, two_tower
from the_algorithm_tpu_torch.ops import gather, seg_scan
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.training.trainer import Trainer, TrainerConfig

RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
GRAD_SHARE = 1e-6  # of a parameter's largest gradient entry
U, N, D = 40, 96, 16
# repeated, the last row, past the end (JAX reads the clamped row, its
# gradient is dropped), negative (wrapped), far negative (clamped, dropped)
USER_IDS = np.array([0, 5, 5, U - 1, U, U + 17, -1, -3, -(U + 9), 5, 0, 7], np.int32)
ITEM_IDS = np.array([1, 7, 7, N - 1, N, 3 * N, -1, -N, -(N + 1), 2, 7, 1], np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _two_tower(hidden=(24,), temperature=0.05, users=U, items=N, dim=D, seed=0):
    cfg = jtt.TwoTowerConfig(num_users=users, num_items=items, embed_dim=dim, tower_hidden=hidden,
                             temperature=temperature)
    model = jtt.TwoTower(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32))
    port = two_tower.TwoTower(two_tower.TwoTowerConfig(users, items, dim, hidden, temperature), device="cpu")
    port.load_state_dict(two_tower.params_from_flax(params))
    return cfg, model, params, port


def _twhin(users=U, items=N, dim=D, seed=1):
    cfg = jtw.TwhinConfig(num_users=users, num_items=items, embed_dim=dim)
    model = jtw.Twhin(cfg)
    z = jnp.zeros((2,), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), z, z, z)
    port = twhin.Twhin(twhin.TwhinConfig(users, items, dim), device="cpu")
    port.load_state_dict(twhin.params_from_flax(params))
    return cfg, model, params, port


def _port_grads(model):
    """The port's gradients under the flax names (kernels back to [in, out])."""
    return _flat(two_tower.params_to_flax({k: p.grad for k, p in model.named_parameters()})["params"]) \
        if isinstance(model, two_tower.TwoTower) else {k: p.grad.numpy() for k, p in model.named_parameters()}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k in want:
        atol = max(GRAD_ATOL, GRAD_SHARE * float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=atol, err_msg=k)


# -- the losses ---------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("temperature", [0.05, 1.0])
def test_in_batch_softmax_loss_equals_jax(masked, temperature):
    rng = np.random.default_rng(3)
    u = rng.normal(size=(24, D)).astype(np.float32)
    v = rng.normal(size=(24, D)).astype(np.float32)
    ids = rng.integers(0, 6, 24).astype(np.int32) if masked else None  # many accidental hits
    want = jtt.in_batch_softmax_loss(jnp.asarray(u), jnp.asarray(v), temperature,
                                     None if ids is None else jnp.asarray(ids))
    got = two_tower.in_batch_softmax_loss(torch.from_numpy(u), torch.from_numpy(v), temperature,
                                          None if ids is None else torch.from_numpy(ids))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_accidental_hit_masking_lowers_the_loss_as_jax():
    """tests/test_models_training.py's masking case on both packages."""
    u = v = np.eye(4, dtype=np.float32)
    ids = np.array([7, 7, 8, 9], np.int32)
    for ids_or_none in (ids, None):
        want = jtt.in_batch_softmax_loss(jnp.asarray(u), jnp.asarray(v), 1.0,
                                         None if ids_or_none is None else jnp.asarray(ids_or_none))
        got = two_tower.in_batch_softmax_loss(torch.from_numpy(u), torch.from_numpy(v), 1.0,
                                              None if ids_or_none is None else torch.from_numpy(ids_or_none))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    masked = two_tower.in_batch_softmax_loss(torch.from_numpy(u), torch.from_numpy(v), 1.0, torch.from_numpy(ids))
    assert float(masked) <= float(two_tower.in_batch_softmax_loss(torch.from_numpy(u), torch.from_numpy(v), 1.0)) + 1e-6


@pytest.mark.parametrize("temperature", [1.0, 0.3])
def test_twhin_loss_equals_jax(temperature):
    rng = np.random.default_rng(4)
    u = rng.normal(size=(20, D)).astype(np.float32)
    v = rng.normal(size=(20, D)).astype(np.float32)
    ids = rng.integers(0, 8, 20).astype(np.int32)
    want = jtw.twhin_loss(jnp.asarray(u), jnp.asarray(v), jnp.asarray(ids), temperature)
    got = twhin.twhin_loss(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(ids), temperature)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_loss_gradient_equals_jax():
    rng = np.random.default_rng(5)
    u = rng.normal(size=(16, D)).astype(np.float32)
    v = rng.normal(size=(16, D)).astype(np.float32)
    ids = rng.integers(0, 5, 16).astype(np.int32)
    want = jax.grad(lambda a, b: jtt.in_batch_softmax_loss(a, b, 0.05, jnp.asarray(ids)), argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(v))
    tu, tv = torch.from_numpy(u).requires_grad_(), torch.from_numpy(v).requires_grad_()
    two_tower.in_batch_softmax_loss(tu, tv, 0.05, torch.from_numpy(ids)).backward()
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(want[0]), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# -- the table gradient -------------------------------------------------------


@pytest.mark.parametrize("hidden", [(24,), ()])
def test_two_tower_gradients_equal_jax_grad(hidden):
    """Every parameter's gradient, tables included, of the in-batch loss
    over ids with repeats, negative ids and ids past the end."""
    cfg, model, params, port = _two_tower(hidden)
    users, items = jnp.asarray(USER_IDS), jnp.asarray(ITEM_IDS)

    def loss(p):
        u, v = model.apply(p, users, items)
        return jtt.in_batch_softmax_loss(u, v, cfg.temperature, items)

    want = _flat(jax.grad(loss)(params)["params"])
    u, v = port(torch.from_numpy(USER_IDS), torch.from_numpy(ITEM_IDS))
    two_tower.in_batch_softmax_loss(u, v, cfg.temperature, torch.from_numpy(ITEM_IDS)).backward()
    got = _port_grads(port)
    _assert_grads(got, want)
    # rows no id reads, and those whose only ids fell outside the table, get exactly 0
    untouched = np.setdiff1d(np.arange(N), np.where(ITEM_IDS < 0, ITEM_IDS + N, ITEM_IDS))
    assert not got["item_table"][untouched].any()


def test_twhin_gradients_equal_jax_grad():
    """User, item and relation tables' gradients of the TwHIN loss; the
    6-row relation table takes long runs of one id."""
    cfg, model, params, port = _twhin()
    rels = np.array([0, 1, 1, 5, 2, 6, -1, 3, 4, 1, 1, 0], np.int32)  # 6 past the end, -1 wrapped
    args = [jnp.asarray(a) for a in (USER_IDS, rels, ITEM_IDS)]

    def loss(p):
        u, v = model.apply(p, *args)
        return jtw.twhin_loss(u, v, args[2], cfg.temperature)

    want = _flat(jax.grad(loss)(params)["params"])
    u, v = port(*(torch.from_numpy(a) for a in (USER_IDS, rels, ITEM_IDS)))
    twhin.twhin_loss(u, v, torch.from_numpy(ITEM_IDS), cfg.temperature).backward()
    _assert_grads({k: p.grad.numpy() for k, p in port.named_parameters()}, want)


@pytest.mark.parametrize("shape", [(12,), (3, 4), (2, 3, 2)])
def test_table_read_gradient_equals_jax_for_any_id_shape(shape):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(-N - 4, N + 4, shape).astype(np.int32)
    w = rng.normal(size=shape + (D,)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(t[jnp.asarray(ids)] * w))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    rows = gather.table_read(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(jnp.asarray(table)[jnp.asarray(ids)]))
    (rows * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_table_read_of_a_frozen_table_records_nothing():
    table = torch.randn(N, D)
    rows = gather.table_read(table, torch.tensor([1, -1, N + 3]))
    assert not rows.requires_grad and rows.grad_fn is None
    assert torch.equal(rows, table[[1, N - 1, N - 1]])


def test_grad_ids_follow_jax_scatter_rules():
    ids = torch.tensor([0, 5, N - 1, N, -1, -N, -(N + 1), 3 * N], dtype=torch.int32)
    got = gather.grad_ids(ids, N).tolist()
    assert got == [0, 5, N - 1, PAD_ID, N - 1, 0, PAD_ID, PAD_ID]


# -- the D-wide collapse's plain version against the TPU kernel ----------------


def _sorted_case(rng, n, num_rows, kind):
    if kind == "distinct":
        ids = rng.permutation(num_rows)[:n]
    elif kind == "long runs":
        ids = rng.integers(0, 6, n)  # the relation table: runs of ~n/6
    else:
        ids = rng.integers(0, num_rows, n)
    ids = ids.astype(np.int32)
    ids[rng.random(n) < 0.1] = PAD_ID
    perm = np.argsort(ids, kind="stable")
    return ids[perm], perm


@pytest.mark.parametrize("kind", ["distinct", "long runs", "random"])
def test_run_collapse_rows_plain_equals_jax_pallas_interpret(kind):
    """The k = D collapse: JAX's Pallas run collapse over D value arrays
    (each column of the permuted rows), the run totals scattered to their
    rows, against the port's plain version reading dy through perm."""
    rng = np.random.default_rng(7)
    n, num_rows = 700, 1024
    ids, perm = _sorted_case(rng, n, num_rows, kind)
    dy = rng.normal(size=(n, D)).astype(np.float32)
    cols = [jnp.asarray(dy[perm, j][None]) for j in range(D)]
    rep, *sums = jseg.run_collapse_sorted(jnp.asarray(ids[None]), *cols, interpret=True)
    rep, sums = np.asarray(rep[0]), np.stack([np.asarray(s[0]) for s in sums], axis=1)
    want = np.zeros((num_rows, D), np.float32)
    keep = rep != PAD_ID
    want[rep[keep]] = sums[keep]
    got = seg_scan.run_collapse_rows_plain(torch.from_numpy(ids), torch.from_numpy(perm), torch.from_numpy(dy),
                                           num_rows)
    assert got.shape == (num_rows, D) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_run_collapse_rows_on_the_cpu_is_the_plain_version_and_deterministic():
    rng = np.random.default_rng(8)
    ids, perm = _sorted_case(rng, 500, 40, "random")
    dy = torch.from_numpy(rng.normal(size=(500, 12)).astype(np.float32))
    args = (torch.from_numpy(ids), torch.from_numpy(perm), dy, 40)
    before = seg_scan.run_collapse_rows.launches
    a, b = seg_scan.run_collapse_rows(*args), seg_scan.run_collapse_rows(*args)
    assert torch.equal(a, b) and torch.equal(a, seg_scan.run_collapse_rows_plain(*args))
    assert seg_scan.run_collapse_rows.launches == before  # the plain version counts no launch
    np.testing.assert_allclose(a.numpy(), torch.zeros(41, 12).index_put_(
        (torch.where(torch.from_numpy(ids) == PAD_ID, 40, torch.from_numpy(ids)).long(),), dy[torch.from_numpy(perm)],
        accumulate=True)[:40].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", ["ids dtype", "perm dtype", "perm length", "dy rank", "rows"])
def test_run_collapse_rows_rejects_bad_inputs(bad):
    ids = torch.zeros(4, dtype=torch.int32)
    perm = torch.arange(4)
    dy = torch.zeros(4, 3)
    rows = 5
    if bad == "ids dtype":
        ids = ids.long()
    elif bad == "perm dtype":
        perm = perm.int()
    elif bad == "perm length":
        perm = perm[:3]
    elif bad == "dy rank":
        dy = dy.reshape(-1)
    else:
        rows = 0
    with pytest.raises(ValueError):
        seg_scan.run_collapse_rows(ids, perm, dy, rows)


# -- the Trainer and the planted preferences ------------------------------------


def _trainer_batches(seed=0, steps=6, B=16):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        users = rng.integers(-40, 40, B).astype(np.int32)  # past both ends of the 32 rows
        users[5] = PAD_ID
        items = (users % 32).astype(np.int32)
        items[[2, 9]] = (32, -33)
        yield {"users": users, "items": items}


ADAM_ATOL, ADAM_SHARE = 1e-5, 1e-3  # the Adam rule (PERF.md §2)


def test_trainer_steps_follow_the_jax_trainer(mesh8):
    """tests/test_models_training.py::TestTrainer's two-tower model and loss
    through both Trainers (JAX's on the conftest mesh, tables sharded over
    'model'): adam 1e-2, params after every step, with ids past both ends
    and PAD_ID: JAX's partitioned step keeps ``jax.grad``'s index rule
    (tests/test_torch_mesh_training.py's fault-5 tests), so the port's one
    device follows it under the Adam rule: no entry off by more than
    2·steps·lr, at most 0.1% off by more than 1e-5 (Adam's first step is
    ±lr·sign(g): an entry whose gradient cancels to f32 noise may take the
    other sign)."""
    cfg, model, params, port = _two_tower(hidden=(8,), users=32, items=32, dim=8)

    def jax_loss(p, batch):
        u, v = model.apply(p, batch["users"], batch["items"])
        return jtt.in_batch_softmax_loss(u, v, 0.1, batch["items"]), {}

    def port_loss(m, batch):
        u, v = m(batch["users"], batch["items"])
        return two_tower.in_batch_softmax_loss(u, v, 0.1, batch["items"]), {}

    jt = JaxTrainer(jax_loss, params, mesh8, [(r"(user|item)_table", P("model", None)), (r".*", P())],
                    JaxTrainerConfig(learning_rate=1e-2))
    pt = Trainer(port_loss, port, TrainerConfig(learning_rate=1e-2), device="cpu")
    for step, batch in enumerate(_trainer_batches(), 1):
        want = jt.train_step(batch)
        got = pt.train_step(batch)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=RTOL)
        got_p = _flat(two_tower.params_to_flax(pt.model.state_dict())["params"])
        want_p = _flat(jax.tree_util.tree_map(np.asarray, jt.params)["params"])
        diffs = np.concatenate([np.abs(got_p[k] - want_p[k]).reshape(-1) for k in want_p])
        assert diffs.max() <= 2 * step * 1e-2, diffs.max()
        assert (diffs > ADAM_ATOL).mean() <= ADAM_SHARE, (diffs > ADAM_ATOL).sum()
    assert all(p.requires_grad for p in pt.model.parameters())  # no table is frozen


def test_two_tower_learns_planted_preference():
    """tests/test_models_training.py::TestTwoTower on the port: user u likes
    item 2u, 200 adam(5e-2) steps of the in-batch loss; hits@5 > 0.9."""
    torch.manual_seed(0)
    cfg = two_tower.TwoTowerConfig(num_users=64, num_items=128, embed_dim=16, tower_hidden=(16,))
    model = two_tower.TwoTower(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    users = torch.arange(64, dtype=torch.int32)
    items = users * 2
    opt = torch.optim.Adam(model.parameters(), 5e-2)
    for _ in range(200):
        opt.zero_grad()
        u, v = model(users, items)
        two_tower.in_batch_softmax_loss(u, v, cfg.temperature, items).backward()
        opt.step()
    with torch.no_grad():
        u = model.user_embeddings(users)
        all_items = model.item_embeddings(torch.arange(128, dtype=torch.int32))
        top, _ = two_tower.retrieve_top_k(u, all_items, 5)
    hits = (top == items[:, None]).any(dim=1).float().mean()
    assert hits > 0.9, hits


def test_twhin_learns_relation_specific_preferences():
    """tests/test_twhin.py's planted relations on the port: user u follows
    item u and favorites item u + 16; 300 adam(5e-2) steps; per-relation
    top-1 accuracy > 0.8."""
    Us, Is = 16, 32
    model = twhin.Twhin(twhin.TwhinConfig(num_users=Us, num_items=Is, embed_dim=16), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    users = torch.arange(Us, dtype=torch.int32).repeat(2)
    rels = torch.cat([torch.zeros(Us, dtype=torch.int32), torch.ones(Us, dtype=torch.int32)])
    items = torch.cat([torch.arange(Us), torch.arange(Us) + Us]).to(torch.int32)
    opt = torch.optim.Adam(model.parameters(), 5e-2)
    for _ in range(300):
        opt.zero_grad()
        u, v = model(users, rels, items)
        twhin.twhin_loss(u, v, items, model.config.temperature).backward()
        opt.step()
    table = twhin.entity_embeddings(model)
    with torch.no_grad():
        for r, offset in ((0, 0), (1, Us)):
            q = model.translate(torch.arange(Us), torch.full((Us,), r))
            acc = ((q @ table.T).argmax(dim=1) == torch.arange(Us) + offset).float().mean()
            assert acc > 0.8, (r, acc)


def test_optax_adam_through_the_trainer_moves_untouched_rows_as_jax():
    """A row read once keeps moving on later steps whose gradient for it is
    0 (adam's moments): the dense table gradient gives JAX's update, where
    a sparse one would leave the row still."""
    table = np.random.default_rng(9).normal(size=(6, 4)).astype(np.float32)
    tx = optax.adam(1e-2)
    jp = jnp.asarray(table)
    state = tx.init(jp)
    pt = torch.nn.Module()
    pt.table = torch.nn.Parameter(torch.from_numpy(table.copy()))
    trainer = Trainer(lambda m, ids: (gather.table_read(m.table, ids).sum(), {}), pt,
                      TrainerConfig(learning_rate=1e-2), device="cpu")
    for ids in ([1, 1, 2], [3], [3, 4]):
        ids = np.asarray(ids, np.int32)
        g = jax.grad(lambda t: jnp.sum(t[jnp.asarray(ids)]))(jp)
        up, state = tx.update(g, state)
        jp = optax.apply_updates(jp, up)
        trainer.train_step(ids)
    np.testing.assert_allclose(pt.table.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    assert not np.allclose(np.asarray(jp)[1], table[1] - 1e-2)  # row 1 moved on after its last read


# -- the world's planted engagements, served back through Home ------------------


def _small_shape():
    from the_algorithm_tpu_torch.data import foryou_world, sann_world, tweet_mixer_world as tmw

    return tmw, tmw.TweetMixerShape(
        sann=sann_world.WorldShape(n_comm=8, cpc=64, M=40, N=10, X=50, T=8192, KT=8, Q=32),
        foryou=foryou_world.ForYouShape(num_users=512, num_authors=128, eb_docs=4096, tweet_space=4096, follows=12,
                                        follow_width=16, utg_width=32, utg_sources=16),
        embed_dim=16, tower_hidden=(16,), users=3)


def test_planted_engagements_and_their_batches():
    tmw, shape = _small_shape()
    p = tmw.planted_engagements(shape)
    assert p.two_tower.shape == (512,) and p.twhin.shape == (len(twhin.RELATIONS), 512)
    assert len(set(p.twhin.ravel().tolist())) == p.twhin.size  # every (user, relation) its own item
    assert len(set(p.two_tower.tolist())) == 512 and p.two_tower.max() < shape.num_items
    assert np.array_equal(tmw.planted_engagements(shape).twhin, p.twhin)  # seeded
    tt = tmw.two_tower_batches(p, 128)
    epoch = [next(tt) for _ in range(4)]
    assert sorted(np.concatenate([b["users"] for b in epoch]).tolist()) == list(range(512))  # each user once an epoch
    assert all(np.array_equal(b["items"], p.two_tower[b["users"]]) for b in epoch)
    b = next(tmw.twhin_batches(p, 256))
    assert np.array_equal(b["items"], p.twhin[b["relations"], b["users"]])
    with pytest.raises(ValueError):
        next(tmw.two_tower_batches(p, 513))
    with pytest.raises(ValueError):  # 6 x 512 distinct planted items need more than 3,000 items
        tmw.planted_engagements(dataclasses.replace(shape, sann=dataclasses.replace(shape.sann, T=3000)))


def test_hits_at_k_counts_items_scored_above_the_planted_one():
    tmw, _ = _small_shape()
    items = torch.eye(4)
    q = torch.tensor([[1.0, 0.5, 0, 0], [0, 0, 0.2, 0.9]])
    assert tmw.hits_at_k(q, items, torch.tensor([0, 2]), 1) == 0.5  # the second user's item ranks 2nd
    assert tmw.hits_at_k(q, items, torch.tensor([0, 2]), 2) == 1.0


def test_trained_tables_serve_the_planted_items_through_home():
    """Both models trained through the Trainer on the small world's planted
    engagements, then served: a served user's planted items in the dense
    pipelines' lists, the served models frozen, the two-tower item table the
    trained item tower's export."""
    from the_algorithm_tpu_torch.core.config import Params
    from the_algorithm_tpu_torch.mixers import candidate_pipeline_catalog as cat
    from the_algorithm_tpu_torch.mixers import tweet_mixer_products as tmp

    tmw, shape = _small_shape()
    world = tmw.build(shape, device="cpu")
    p = tmw.planted_engagements(shape)
    gen = torch.Generator().manual_seed(0)
    tt = two_tower.TwoTower(two_tower.TwoTowerConfig(shape.num_users, shape.num_items, 16, (16,)), device="cpu",
                            generator=gen)
    th = twhin.Twhin(twhin.TwhinConfig(shape.num_users, shape.num_items, 16), device="cpu", generator=gen)
    for model, loss, batches in ((tt, tmw.two_tower_train_loss, tmw.two_tower_batches(p, 128)),
                                 (th, tmw.twhin_train_loss, tmw.twhin_batches(p, 256))):
        tr = Trainer(loss, model, TrainerConfig(learning_rate=1e-2), device="cpu")
        first = float(tr.train_step(next(batches))["loss"])
        last = tr.fit(batches, num_steps=150, prefetch=0)["loss"]
        assert last < first
    users = np.arange(0, 512, 4)
    assert tmw.two_tower_hits(tt, p, users, 10) > 0.9
    assert min(tmw.twhin_hits(th, p, users, 10)) > 0.9
    served = world.with_models(th, tt)
    assert not any(q.requires_grad for m in (served.twhin, served.two_tower) for q in m.parameters())
    torch.testing.assert_close(served.two_tower_items, tmw.export_item_table(tt))
    q = served.queries[0]
    u = int(q.user_id)
    catalog = cat.build_catalog(served.source_world())
    home = tmp.TweetMixerProduct.HOME_RECOMMENDED_TWEETS
    lists = {spec.name: [c.id for c in pipe.source.get(q, Params())] for spec, pipe in catalog
             if pipe in tmp.product_pipelines(catalog, home, q, Params())}
    assert int(p.two_tower[u]) in lists["two_tower_consumer"][:10]
    assert int(p.two_tower[u]) in lists["deep_retrieval_user_tweet"][:10]
    assert int(p.twhin[tmw.TWHIN_RELATION, u]) in lists["twhin_consumer_based"][:10]
