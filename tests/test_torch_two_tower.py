"""The port's dense retrieval models (the_algorithm_tpu_torch/models/{two_tower,twhin}.py)
against the JAX package's flax modules on the same parameters.

Each side gets the flax params the JAX ``init`` draws (the port through
``params_from_flax``); ids include out-of-range and negative ones, which a
JAX gather reads at the clamped / wrapped row. Embeddings and top-K scores
are f32 products summed in another order on each side: rtol 1e-5, atol 1e-6.
Top-K ids are compared exactly, in order, ties (duplicated item rows)
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (pins torch to one thread)

from the_algorithm_tpu.models import twhin as jtw
from the_algorithm_tpu.models import two_tower as jtt
from the_algorithm_tpu_torch.models import twhin, two_tower

RTOL, ATOL = 1e-5, 1e-6
U, N, D = 40, 300, 16
# in range, the last row, past the end (clamped), negative (wrapped), far negative (clamped to 0)
USER_IDS = np.array([0, 5, U - 1, U, U + 17, -1, -3, -(U + 9)], np.int32)
ITEM_IDS = np.array([1, 7, N - 1, N, 3 * N, -1, -N, -(N + 1)], np.int32)


def _jax_two_tower(hidden=(32,)):
    cfg = jtt.TwoTowerConfig(num_users=U, num_items=N, embed_dim=D, tower_hidden=hidden)
    model = jtt.TwoTower(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32))
    return cfg, model, params


def _port_two_tower(cfg, params):
    m = two_tower.TwoTower(two_tower.TwoTowerConfig(cfg.num_users, cfg.num_items, cfg.embed_dim, cfg.tower_hidden),
                           device="cpu")
    m.load_state_dict(two_tower.params_from_flax(params))
    return m.requires_grad_(False)


@pytest.mark.parametrize("hidden", [(32,), (), (24, 8)])
def test_two_tower_forward_equals_flax(hidden):
    cfg, model, params = _jax_two_tower(hidden)
    port = _port_two_tower(cfg, params)
    want_u, want_v = model.apply(params, jnp.asarray(USER_IDS), jnp.asarray(ITEM_IDS))
    got_u, got_v = port(torch.from_numpy(USER_IDS), torch.from_numpy(ITEM_IDS))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL, atol=ATOL)
    # the towers normalise: unit rows
    np.testing.assert_allclose(np.linalg.norm(got_u.numpy(), axis=1), 1.0, rtol=1e-5)


def test_item_embeddings_equal_the_flax_item_tower():
    """``item_embeddings`` (the export the engines scan) is the forward's
    item side; the JAX method of that name is not callable through
    ``apply`` (it builds its tower outside ``@compact``), so the reference
    is the JAX forward's v."""
    cfg, model, params = _jax_two_tower()
    port = _port_two_tower(cfg, params)
    ids = np.arange(-5, N + 5, dtype=np.int32)
    _, want = model.apply(params, jnp.zeros(ids.shape, jnp.int32), jnp.asarray(ids))
    got = port.item_embeddings(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_tower_zero_row_normalises_to_zero():
    """rsqrt(Σx² + 1e-12) keeps an exactly-zero tower output at zero, as the
    JAX tower does (``F.normalize`` would too, but not its gradient)."""
    cfg, model, params = _jax_two_tower()
    params = jax.tree_util.tree_map(lambda x: x, params)
    p = params["params"]
    p["user_tower"]["out"]["kernel"] = jnp.zeros_like(p["user_tower"]["out"]["kernel"])
    port = _port_two_tower(cfg, params)
    want_u, _ = model.apply(params, jnp.asarray(USER_IDS), jnp.asarray(ITEM_IDS))
    got_u, _ = port(torch.from_numpy(USER_IDS), torch.from_numpy(ITEM_IDS))
    assert not np.asarray(want_u).any() and not got_u.numpy().any()


def test_params_round_trip_is_identity():
    _, _, params = _jax_two_tower((24, 8))
    back = two_tower.params_to_flax(two_tower.params_from_flax(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in flat_a] == [jax.tree_util.keystr(k) for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_explicit_lookup_raises():
    """explicit_lookup reads through the row exchange under ``get_mesh()``:
    with no process group there is no mesh, and the forward raises
    (tests/test_torch_mesh_training.py runs it on gloo ranks)."""
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="init_process_group"):
        two_tower.TwoTower(two_tower.TwoTowerConfig(U, N, explicit_lookup=True), device="cpu")(ids, ids)
    with pytest.raises(RuntimeError, match="init_process_group"):
        twhin.Twhin(twhin.TwhinConfig(U, N, explicit_lookup=True), device="cpu")(ids, ids, ids)


def _items_with_ties(seed=3):
    rng = np.random.default_rng(seed)
    items = rng.normal(0, 1, (N, D)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    items[[40, 90, 250]] = items[7]  # exact ties with row 7: lax.top_k ranks the lower row first
    return items


@pytest.mark.parametrize("k", [1, 50, 200, N])
def test_retrieve_top_k_equals_jax(k):
    items = _items_with_ties()
    rng = np.random.default_rng(4)
    query = np.concatenate([items[[7]], rng.normal(0, 1, (3, D)).astype(np.float32)])
    want_ids, want_scores = jtt.retrieve_top_k(jnp.asarray(query), jnp.asarray(items), k)
    got_ids, got_scores = two_tower.retrieve_top_k(torch.from_numpy(query), torch.from_numpy(items), k)
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=RTOL, atol=ATOL)
    if k >= 4:
        assert got_ids[0, :4].tolist() == [7, 40, 90, 250]


def test_retrieve_top_k_past_the_items_raises_as_lax_top_k_does():
    items = _items_with_ties()
    with pytest.raises(ValueError):
        jtt.retrieve_top_k(jnp.asarray(items[:2]), jnp.asarray(items), N + 1)
    with pytest.raises(ValueError):
        two_tower.retrieve_top_k(torch.from_numpy(items[:2]), torch.from_numpy(items), N + 1)


def _twhin_pair():
    cfg = jtw.TwhinConfig(num_users=U, num_items=N, embed_dim=D)
    model = jtw.Twhin(cfg)
    z = jnp.zeros((2,), jnp.int32)
    params = model.init(jax.random.PRNGKey(1), z, z, z)
    port = twhin.Twhin(twhin.TwhinConfig(U, N, D), device="cpu")
    port.load_state_dict(twhin.params_from_flax(params))
    return model, params, port.requires_grad_(False)


def test_twhin_forward_equals_flax():
    model, params, port = _twhin_pair()
    rels = np.array([0, 1, 5, 2, 6, -1, 3, 4], np.int32)  # 6 and -1: past the end and wrapped
    want_u, want_v = model.apply(params, jnp.asarray(USER_IDS), jnp.asarray(rels), jnp.asarray(ITEM_IDS))
    got_u, got_v = port(torch.from_numpy(USER_IDS), torch.from_numpy(rels), torch.from_numpy(ITEM_IDS))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))  # a row read: exact
    assert twhin.RELATIONS == jtw.RELATIONS


@pytest.mark.parametrize("table", ["item_table", "user_table", "relation_table"])
def test_twhin_entity_embeddings_export_the_table(table):
    _, params, port = _twhin_pair()
    np.testing.assert_array_equal(twhin.entity_embeddings(port, table).numpy(),
                                  np.asarray(jtw.entity_embeddings(params, table)))


def test_twhin_translate_is_the_forwards_user_side():
    model, params, port = _twhin_pair()
    rels = np.full(USER_IDS.shape, jtw.RELATIONS.index("favorites"), np.int32)
    want_u, _ = model.apply(params, jnp.asarray(USER_IDS), jnp.asarray(rels), jnp.asarray(ITEM_IDS))
    got = port.translate(torch.from_numpy(USER_IDS), torch.from_numpy(rels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_u), rtol=RTOL, atol=ATOL)


def test_two_tower_backward_reaches_the_towers_and_leaves_the_tables_frozen():
    """Tables are trainable by default; a model whose tables are frozen
    (as a serving copy is) gets a backward that fills every tower parameter
    and leaves the tables without a gradient, and an optimizer over the
    parameters that need one holds no table."""
    cfg, _, params = _jax_two_tower()
    port = two_tower.TwoTower(two_tower.TwoTowerConfig(cfg.num_users, cfg.num_items, cfg.embed_dim,
                                                       cfg.tower_hidden), device="cpu")
    assert all(p.requires_grad for p in port.parameters())
    port.load_state_dict(two_tower.params_from_flax(params))
    port.user_table.requires_grad_(False)
    port.item_table.requires_grad_(False)
    u, v = port(torch.from_numpy(USER_IDS), torch.from_numpy(ITEM_IDS))
    (u * v).sum().backward()
    for name, p in port.named_parameters():
        if name.endswith("_table"):
            assert not p.requires_grad and p.grad is None, name
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert {n for n, p in port.named_parameters() if p.requires_grad} == {
        n for n, _ in port.named_parameters() if not n.endswith("_table")}


@pytest.mark.parametrize("model", ["two_tower", "twhin"])
def test_a_table_read_that_asks_for_a_gradient_raises(model):
    """A table read that asks for a gradient no longer raises: it gets
    ``jax.grad``'s table gradient (ids past the end and far negative ones
    get none); under ``no_grad`` it reads and records nothing."""
    ids = [jnp.asarray(USER_IDS), jnp.asarray(ITEM_IDS)]
    if model == "two_tower":
        cfg, jmodel, params = _jax_two_tower()
        port = _port_two_tower(cfg, params).requires_grad_(True)
        run = lambda: port(torch.from_numpy(USER_IDS), torch.from_numpy(ITEM_IDS))  # noqa: E731
    else:
        jmodel, params, port = _twhin_pair()
        port.requires_grad_(True)
        rels = np.zeros(USER_IDS.shape, np.int32)
        ids.insert(1, jnp.asarray(rels))
        run = lambda: port(torch.from_numpy(USER_IDS), torch.from_numpy(rels), torch.from_numpy(ITEM_IDS))  # noqa: E731
    w = np.random.default_rng(2).normal(size=(2, len(USER_IDS), D)).astype(np.float32)  # the towers' rows are unit
    want = jax.grad(lambda p: sum(jnp.sum(x * w[i]) for i, x in enumerate(jmodel.apply(p, *ids))))(params)["params"]
    sum((x * torch.from_numpy(w[i])).sum() for i, x in enumerate(run())).backward()
    for name in ("user_table", "item_table"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(), np.asarray(want[name]), rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        out = run()
    assert all(torch.isfinite(t).all() and t.grad_fn is None for t in out)
