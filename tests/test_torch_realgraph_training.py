"""RealGraph's p(interaction) edge model in the port
(the_algorithm_tpu_torch/graph/realgraph.py: ``init_model``, ``loss_fn``,
``top_edges``) against the JAX package's, on edge tables folded from the
same seeded interaction stream by each package's own ``apply_interactions``.

Tolerances: the loss rtol 1e-6 and its gradient rtol 1e-5, atol 1e-7 (f32
sums over the batch in another order); params after 100 adam steps atol
1e-5 (optax's adam in both; f32 gradient noise through m/√v); top-K ids
exactly, ties in ``lax.top_k``'s order, scores rtol 1e-6, atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_util  # noqa: F401  (pins torch to one thread)

from the_algorithm_tpu.graph import realgraph as jrg
from the_algorithm_tpu_torch.graph import realgraph as rg
from the_algorithm_tpu_torch.ops import gather
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.training import metrics, optimizers

F = len(rg.INTERACTION_TYPES)
U, DEG = 12, 6


def _stream(seed=0, n=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, U - 2, n).astype(np.int32)  # the last two users have no edges
    dst = rng.integers(0, 40, n).astype(np.int32)
    it = rng.integers(0, F, n).astype(np.int32)
    ts = np.sort(rng.integers(0, 30 * 86400, n)).astype(np.int32)
    return src, dst, it, ts


def _tables(seed=0):
    src, dst, it, ts = _stream(seed)
    jt = jrg.apply_interactions(jrg.init_table(U, DEG), *(jnp.asarray(a) for a in (src, dst, it, ts)))
    t = rg.apply_interactions(rg.init_table(U, DEG, device="cpu"), src, dst, it, ts)
    return jt, t


def _params(seed=0):
    jp = jrg.init_model(jax.random.PRNGKey(seed))
    return jp, rg.params_from_jax(jp, device="cpu")


def test_init_model_and_carry_over():
    p = rg.init_model(torch.Generator().manual_seed(0), device="cpu")
    assert p["w"].shape == (F,) and p["b"].shape == () and all(v.requires_grad for v in p.values())
    assert float(p["w"].detach().abs().max()) < 0.05 and float(p["b"].detach()) == 0.0
    jp, port = _params()
    for k, v in rg.params_to_jax(port).items():
        np.testing.assert_array_equal(v, np.asarray(jp[k]))


def _features(seed=0, n=512):
    rng = np.random.default_rng(seed)
    feats = rng.exponential(2.0, size=(n, F)).astype(np.float32)
    return feats, (feats[:, 0] > 2.0).astype(np.float32)


def test_loss_and_gradient_equal_jax():
    feats, labels = _features()
    jp, p = _params(1)
    want, jg = jax.value_and_grad(jrg.loss_fn)(jp, jnp.asarray(feats), jnp.asarray(labels))
    got = rg.loss_fn(p, torch.from_numpy(feats), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    got.backward()
    for k in ("w", "b"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rg.predict_edge_scores(p, torch.from_numpy(feats)).detach().numpy(),
                               np.asarray(jrg.predict_edge_scores(jp, jnp.asarray(feats))), rtol=1e-6, atol=1e-7)


def test_model_learns_edge_strength_as_jax():
    """tests/test_graph.py's training case on both packages: 100 steps of
    adam(0.1) from JAX's init, params alike, AUC > 0.95."""
    feats, labels = _features()
    jp, p = _params()
    tx = optax.adam(0.1)
    opt_state = tx.init(jp)
    opt = optimizers.Adam(list(p.values()), 0.1)

    @jax.jit
    def step(params, opt_state):
        g = jax.grad(jrg.loss_fn)(params, jnp.asarray(feats), jnp.asarray(labels))
        up, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, up), opt_state

    x, y = torch.from_numpy(feats), torch.from_numpy(labels)
    for _ in range(100):
        jp, opt_state = step(jp, opt_state)
        opt.zero_grad()
        rg.loss_fn(p, x, y).backward()
        opt.step()
    for k in ("w", "b"):
        np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5)
    with torch.no_grad():
        assert float(metrics.auc(rg.predict_edge_scores(p, x), y)) > 0.95


@pytest.mark.parametrize("k", [1, 3, DEG])
def test_top_edges_equal_jax(k):
    """Every user, one at a time as JAX takes them and as one batch: ids
    exactly (a user with no edges gets PAD_ID / 0 everywhere), scores at
    rtol 1e-6; out-of-range ids read JAX's clamped or wrapped row."""
    jt, t = _tables()
    jp, p = _params(2)
    now = 31 * 86400
    users = np.array(list(range(U)) + [-1, -U, U, U + 5, -(U + 3)], np.int32)
    want = [jrg.top_edges(jt, jp, jnp.int32(u), jnp.int32(now), k) for u in users]
    want_ids = np.stack([np.asarray(w[0]) for w in want])
    want_s = np.stack([np.asarray(w[1]) for w in want])
    before = gather.row_gather.launches
    with torch.no_grad():
        ids, scores = rg.top_edges(t, p, torch.from_numpy(users), now, k)
        one = [rg.top_edges(t, p, int(u), now, k) for u in users[:3]]
    assert gather.row_gather.launches == before  # the CPU takes the plain version
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want_s, rtol=1e-6, atol=1e-7)
    for (i, s), wi, ws in zip(one, want_ids, want_s):
        assert i.shape == (k,)
        np.testing.assert_array_equal(i.numpy(), wi)
        np.testing.assert_allclose(s.numpy(), ws, rtol=1e-6, atol=1e-7)
    assert (ids[U - 1] == PAD_ID).all() and (scores[U - 1] == 0).all()


def test_top_edges_ranks_ties_as_lax_top_k():
    """tests/test_graph.py's case (3 favs beat 1), plus equal-weight edges:
    lax.top_k keeps the lower slot first."""
    src = np.zeros(6, np.int32)
    dst = np.array([1, 1, 1, 2, 3, 4], np.int32)
    it = np.full(6, rg.INTERACTION_TYPES.index("fav"), np.int32)
    ts = np.zeros(6, np.int32)  # one time: edges 2, 3, 4 tie exactly
    jt = jrg.apply_interactions(jrg.init_table(2, 5), *(jnp.asarray(a) for a in (src, dst, it, ts)))
    t = rg.apply_interactions(rg.init_table(2, 5, device="cpu"), src, dst, it, ts)
    jp = {"w": jnp.ones(F), "b": jnp.zeros(())}
    p = rg.params_from_jax(jp, device="cpu")
    want = jrg.top_edges(jt, jp, jnp.int32(0), jnp.int32(4), 5)
    with torch.no_grad():
        got = rg.top_edges(t, p, 0, 4, 5)
    assert got[0].tolist() == np.asarray(want[0]).tolist() == [1, 2, 3, 4, PAD_ID]
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)


def test_top_edges_past_the_degree_raises_as_lax_top_k():
    _, t = _tables()
    with pytest.raises(ValueError):
        rg.top_edges(t, _params()[1], 0, 0, DEG + 1)
