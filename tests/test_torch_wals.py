"""The port's WALS (the_algorithm_tpu_torch/models/wals.py) against the
JAX package's on the same ratings and the same starting item factors (the
JAX key's draw, handed to the port).

Tolerances: factors after 8-10 alternating half-steps rtol 1e-3, atol
1e-4 (batched f32 d×d solves by another LAPACK path, whose rounding the
iterations carry; the JAX test's own bound for a consumer solve against a
training user); one half-step rtol 1e-4, atol 1e-5; scores rtol 1e-5,
atol 1e-6; top-K ids exactly, ties in ``lax.top_k``'s order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (pins torch to one thread)

from the_algorithm_tpu.models import wals as jwals
from the_algorithm_tpu_torch.models import wals
from the_algorithm_tpu_torch.ops import gather


def _blocks(seed=0, U=32, T=40):
    """Two user communities engaging disjoint item sets (the JAX test's)."""
    rng = np.random.default_rng(seed)
    r = np.zeros((U, T), np.float32)
    h, t = U // 2, T // 2
    r[:h, :t] = rng.uniform(0.5, 1.0, (h, t)) * (rng.random((h, t)) < 0.4)
    r[h:, t:] = rng.uniform(0.5, 1.0, (U - h, T - t)) * (rng.random((U - h, T - t)) < 0.4)
    return r


def _jax_item_init(T, dim, key=None):
    """The item factors JAX's train_wals starts from for ``key``."""
    _, ki = jax.random.split(key if key is not None else jax.random.PRNGKey(0))
    return np.array(jax.random.normal(ki, (T, dim)) * 0.1)


@pytest.mark.parametrize("dim,iterations,seed", [(8, 8, 0), (6, 10, 1), (4, 3, 2)])
def test_train_wals_equals_jax(dim, iterations, seed):
    r = _blocks(seed) if seed != 1 else (np.random.default_rng(1).random((24, 30)) < 0.3).astype(np.float32)
    cfg = wals.WalsConfig(dim=dim, iterations=iterations)
    want = jwals.train_wals(jnp.asarray(r), jwals.WalsConfig(dim=dim, iterations=iterations))
    got = wals.train_wals(torch.from_numpy(r), cfg, item_init=torch.from_numpy(_jax_item_init(r.shape[1], dim)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_one_half_step_equals_jax():
    rng = np.random.default_rng(5)
    fixed = rng.normal(size=(50, 7)).astype(np.float32)
    r = (rng.random((33, 50)) < 0.2) * rng.uniform(0.5, 2.0, (33, 50))
    r = r.astype(np.float32)
    want = jwals._solve_side(jnp.asarray(fixed), jnp.asarray(r), 0.1, 10.0)
    old = wals.ROWS
    try:
        wals.ROWS = 7 * 50 * 4  # four rows a block: the chunked path
        got = wals._solve_side(torch.from_numpy(fixed), torch.from_numpy(r), 0.1, 10.0)
    finally:
        wals.ROWS = old
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_factorization_reconstructs_block_structure():
    """tests/test_cr_mixer_wals.py's block check on the port, from its own
    seeded start."""
    r = _blocks()
    model = wals.train_wals(torch.from_numpy(r), wals.WalsConfig(dim=8, iterations=8),
                            generator=torch.Generator().manual_seed(0))
    recon = (model.user_factors @ model.item_factors.T).numpy()
    in_block = np.concatenate([recon[:16, :20][r[:16, :20] > 0], recon[16:, 20:][r[16:, 20:] > 0]])
    out_block = np.concatenate([recon[:16, 20:].ravel(), recon[16:, :20].ravel()])
    assert in_block.mean() > 5 * abs(out_block.mean())


@pytest.mark.parametrize("full_gram", [True, False])
def test_consumer_embedding_equals_jax_and_the_training_user(full_gram):
    r = (np.random.default_rng(1).random((24, 30)) < 0.3).astype(np.float32)
    cfg = wals.WalsConfig(dim=6, iterations=10)
    model = wals.train_wals(torch.from_numpy(r), cfg, item_init=torch.from_numpy(_jax_item_init(30, 6)))
    items = model.item_factors
    u = 3
    hist = np.concatenate([np.flatnonzero(r[u]), [-1, -1]]).astype(np.int32)  # padded history
    weights = np.where(hist >= 0, 1.0, 0.0).astype(np.float32)
    gram = wals.item_gram(items) if full_gram else None
    before = gather.row_gather.launches
    vec = wals.consumer_embedding(items, torch.from_numpy(hist), torch.from_numpy(weights), cfg.reg, cfg.alpha, gram)
    assert gather.row_gather.launches == before  # the CPU takes the plain version
    want = jwals.consumer_embedding(jnp.asarray(items.numpy()), jnp.asarray(hist), jnp.asarray(weights), cfg.reg,
                                    cfg.alpha, None if gram is None else jnp.asarray(gram.numpy()))
    np.testing.assert_allclose(vec.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    if full_gram:  # the training half-step for that user
        np.testing.assert_allclose(vec.numpy(), model.user_factors[u].numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("k", [1, 5, 20])
@pytest.mark.parametrize("exclude", [None, [0, 1, 2, -1]])
def test_similar_items_equals_jax(k, exclude):
    rng = np.random.default_rng(2)
    f = rng.normal(size=(20, 4)).astype(np.float32)
    f[[9, 13]] = f[4]  # exact ties: lax.top_k ranks the lower row first
    v = f[4] * 2
    ex = None if exclude is None else np.asarray(exclude, np.int32)
    got_ids, got_s = wals.similar_items(torch.from_numpy(v), torch.from_numpy(f), k,
                                        None if ex is None else torch.from_numpy(ex))
    want_ids, want_s = jwals.similar_items(jnp.asarray(v), jnp.asarray(f), k, None if ex is None else jnp.asarray(ex))
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)
    if exclude is not None:
        assert not set(got_ids.tolist()[:17]) & {0, 1, 2}


def test_similar_items_past_the_items_raises_as_lax_top_k():
    f = torch.zeros(5, 3)
    with pytest.raises(ValueError):
        wals.similar_items(torch.ones(3), f, 6)


def test_model_carry_over_round_trips():
    r = _blocks()
    jm = jwals.train_wals(jnp.asarray(r), jwals.WalsConfig(dim=4, iterations=2))
    m = wals.model_from_jax(jm, device="cpu")
    assert isinstance(m, wals.WalsModel) and m.item_factors.dtype == torch.float32
    for a, b in zip(wals.model_to_jax(m), jm):
        np.testing.assert_array_equal(a, np.asarray(b))
