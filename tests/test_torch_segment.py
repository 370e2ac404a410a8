"""``ops/segment.py`` and the rest of ``ops/sparse.py`` against the JAX
package's: ``row_dedup_sum``'s layout element by element at k = 1 to 5
value rows (each distinct id at its run's first slot), its sums held to a
float64 oracle with bounds that scale with what each side sums, the
deterministic ``scatter_sum`` against ``.at[].add``, and ``from_dense``,
``to_dense``, ``l2_normalize``, ``batched`` and ``pairwise_cosine_matrix``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.ops import segment as jseg
from the_algorithm_tpu.ops import sparse as jsp
from the_algorithm_tpu_torch.ops import seg_scan, segment, sparse

EPS = 2.0**-24


def _rows(seed, Q, W, n_ids):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_ids, (Q, W)).astype(np.int32)
    ids[rng.random((Q, W)) < 0.2] = PAD_ID
    return rng, ids


def _oracle(ids, vals):
    """Per row, in stable sorted order: each start slot's float64 run total,
    the float64 Σ|x| of its run and of the row's prefix up to the run's end."""
    order = np.argsort(ids, axis=-1, kind="stable")
    s_ids = np.take_along_axis(ids, order, -1)
    s = np.take_along_axis(vals.astype(np.float64), order, -1)
    total, run_abs, prefix_abs = (np.zeros_like(s) for _ in range(3))
    for q in range(ids.shape[0]):
        bounds = np.flatnonzero(np.r_[True, s_ids[q, 1:] != s_ids[q, :-1], True])
        cum = np.cumsum(np.abs(s[q]))
        for a, b in zip(bounds[:-1], bounds[1:]):
            if a == 0 and s_ids[q, 0] == -1:
                continue  # JAX's first slot is compared with -1: this run has no start
            total[q, a] = s[q, a:b].sum()
            run_abs[q, a] = np.abs(s[q, a:b]).sum()
            prefix_abs[q, a] = cum[b - 1]
    return total, run_abs, prefix_abs


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_row_dedup_sum_layout_matches_jax(k):
    rng, ids = _rows(k, 6, 200, 40)
    ids[0, :] = 7  # one run filling a row
    ids[1, :5] = -1  # JAX's sentinel: a run of -1 that sorts first has no start
    vals = [rng.normal(size=ids.shape).astype(np.float32) for _ in range(k)]
    got = segment.row_dedup_sum(torch.from_numpy(ids), *(torch.from_numpy(v) for v in vals))
    want = jseg.row_dedup_sum(jnp.asarray(ids), *(jnp.asarray(v) for v in vals))
    assert len(got) == len(want) == k + 1
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # ids at the same slots, PAD elsewhere
    W = ids.shape[1]
    for v, g, w in zip(vals, got[1:], want[1:]):
        total, run_abs, prefix_abs = _oracle(ids, v)
        g, w = g.numpy().astype(np.float64), np.asarray(w).astype(np.float64)
        assert np.all((g == 0) | (total != 0))  # zeros where JAX has none only at non-start slots
        # JAX: a difference of two f32 prefix sums, its error bounded by the prefix;
        # the port: one sum over the run
        assert np.all(np.abs(w - total) <= 2 * W * EPS * prefix_abs + 1e-30)
        assert np.all(np.abs(g - total) <= W * EPS * run_abs + 1e-30)
        np.testing.assert_array_equal(g == 0, (w == 0) | (total == 0))


def test_row_dedup_sum_over_leading_dims_and_one_row():
    rng, ids = _rows(9, 12, 64, 10)
    vals = rng.random(ids.shape).astype(np.float32)
    for shape in ((3, 4, 64), (768,)):
        i, v = ids.reshape(shape), vals.reshape(shape)
        got = segment.row_dedup_sum(torch.from_numpy(i), torch.from_numpy(v))
        want = jseg.row_dedup_sum(jnp.asarray(i), jnp.asarray(v))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def test_row_dedup_sum_one_launch_for_four_rows(monkeypatch):
    calls = []
    real = seg_scan.run_collapse_sorted_plain

    def spy(ids, *values):
        calls.append(len(values))
        return real(ids, *values)

    monkeypatch.setattr(segment, "run_collapse_sorted", spy)
    _, ids = _rows(3, 4, 32, 6)
    segment.row_dedup_sum(torch.from_numpy(ids), *(torch.ones(4, 32) for _ in range(4)))
    segment.row_dedup_sum(torch.from_numpy(ids), *(torch.ones(4, 32) for _ in range(6)))
    assert calls == [4, 4, 2]


def test_row_dedup_count_matches_jax():
    _, ids = _rows(5, 8, 50, 7)
    got = segment.row_dedup_count(torch.from_numpy(ids))
    want = jseg.row_dedup_count(jnp.asarray(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scatter_sum_matches_jax_at_add():
    rng = np.random.default_rng(2)
    keys = rng.integers(-3, 70, (40, 9)).astype(np.int32)  # out-of-range keys dropped
    v1, v2 = (rng.normal(size=keys.shape).astype(np.float32) for _ in range(2))
    got = segment.scatter_sum(torch.from_numpy(keys), torch.from_numpy(v1), torch.from_numpy(v2), size=64)
    for g, v in zip(got, (v1, v2)):
        inside = (keys >= 0) & (keys < 64)
        want64 = np.zeros(64)
        np.add.at(want64, keys[inside], v[inside].astype(np.float64))
        want = jnp.zeros(64, jnp.float32).at[jnp.asarray(np.where(inside, keys, 64))].add(jnp.asarray(v))
        np.testing.assert_allclose(g.numpy(), want64, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        segment.scatter_sum(torch.zeros(3, dtype=torch.int32), torch.ones(3), size=2**31)


def _emb(rng, n, K, C):
    ids = np.stack([rng.choice(C, K, replace=False) for _ in range(n)]).astype(np.int32)
    scores = np.sort(rng.random((n, K)).astype(np.float32), axis=1)[:, ::-1].copy()
    ids[:, -2:] = PAD_ID
    scores[:, -2:] = 0.0
    return ids, scores


def test_sparse_rest_matches_jax():
    rng = np.random.default_rng(7)
    dense = rng.normal(size=(5, 30)).astype(np.float32)
    dense[0, :5] = 2.0  # ties: lax.top_k's order, lower index first
    got = sparse.from_dense(torch.from_numpy(dense), 8)
    want = jax.vmap(lambda d: jsp.from_dense(d, 8))(jnp.asarray(dense))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    ids, scores = _emb(rng, 6, 10, 30)
    emb = sparse.SparseEmbedding(torch.from_numpy(ids), torch.from_numpy(scores))
    np.testing.assert_allclose(
        sparse.to_dense(emb, 30).numpy(),
        np.asarray(jax.vmap(lambda i, s: jsp.to_dense(jsp.SparseEmbedding(i, s), 30))(jnp.asarray(ids),
                                                                                      jnp.asarray(scores))), rtol=0)
    norm = sparse.l2_normalize(emb)
    jnorm = jsp.l2_normalize(jsp.SparseEmbedding(jnp.asarray(ids), jnp.asarray(scores)))
    np.testing.assert_allclose(norm.scores.numpy(), np.asarray(jnorm.scores), rtol=1e-6)
    zero = sparse.l2_normalize(sparse.SparseEmbedding(emb.ids, torch.zeros_like(emb.scores)))
    assert torch.equal(zero.scores, torch.zeros_like(emb.scores))
    ids_b, scores_b = _emb(rng, 4, 10, 30)
    b = sparse.SparseEmbedding(torch.from_numpy(ids_b), torch.from_numpy(scores_b))
    jb = jsp.SparseEmbedding(jnp.asarray(ids_b), jnp.asarray(scores_b))
    ja = jsp.SparseEmbedding(jnp.asarray(ids), jnp.asarray(scores))
    np.testing.assert_allclose(sparse.pairwise_cosine_matrix(emb, b).numpy(),
                               np.asarray(jsp.pairwise_cosine_matrix(ja, jb)), rtol=1e-5, atol=1e-6)
    one = sparse.SparseEmbedding(b.ids[0], b.scores[0])
    jone = jsp.SparseEmbedding(jb.ids[0], jb.scores[0])
    np.testing.assert_allclose(sparse.batched(sparse.cosine, in_axes=(0, None))(emb, one).numpy(),
                               np.asarray(jsp.batched(jsp.cosine, in_axes=(0, None))(ja, jone)), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        sparse.batched(sparse.cosine, in_axes=(1, 0))
