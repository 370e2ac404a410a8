"""The port's calibration ops (the_algorithm_tpu_torch/ops/calibration.py)
against the JAX package's on the same samples.

The fits are the same numpy code on both sides: equal exactly. The
applies: ``apply_isotonic`` against ``jnp.interp`` at rtol 1e-6, atol 1e-7
(the same f32 formula; XLA may fuse its multiply-add); ``mdl_transform``'s
bin ids exactly and its positions at the same tolerance; ``sparse_max_norm``
and ``stitch`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (pins torch to one thread)

from the_algorithm_tpu.ops import calibration as jcal
from the_algorithm_tpu_torch.ops import calibration as cal
from the_algorithm_tpu_torch.ops import gather

RTOL, ATOL = 1e-6, 1e-7


def _sample(seed, n=400, weighted=True, dup=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    if dup:
        x[::7] = np.round(x[::7], 1)  # duplicated scores pooled before PAV
    y = (rng.random(n) < 1 / (1 + np.exp(-2 * x))).astype(np.float64)
    w = rng.uniform(0.5, 2.0, n) if weighted else None
    return x, y, w


@pytest.mark.parametrize("seed,weighted,dup", [(0, False, False), (1, True, True), (2, True, False)])
def test_fit_isotonic_equals_jax(seed, weighted, dup):
    x, y, w = _sample(seed, weighted=weighted, dup=dup)
    got, want = cal.fit_isotonic(x, y, w), jcal.fit_isotonic(x, y, w)
    np.testing.assert_array_equal(got.xs, want.xs)
    np.testing.assert_array_equal(got.ys, want.ys)
    assert (np.diff(got.ys) >= 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_isotonic_equals_jnp_interp(seed):
    x, y, w = _sample(seed)
    fit = cal.fit_isotonic(x, y, w)
    rng = np.random.default_rng(seed + 10)
    v = np.concatenate([rng.uniform(x.min() - 1, x.max() + 1, 500), fit.xs[::5], [fit.xs[0], fit.xs[-1]]])
    v = v.astype(np.float32)[: len(v) // 7 * 7].reshape(-1, 7)  # any shape
    got = cal.apply_isotonic(fit, torch.from_numpy(v))
    want = jcal.apply_isotonic(jcal.IsotonicFit(fit.xs, fit.ys), jnp.asarray(v))
    assert got.shape == v.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_apply_isotonic_with_one_knot_is_constant_as_jax():
    fit = cal.IsotonicFit(np.array([0.5], np.float32), np.array([0.25], np.float32))
    v = np.array([-3.0, 0.5, 0.7, 9.0], np.float32)
    want = jcal.apply_isotonic(jcal.IsotonicFit(fit.xs, fit.ys), jnp.asarray(v))
    np.testing.assert_array_equal(cal.apply_isotonic(fit, torch.from_numpy(v)).numpy(), np.asarray(want))


def _mdl_sample(seed, F=6, n=3000):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, F - 1, n)  # feature F-1 gets no sample: an all-zero row
    vals = rng.exponential(1.0, n) * (rows + 1)
    return rows, vals


@pytest.mark.parametrize("num_bins", [2, 8, 33])
def test_fit_mdl_and_transform_equal_jax(num_bins):
    F = 6
    rows, vals = _mdl_sample(num_bins, F)
    got, want = cal.fit_mdl(rows, vals, F, num_bins), jcal.fit_mdl(rows, vals, F, num_bins)
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    rng = np.random.default_rng(7)
    q_rows = np.concatenate([rng.integers(0, F, 200), [-1, -F, F, F + 3, -(F + 2)]]).astype(np.int32)
    q_vals = np.concatenate([rng.exponential(2.0, 200) - 0.5, got.boundaries.reshape(-1)[:5]]).astype(np.float32)
    before = gather.row_gather.launches
    idx, interp = cal.mdl_transform(got, torch.from_numpy(q_rows), torch.from_numpy(q_vals))
    assert gather.row_gather.launches == before  # the CPU takes the plain version
    j_idx, j_interp = jcal.mdl_transform(want, jnp.asarray(q_rows), jnp.asarray(q_vals))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(interp.numpy(), np.asarray(j_interp), rtol=RTOL, atol=ATOL)
    # boundaries given as a bare [F, B] array or tensor read the same
    for bins in (got.boundaries, torch.from_numpy(got.boundaries)):
        i2, p2 = cal.mdl_transform(bins, torch.from_numpy(q_rows), torch.from_numpy(q_vals))
        assert torch.equal(i2, idx) and torch.equal(p2, interp)


@pytest.mark.parametrize("is_training", [True, False])
def test_sparse_max_norm_equals_jax(is_training):
    rng = np.random.default_rng(3)
    running = np.abs(rng.normal(size=5)).astype(np.float32)
    running[2] = 0.0  # below epsilon
    values = (rng.normal(size=(8, 5)) * 3).astype(np.float32)
    got = cal.sparse_max_norm(torch.from_numpy(values), torch.from_numpy(running), is_training=is_training)
    want = jcal.sparse_max_norm(jnp.asarray(values), jnp.asarray(running), is_training=is_training)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stitch_equals_jax():
    rng = np.random.default_rng(4)
    order = rng.permutation(10)
    parts = [order[:3], order[3:7], order[7:]]
    values = [rng.normal(size=(len(p), 2, 3)).astype(np.float32) for p in parts]
    got = cal.stitch(tuple(torch.from_numpy(v) for v in values), tuple(torch.from_numpy(p) for p in parts))
    want = jcal.stitch(tuple(jnp.asarray(v) for v in values), tuple(jnp.asarray(p) for p in parts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
