"""Calibration ops: isotonic regression + MDL discretizer.

Counterpart of ``the_algorithm_tpu/ops/calibration.py`` ≡ twml's calibrator
suite (``twml/twml/contrib/calibrators/common_calibrators.py:199-689``) and
the libtwml kernels behind it (``isotonic_calibration.cpp``,
``discretizer.cpp``). *Fitting* is a host pass over a calibration sample:
:func:`fit_isotonic` and :func:`fit_mdl` are the JAX package's numpy code,
copied (its module imports JAX). *Applying* is tensor code on the
calibrated values' device: :func:`apply_isotonic` is ``jnp.interp`` (linear
between knots, clamped at the ends), :func:`mdl_transform` reads each
value's bin-boundary row through ``row_gather`` (JAX's index rule via
``jax_rows``), :func:`sparse_max_norm` and :func:`stitch` are elementwise
and an indexed copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather


class IsotonicFit(NamedTuple):
    """Piecewise-constant isotonic knots (xs ascending, ys non-decreasing)."""

    xs: np.ndarray  # [K] knot inputs
    ys: np.ndarray  # [K] calibrated outputs


def fit_isotonic(
    x: np.ndarray,
    y: np.ndarray,
    sample_weight: Optional[np.ndarray] = None,
) -> IsotonicFit:
    """Pool-adjacent-violators: weighted least-squares monotone fit (the
    isotonic calibration fit phase): maps raw model scores to calibrated
    probabilities, non-decreasing in the score."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    w = (
        np.ones_like(x)
        if sample_weight is None
        else np.asarray(sample_weight, np.float64)
    )
    order = np.argsort(x, kind="stable")
    x, y, w = x[order], y[order], w[order]

    # merge duplicate xs first (PAV needs strictly grouped support points)
    ux, inv = np.unique(x, return_inverse=True)
    uw = np.bincount(inv, weights=w)
    uy = np.bincount(inv, weights=w * y) / np.maximum(uw, 1e-30)

    # PAV with explicit pools
    means = list(uy)
    weights = list(uw)
    counts = [1] * len(uy)
    i = 0
    while i < len(means) - 1:
        if means[i] <= means[i + 1] + 1e-15:
            i += 1
            continue
        total_w = weights[i] + weights[i + 1]
        means[i] = (means[i] * weights[i] + means[i + 1] * weights[i + 1]) / total_w
        weights[i] = total_w
        counts[i] += counts[i + 1]
        del means[i + 1], weights[i + 1], counts[i + 1]
        if i > 0:
            i -= 1
    # expand pools back to knots
    ys = np.repeat(np.asarray(means), np.asarray(counts, int))
    return IsotonicFit(ux.astype(np.float32), ys.astype(np.float32))


def apply_isotonic(fit: IsotonicFit, values: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolated lookup with ``jnp.interp``'s arithmetic
    (≡ libtwml ``internal/interpolate.h``): the knot pair around each value
    by a right-sided search, ``fp[i-1] + (x - xp[i-1]) / dx · df``, and the
    end knots' outputs outside the knots' range."""
    values = torch.as_tensor(values)
    x = values.float()
    xp = torch.as_tensor(np.asarray(fit.xs, np.float32), device=x.device)
    fp = torch.as_tensor(np.asarray(fit.ys, np.float32), device=x.device)
    K = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, max(K - 1, 1)) if K > 1 else \
        torch.zeros_like(x, dtype=torch.int64)
    lo = (i - 1).clamp(min=0)
    df = fp[i] - fp[lo]
    dx = xp[i] - xp[lo]
    delta = x - xp[lo]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, fp[lo], fp[lo] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class MDLBins(NamedTuple):
    """Per-feature bin boundaries [F, B] (equal-mass on the fit sample)."""

    boundaries: np.ndarray  # [F, B] float32, ascending per row


def fit_mdl(
    feature_rows: np.ndarray,  # [N] int feature index per sample value
    values: np.ndarray,  # [N] float
    num_features: int,
    num_bins: int,
) -> MDLBins:
    """Equal-mass ("maximum description length") bin boundaries per
    feature (the MDL calibrate phase): the 0 … 1 quantiles of each
    feature's sample; a feature with no sample gets an all-zero row."""
    feature_rows = np.asarray(feature_rows)
    values = np.asarray(values, np.float64)
    out = np.zeros((num_features, num_bins), np.float32)
    qs = np.linspace(0.0, 1.0, num_bins)
    for f in range(num_features):
        v = values[feature_rows == f]
        if v.size == 0:
            continue
        out[f] = np.quantile(v, qs).astype(np.float32)
    return MDLBins(out)


def mdl_transform(
    bins: Union[MDLBins, torch.Tensor, np.ndarray],
    feature_rows: torch.Tensor,  # [N] int
    values: torch.Tensor,  # [N] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (bin_idx [N] int32, interpolated [N] float32): the discrete bin id
    and the continuous position in [0, B-1] (bin index + within-bin
    fraction). Each value's boundary row is read at JAX's row of its
    feature in one ``row_gather`` launch, on ``values``' device."""
    values = torch.as_tensor(values)
    b = bins.boundaries if isinstance(bins, MDLBins) else bins
    b = torch.as_tensor(np.asarray(b, np.float32) if isinstance(b, np.ndarray) else b, device=values.device)
    b = b.float().contiguous()
    Fn, B = b.shape
    feature_rows = torch.as_tensor(feature_rows, device=values.device)
    (rows,) = row_gather(jax_rows(feature_rows, Fn).to(torch.int32), b)  # [N, B]
    idx = torch.clamp((values[:, None] >= rows).sum(dim=1) - 1, 0, B - 1).to(torch.int32)
    lo_i = torch.clamp(idx, 0, B - 2).long()
    lo = torch.gather(rows, 1, lo_i[:, None])[:, 0]
    hi = torch.gather(rows, 1, (lo_i + 1)[:, None])[:, 0]
    frac = torch.where(hi > lo, (values - lo) / torch.clamp(hi - lo, min=1e-30), 0.0)
    interp = torch.clamp(lo_i + torch.clamp(frac, 0.0, 1.0), 0.0, B - 1.0)
    return idx, interp


def sparse_max_norm(
    values: torch.Tensor,  # [B, F] batch of sparse-feature magnitudes
    running_max: torch.Tensor,  # [F] persistent per-feature max
    *,
    is_training: bool = True,
    epsilon: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """≡ ``twml/layers/sparse_max_norm.py``: each feature over the running
    max |value| seen so far (raised in training). Returns (normed, the new
    running max); the old one is not written."""
    if is_training:
        running_max = torch.maximum(running_max, values.abs().amax(dim=0))
    return values / torch.clamp(running_max[None, :], min=epsilon), running_max


def stitch(values: Tuple[torch.Tensor, ...], indices: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """≡ ``twml/layers/stitch.py`` (tf.dynamic_stitch): interleave shards
    back into one batch by row index."""
    total = sum(int(v.shape[0]) for v in values)
    out = values[0].new_zeros((total, *values[0].shape[1:]))
    for v, i in zip(values, indices):
        out[torch.as_tensor(i, device=out.device).long()] = v
    return out
