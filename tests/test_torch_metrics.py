"""The port's ``core/metrics._Stat`` against numpy's percentiles of the
stream it was fed, and the JAX package's ``_Stat``, whose eviction by sorted
rank stops its kept values being a sample of the stream once it holds 4,096
(a fault of the reference that the port does not repeat)."""

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread per worker)
from the_algorithm_tpu.core import metrics as jax_metrics
from the_algorithm_tpu_torch.core import metrics

PERCENTILES = (50, 90, 99)


def _uniform(n):
    return np.random.default_rng(21).uniform(0.0, 1.0, n)


def _fed(stat_class, values):
    stat = stat_class()
    for v in values:
        stat.add(float(v))
    return stat


def test_jax_stat_misreads_the_median_past_its_cap():
    values = _uniform(20_000)
    stat = _fed(jax_metrics._Stat, values)
    assert abs(stat.percentile(50) - np.percentile(values, 50)) > 0.1


@pytest.mark.parametrize("values, tol", [
    (_uniform(20_000), 0.02),
    (_uniform(100_000), 0.02),
    (np.arange(20_000, dtype=np.float64), 0.02 * 20_000),  # 2% of the ramp's span
], ids=["uniform_20k", "uniform_100k", "ramp_20k"])
def test_stat_percentiles_hold_to_numpy(values, tol):
    stat = _fed(metrics._Stat, values)
    assert stat.count == len(values) and len(stat.values) == 4096
    assert stat.total == pytest.approx(float(np.sum(values)))
    for p in PERCENTILES:
        assert abs(stat.percentile(p) - np.percentile(values, p)) <= tol, p
