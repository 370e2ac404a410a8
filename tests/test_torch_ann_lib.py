"""The port's ANN library (``ann_lib``) against the JAX package's.

Brute force: ids equal, distances within rtol 1e-5 / atol 1e-5 (a matmul in
another order; L2's squared distances within 1e-6 of ‖q‖² + ‖x‖², where
both packages' f32 expansion cancels). IVF: the JAX index's centroids and cells carried over
(``ClusteredScanIndex.from_jax``), queries equal; the port's own k-means to
the JAX test's recall bound. The loadtest recorder on the same lists gives
the same row. HNSW: the engine source is a byte-for-byte copy, built into
the port's library; the same inserts give the same answers in both
packages, and a snapshot saved by either loads in the other.
"""

import filecmp
import os

import numpy as np
import pytest

from the_algorithm_tpu.ann_lib import BruteForceIndex as JBrute
from the_algorithm_tpu.ann_lib import ClusteredScanIndex as JIvf
from the_algorithm_tpu.ann_lib import LoadTestRecorder as JRecorder
from the_algorithm_tpu.ann_lib import Metric as JMetric
from the_algorithm_tpu.ann_lib.hnsw import HnswIndex as JHnsw
from the_algorithm_tpu_torch.ann_lib import BruteForceIndex, ClusteredScanIndex, LoadTestRecorder, Metric, run_loadtest
from the_algorithm_tpu_torch.ann_lib.hnsw import HnswIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_distances(metric, got, want, q, x):
    """Distances within rtol 1e-5 / atol 1e-5; L2 squared within 1e-6 of
    ‖q‖² + ‖x‖² (its f32 expansion cancels: both packages round it)."""
    if metric != Metric.L2:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1).max()
    assert (np.abs(got ** 2 - want ** 2) <= 1e-6 * scale).all()


def corpus(n=2000, d=32, seed=0):
    """The JAX tests' clustered corpus."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d)) * 3
    x = centers[rng.integers(0, 16, n)] + rng.normal(size=(n, d))
    return x.astype(np.float32), np.arange(n) + 1000


@pytest.mark.parametrize("metric", list(Metric))
def test_brute_force_matches_jax(metric):
    x, ids = corpus(n=600)
    idx, jidx = BruteForceIndex(32, metric, device="cpu"), JBrute(32, JMetric(metric.value))
    for part in (slice(0, 400), slice(400, 600)):  # two appends
        idx.append(ids[part], x[part])
        jidx.append(ids[part], x[part])
    q = x[:12] + 0.01
    got, want = idx.query(q, 10), jidx.query(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    _same_distances(metric, got[1], want[1], q, x)
    assert len(idx) == 600


def test_brute_force_l2_distances():
    idx = BruteForceIndex(2, Metric.L2, device="cpu")
    idx.append([1, 2], np.array([[0, 0], [3, 4]], np.float32))
    got_ids, got_dist = idx.query(np.zeros((1, 2)), k=2)
    assert got_ids[0].tolist() == [1, 2]
    np.testing.assert_allclose(got_dist[0], [0.0, 5.0], atol=1e-5)


@pytest.mark.parametrize("metric,probes", [(Metric.COSINE, 4), (Metric.L2, 2), (Metric.INNER_PRODUCT, 3)])
def test_ivf_from_jax_queries_match_jax(metric, probes):
    x, ids = corpus()
    jidx = JIvf(32, JMetric(metric.value), n_clusters=16, n_probes=probes)
    jidx.append(ids, x)
    jidx.build()
    idx = ClusteredScanIndex.from_jax(jidx, device="cpu")
    np.testing.assert_array_equal(idx._members.numpy(), np.asarray(jidx._members))
    q = x[:40] + 0.05
    got, want = idx.query(q, 10), jidx.query(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    _same_distances(metric, got[1], want[1], q, x)


def test_ivf_builds_its_own_cells_to_the_jax_recall_bound():
    x, ids = corpus()
    truth = BruteForceIndex(32, device="cpu")
    truth.append(ids, x)
    t_ids, _ = truth.query(x[:50], 10)

    def recall(idx):
        g, _ = idx.query(x[:50], 10)
        return np.mean([len(set(t_ids[i]) & set(g[i])) / 10 for i in range(50)])

    ivf = ClusteredScanIndex(32, n_clusters=16, n_probes=8, device="cpu")
    ivf.append(ids, x)
    assert recall(ivf) > 0.9
    members = ivf._members.numpy()
    assert sorted(members[members >= 0].tolist()) == list(range(2000))  # every vector in one cell
    one = ClusteredScanIndex(32, n_clusters=32, n_probes=1, seed=1, device="cpu")
    one.append(ids, x)
    many = ClusteredScanIndex(32, n_clusters=32, n_probes=16, seed=1, device="cpu")
    many.append(ids, x)
    assert recall(many) >= recall(one)


def test_loadtest_harness_and_recorder_match_jax():
    x, ids = corpus(n=500)
    idx = BruteForceIndex(32, device="cpu")
    idx.append(ids, x)
    res = run_loadtest(idx, x[:20] + 0.01, k=20, truth_vectors=x, truth_ids=ids, device="cpu")
    assert res.recall_at_1 == 1.0 and res.overall_recall == 1.0 and res.num_queries == 20
    assert res.p99_latency_us >= res.p50_latency_us > 0 and res.avg_rps > 0
    assert len(res.row().split("\t")) == 8
    ivf = ClusteredScanIndex(32, n_clusters=64, n_probes=1, device="cpu")
    ivf.append(ids, x)
    assert run_loadtest(ivf, x[:20], k=20, truth_vectors=x, truth_ids=ids, device="cpu").overall_recall < 1.0
    rng = np.random.default_rng(3)
    rec, jrec = LoadTestRecorder(), JRecorder()
    for i in range(30):
        got, truth, lat = rng.integers(0, 40, 20), rng.integers(0, 40, 20), float(rng.uniform(10, 500))
        rec.record(got, truth, lat)
        jrec.record(got, truth, lat)
    assert rec.result(0.5).row() == jrec.result(0.5).row()


def test_hnsw_source_is_a_byte_copy():
    assert filecmp.cmp(os.path.join(REPO, "the_algorithm_tpu", "native", "src", "hnsw.cc"),
                       os.path.join(REPO, "the_algorithm_tpu_torch", "native", "src", "hnsw.cc"), shallow=False)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE, Metric.INNER_PRODUCT])
def test_hnsw_matches_jax_and_snapshots_load_across(metric, tmp_path):
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(20, 16))
    x = (centers[rng.integers(0, 20, 1500)] + 0.3 * rng.normal(size=(1500, 16))).astype(np.float32)
    ids = np.arange(10_000, 11_500, dtype=np.int64)
    h, jh = HnswIndex(16, metric, ef=100, seed=2), JHnsw(16, JMetric(metric.value), ef=100, seed=2)
    h.append(ids, x)
    jh.append(ids, x)
    q = x[:24] + 0.05 * rng.normal(size=(24, 16)).astype(np.float32)
    got = h.query(q, 10)
    for a, b in zip(got, jh.query(q, 10)):
        np.testing.assert_array_equal(a, b)
    truth = BruteForceIndex(16, metric, device="cpu")
    truth.append(ids, x)
    want, _ = truth.query(q, 10)
    assert np.mean([len(set(got[0][i]) & set(want[i])) / 10 for i in range(24)]) >= 0.9
    h.save(str(tmp_path / "port.hnsw"))
    jh.save(str(tmp_path / "jax.hnsw"))
    from_jax = HnswIndex.load(str(tmp_path / "jax.hnsw"), 16, metric, ef=100)
    from_port = JHnsw.load(str(tmp_path / "port.hnsw"), 16, JMetric(metric.value), ef=100)
    assert len(from_jax) == len(from_port) == 1500
    for a, b in zip(from_jax.query(q, 10), got):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(from_port.query(q, 10), got):
        np.testing.assert_array_equal(a, b)
