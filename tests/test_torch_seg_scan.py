"""Port run-collapse (the_algorithm_tpu_torch/ops/seg_scan.py) against the
dict oracle, the JAX Pallas kernel in interpret mode, and the JAX package's
portable dedup path. Sums are compared as id → sums dicts at rtol 1e-5: the
plain version and the JAX paths add a run's values in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_same_collapse, collapse_to_dict

from the_algorithm_tpu.ops import retrieval as jax_retrieval
from the_algorithm_tpu.ops import seg_scan as jax_seg_scan
from the_algorithm_tpu_torch.ops import retrieval, seg_scan
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


def _oracle(ids_row, *vals):
    sums = [dict() for _ in vals]
    for i, t in enumerate(ids_row):
        for d, v in zip(sums, vals):
            d[int(t)] = d.get(int(t), 0.0) + float(v[i])
    return sums


def _sorted_rows(rng, Q, W, hi, k):
    ids = np.sort(rng.integers(0, hi, size=(Q, W)).astype(np.int32), axis=1)
    vals = [rng.random((Q, W)).astype(np.float32) for _ in range(k)]
    return ids, vals


@pytest.mark.parametrize("W,hi", [(256, 13), (1024, 200), (2500, 50_000), (512, 1)])
def test_plain_matches_dict_oracle(W, hi):
    rng = np.random.default_rng(W + hi)
    ids, vals = _sorted_rows(rng, 3, W, hi, 2)
    ids[0, -W // 4 :] = PAD_ID  # a row with a PAD tail
    rep, s1, s2 = seg_scan.run_collapse_sorted(
        torch.from_numpy(ids), *(torch.from_numpy(v) for v in vals)
    )
    for q in range(3):
        want1, want2 = _oracle(ids[q], vals[0][q], vals[1][q])
        want = {t: (want1[t], want2[t]) for t in want1 if t != PAD_ID}
        assert_same_collapse(collapse_to_dict(rep[q], s1[q], s2[q]), want)
    # every slot that holds no run is (PAD_ID, 0), PAD runs included
    empty = rep.numpy() == PAD_ID
    assert np.all(s1.numpy()[empty] == 0) and np.all(s2.numpy()[empty] == 0)


def test_plain_matches_jax_pallas_interpret():
    rng = np.random.default_rng(7)
    ids, vals = _sorted_rows(rng, 2, 256, 40, 2)
    ids[1, -30:] = PAD_ID
    want = jax_seg_scan.run_collapse_sorted(
        jnp.asarray(ids), *(jnp.asarray(v) for v in vals), interpret=True
    )
    got = seg_scan.run_collapse_sorted(torch.from_numpy(ids), *(torch.from_numpy(v) for v in vals))
    for q in range(2):
        assert_same_collapse(
            collapse_to_dict(*(g[q] for g in got)),
            collapse_to_dict(*(np.asarray(w)[q] for w in want)),
        )
        # both fill run ends, so the populated slots coincide
        np.testing.assert_array_equal(got[0][q].numpy(), np.asarray(want[0])[q])


def test_dedup_sum_matches_jax_scan_path():
    rng = np.random.default_rng(3)
    Q, W = 3, 300
    ids = rng.integers(0, 60, size=(Q, W)).astype(np.int32)  # unsorted
    ids[2, ::3] = PAD_ID
    v1, v2 = rng.random((Q, W)).astype(np.float32), rng.random((Q, W)).astype(np.float32)
    got = retrieval._dedup_sum(torch.from_numpy(ids), torch.from_numpy(v1), torch.from_numpy(v2))
    for q in range(Q):
        want = jax_retrieval._dedup_sum(jnp.asarray(ids[q]), jnp.asarray(v1[q]), jnp.asarray(v2[q]))
        assert_same_collapse(
            collapse_to_dict(*(g[q] for g in got)),
            collapse_to_dict(*(np.asarray(w) for w in want)),
        )


@pytest.mark.parametrize("k", [1, 3])
def test_plain_takes_one_to_three_value_arrays(k):
    rng = np.random.default_rng(k)
    ids, vals = _sorted_rows(rng, 2, 64, 9, k)
    got = seg_scan.run_collapse_sorted(torch.from_numpy(ids), *(torch.from_numpy(v) for v in vals))
    assert len(got) == 1 + k
    for q in range(2):
        want = _oracle(ids[q], *(v[q] for v in vals))
        assert_same_collapse(
            collapse_to_dict(*(g[q] for g in got)),
            {t: tuple(w[t] for w in want) for t in want[0]},
        )


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = seg_scan.run_collapse_sorted.launches
    ids = torch.tensor([[1, 1, 2]], dtype=torch.int32)
    rep, s = seg_scan.run_collapse_sorted(ids, torch.ones(1, 3))
    assert rep.tolist() == [[PAD_ID, 1, 2]] and s.tolist() == [[0.0, 2.0, 1.0]]
    assert seg_scan.run_collapse_sorted.launches == before


@pytest.mark.parametrize(
    "ids,values",
    [
        (torch.zeros(2, 4, dtype=torch.int64), (torch.zeros(2, 4),)),  # id dtype
        (torch.zeros(2, 4, dtype=torch.int32), (torch.zeros(2, 5),)),  # shape
        (torch.zeros(2, 4, dtype=torch.int32), (torch.zeros(2, 4, dtype=torch.float64),)),
        (torch.zeros(2, 4, dtype=torch.int32), (torch.zeros(2, 4),) * 4),  # k > 3
        (torch.zeros(2, 4, dtype=torch.int32), ()),  # k = 0
        (torch.zeros(4, 2, dtype=torch.int32).T, (torch.zeros(2, 4),)),  # not contiguous
        (torch.zeros(8, dtype=torch.int32), (torch.zeros(8),)),  # not 2-D
    ],
)
def test_rejects_what_the_kernel_does_not_take(ids, values):
    with pytest.raises(ValueError):
        seg_scan.run_collapse_sorted(ids, *values)



SHAPES = [seg_scan.SHAPE, seg_scan.TileShape(2040, 3, 1), seg_scan.TileShape(4088, 1, 4)]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("W", [1, 3, 4, 5, 4095, 4097, 20_000, 32_705, 200_000])
@pytest.mark.parametrize("Q", [1, 5, 32, 256, 1000])
def test_plan_covers_every_slot_within_the_kernels_limits(Q, W, k):
    for shape in SHAPES:
        cluster, tile, passes, stages, threads, smem = plan = seg_scan._plan(Q, W, k, 132, shape)
        assert 1 <= cluster <= seg_scan.MAX_CLUSTER and cluster <= max(1, -(-shape.per_sm * 132 // Q)), plan
        if Q >= shape.per_sm * 132:
            assert cluster == 1, plan  # enough rows to give every SM its CTAs
        # the tiles of the passes cover the row, and no CTA is left without a slot
        assert tile % 4 == 0 and 4 <= tile <= shape.tile_max, plan
        assert cluster * tile * passes >= W > (cluster - 1) * tile * passes, plan
        # 8 slots a thread, over the tile and the up to 3 slots before it
        assert threads % 32 == 0 and 32 <= threads <= seg_scan.MAX_THREADS and 8 * threads >= tile + 3, plan
        assert stages == shape.stages and smem == stages * (1 + k) * threads * 32 <= seg_scan.SMEM_PER_CTA, plan


@pytest.mark.parametrize("args", [(0, 5, 2), (5, 0, 2), (5, 5, 0), (5, 5, 4)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        seg_scan._plan(*args, 132)
    with pytest.raises(ValueError):
        seg_scan._plan(5, 5, 2, 132, seg_scan.TileShape(4090, 2, 1))  # not a multiple of 4


def test_plan_at_the_candidate_sources_shapes():
    """UTEG's [32, 256] rows (R=32 users × 8 seeds × 32 slots) get clusters
    of 5 CTAs of one warp; UTG's [256, 4,096] rows one CTA each, two passes."""
    assert seg_scan._plan(32, 256, 2, 132)[:5] == (5, 52, 1, 2, 32)
    for k in (1, 2):
        cluster, tile, passes, _, threads, _ = seg_scan._plan(256, 4096, k, 132)
        assert (cluster, tile, passes, threads) == (1, 2048, 2, 288)
