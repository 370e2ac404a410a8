"""The benchmark's arithmetic and input generators, on the CPU."""

import statistics

import pytest
import torch
from portbench_tiny import TINY_SANN

from portbench import compare, yardstick
from portbench.generators import sann_world
from portbench.reference import sann as ref_sann

def test_gather_bound_is_chip_smokes():
    ids = torch.tensor([[3, 3, 7], [1, 3, 9]], dtype=torch.int32)
    row_bytes = 3 * 1600
    # chip_smoke.time_gather: ids.numel() * ids.element_size() + (distinct + ids.numel()) * row_bytes
    want = ids.numel() * ids.element_size() + (int(torch.unique(ids).numel()) + ids.numel()) * row_bytes
    assert yardstick.gather_bytes(ids.numel(), int(torch.unique(ids).numel()), row_bytes) == want
    # chip_smoke.time_collapse: 2 * sum of the entries' bytes
    entries = [torch.zeros((4, 10), dtype=torch.int32), torch.zeros((4, 10)), torch.zeros((4, 10))]
    assert yardstick.collapse_bytes(4, 10, 2) == 2 * sum(t.numel() * t.element_size() for t in entries)


@pytest.mark.parametrize("intervals, union", [
    ([], 0.0),
    ([(0.0, 1.0), (2.0, 3.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0), (2.5, 2.7)], 3.0),
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 5.5)], 6.0),
    ([(1.0, 1.0), (2.0, 1.5)], 0.0),
])
def test_union_of_intervals(intervals, union):
    assert yardstick.union_length(intervals) == pytest.approx(union)
    merged = yardstick.merge_intervals(intervals)
    assert all(a[1] < b[0] for a, b in zip(merged, merged[1:]))


def test_clip_and_spread():
    assert yardstick.clip_intervals([(0.0, 2.0), (3.0, 4.0), (5.0, 9.0)], 1.0, 6.0) == [(1.0, 2.0), (3.0, 4.0),
                                                                                          (5.0, 6.0)]
    values = [10.0, 11.0, 9.0, 10.5, 9.5, 10.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert yardstick.quartile_spread(values) == pytest.approx((q3 - q1) / med)


def _world(seed):
    shape = sann_world.shape_of(TINY_SANN)
    gen = torch.Generator().manual_seed(seed)
    world = sann_world.build(shape, gen, "cpu")
    return shape, world, sann_world.draw_queries(shape, world.comm_clusters, 16, gen, "cpu")


def test_sann_world_is_the_seeds():
    shape, a, qa = _world(2**31 + 3)
    _, b, qb = _world(2**31 + 3)
    _, c, _ = _world(4)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and all(torch.equal(x, y) for x, y in zip(qa, qb))
    assert not torch.equal(a.index_ids, c.index_ids)
    # each row score-descending, PAD after the last tweet; queries of distinct clusters of one community
    real = a.index_ids != ref_sann.PAD_ID
    assert bool((a.index_scores[:, :-1] >= a.index_scores[:, 1:]).all())
    assert bool((real[:, :-1] | ~real[:, 1:]).all())
    ids = qa[0].long()
    assert all(len(set(r.tolist())) == shape.N for r in ids)
    comm_of = torch.empty(shape.C, dtype=torch.long)
    comm_of[a.comm_clusters.reshape(-1)] = torch.arange(shape.n_comm).repeat_interleave(shape.cpc)
    assert bool((comm_of[ids] == comm_of[ids[:, :1]]).all())


def test_sann_reference_is_the_hashmap_loop():
    """The reference's lists equal a dict transcription of the JVM loop."""
    shape, world, (q_ids, q_scores) = _world(21)
    cands = ref_sann.candidates(world.index_ids, world.index_scores, q_ids, q_scores)
    ids, scores = ref_sann.top(cands, q_ids.shape[0], shape.X)
    for q in range(4):
        dot, norm = {}, {}
        for c, cs in zip(q_ids[q].tolist(), q_scores[q].tolist()):
            for t, ts in zip(world.index_ids[c].tolist(), world.index_scores[c].tolist()):
                if t != ref_sann.PAD_ID:
                    dot[t] = dot.get(t, 0.0) + ts * cs
                    norm[t] = norm.get(t, 0.0) + ts * ts
        l2 = sum(s * s for s in q_scores[q].tolist()) ** 0.5
        want = {t: d / l2 / norm[t] ** 0.5 for t, d in dot.items()}
        best = sorted(want.values(), reverse=True)[: shape.X]
        # many cosines tie exactly (a tweet in one of the query's clusters
        # scores that cluster's weight over the query's norm), so lists agree
        # in scores, and in ids above the X-th score
        assert scores[q].tolist() == pytest.approx(best, rel=1e-12)
        assert all(want[t] == pytest.approx(v, rel=1e-12) for t, v in zip(ids[q].tolist(), scores[q].tolist()))
        assert {t for t, v in want.items() if v > best[-1] * (1 + 1e-12)} <= set(ids[q].tolist())
    assert compare.sann(ids, scores, cands, scores) == {"score_err": 0.0, "rank_gap": 0.0}
