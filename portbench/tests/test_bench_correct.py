"""``correct`` at a test's size on the CPU: a sound run passes where the
comparison is exact enough to hold at any size, the control fails, and a
run whose timed path is broken underneath comes out false for each fault
the cell can have. The limits are the cells' own (``limits/``)."""

import pytest
import torch
from portbench_tiny import SANN_CELL, run_tiny, setup_tiny

from portbench import harness
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.simclusters import ann


def _over(checks: dict) -> list:
    return [k for k, v in checks.items() if not harness.within(v)]


def test_a_sound_sann_run_is_correct():
    result = run_tiny(SANN_CELL)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"sann_queries_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [2**31 + 17, 2**31 + 19])
def test_the_control_is_not_correct(seed):
    cell, s = setup_tiny(SANN_CELL, seed)
    limits = cell.limits
    control = cell.driver.control(s)
    assert [k for k, v in control.items() if limits[k] is not None and v > limits[k]], (control, limits)


def _altered(orig):
    def call(index, sources, cfg, **kw):
        ids, scores = orig(index, sources, cfg, **kw)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % index.tweet_ids.shape[0]  # another tweet where the answer is produced
        return ids, scores
    return call


def _half_the_queries(orig):
    def call(index, sources, cfg, **kw):
        h = sources.ids.shape[0] // 2
        ids, scores = orig(index, SparseEmbedding(sources.ids[:h], sources.scores[:h]), cfg, **kw)
        return torch.cat([ids, ids]), torch.cat([scores, scores])
    return call


@pytest.mark.parametrize("fault", [_altered, _half_the_queries])
def test_a_broken_sann_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(ann, "get_tweet_candidates_batch", fault(ann.get_tweet_candidates_batch))
    result = run_tiny(SANN_CELL)
    assert result["correct"] is False and _over(result["checks"])
