"""The live freshness check of ``chip_smoke.py``'s live phase, rehearsed on
the CPU over a small world in both directions.

The probe is served as the card serves it: the serving engine's scorer
(device top-K selection) behind ``chip_smoke.spread_lift`` (creation times
below ``SPREAD_TS``, where a request's scores spread); ``bench_events``
batches with fav bursts on the probe's top candidate are folded in by a
``LiveUpdater``; ``freshness_moved`` is the check. With the events applied
it passes; with none applied the next request scores the target exactly as
before and the check fails. No JAX: the check is the port's alone.
"""

import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (pins torch to one thread)

import chip_smoke
from the_algorithm_tpu_torch.mixers import batched_foryou as bf
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.mixers import live_updates as lu
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.mixers.home_mixer import ForYouQuery
from the_algorithm_tpu_torch.models import masknet

NOW = 10_000_000
A = 48
WORLD = dict(seed=3, num_users=32, num_authors=A, num_tweets=1 << 12, engagement_width=8, now=NOW)
TOP_K = 50


class _Fixed(bf.BatchCandidateSource):
    """Per-user candidate ids below the world's 4,096 tweets."""

    def __init__(self, name, base, n):
        self.name, self.base, self.n = name, base, n

    def get_batch(self, queries, params):
        return [bf.CandidateColumns((self.base + 37 * int(q.user_id) + 13 * np.arange(self.n, dtype=np.int64)) % 4000
                                    + 1, (1.0 / (1 + np.arange(self.n))).astype(np.float32)) for q in queries]


def _probe_engine():
    """A fresh world's serving scorer behind the spread lift, as
    ``phase_foryou`` builds the probe engine on the card."""
    world = wh.synthetic_world(**WORLD, device="cpu")
    tables, fns, res = dh.build_from_world(world, world.pop("device_spec"))
    cfg = masknet.MaskNetConfig(num_features=fs.total_width(fs.WIDE_SCHEMA), num_heads=15, mask_blocks=1,
                                block_dim=32, aggregation_dim=16, head_hidden=(16,), dtype="float32")
    model = masknet.MaskNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    scorer = dh.DeviceHydrationScorer(tables, fns, res, model, masknet.DEFAULT_HEAD_WEIGHTS, pad_b=128,
                                      compute_dtype=torch.float32, select_top_k=TOP_K)
    sources = [_Fixed("simclusters_interested_in", 100, 40), _Fixed("EarlybirdInNetwork", 120, 30),
               _Fixed("TweetMixer", 160, 25)]
    lift = chip_smoke.spread_lift(bf.ColumnsLift(A, NOW))
    return bf.BatchedForYouEngine(batch_sources=sources, scorer=scorer, head_names=masknet.DEFAULT_HEAD_NAMES,
                                  lift=lift, max_age_s=10 ** 9)


@pytest.mark.parametrize("batches", [4, 0])
def test_freshness_check_passes_with_the_fav_bursts_and_fails_without(batches):
    engine = _probe_engine()
    probe = ForYouQuery(user_id=900 % WORLD["num_users"], followed_authors=list(range(0, A, 5)), max_results=TOP_K,
                        now=NOW)
    target = engine.serve_batch([probe])[0][0]
    updater = lu.LiveUpdater(engine.scorer)
    rng = np.random.default_rng(23)
    author = int(target.features.get("author_id", 0) or 0)
    for b in range(batches):
        updater.apply(chip_smoke.bench_events(rng, NOW + 1 + b, int(target.id), author, WORLD["num_users"], A))
    moved, after_s = chip_smoke.freshness_moved(target, engine.serve_batch([probe])[0])
    if batches:
        assert moved
        # the bursts move the target's score itself past the bound (it stays in the list)
        assert after_s is not None and abs(after_s - target.score) > chip_smoke.FRESH_BOUND
    else:
        assert not moved and after_s == target.score
        with pytest.raises(RuntimeError, match="did not move"):
            chip_smoke.require(moved, f"the fav bursts did not move tweet {target.id}'s score")
