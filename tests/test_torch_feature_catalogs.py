"""The port's feature catalogs against the JAX package's: the aggregation
config catalog (features/aggregation_configs.py: the groups, the
pre-transforms, the stores folded through ``apply_events``) and the
prediction feature catalog (features/prediction_catalog.py)."""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from the_algorithm_tpu.features import aggregation_configs as jax_ac
from the_algorithm_tpu.features import prediction_catalog as jax_pc
from the_algorithm_tpu.models import masknet as jax_masknet
from the_algorithm_tpu_torch.features import aggregation_configs as ac
from the_algorithm_tpu_torch.features import prediction_catalog as pc
from the_algorithm_tpu_torch.models import masknet

CONFIGS = [c.name for c in jax_ac.build_catalog()]
EVENTS = 4096
CAPACITY = 2048
# folded aggregates: exp2 decays and f32 sums of repeated rows in another order
FOLD_RTOL = 1e-6
KEY_RANGES = {"user_id": 48, "author_id": 24, "engager_id": 16, "mentioned_user_id": 16,
              "original_author_id": 16, "topic_id": 8, "list_id": 8, "day_of_week": 7, "hour_of_day": 24,
              "tweet_id": 64}


def event_batch(seed, t0):
    """EVENTS seeded events: every key column (user 0 in a seventh of
    them), every label, engagement values and non-decreasing timestamps
    from ``t0``."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, n, EVENTS) for k, n in KEY_RANGES.items()}
    batch["user_id"][::7] = 0
    batch["is_in_network"] = rng.integers(0, 2, EVENTS)
    for label in jax_ac.LABELS_V2 + jax_ac.NEGATIVE_LABELS:
        batch[label] = (rng.random(EVENTS) < 0.3).astype(np.float32)
    batch["engagement"] = rng.normal(size=EVENTS).astype(np.float32)
    batch["timestamp"] = np.sort(t0 + rng.integers(0, 7200, EVENTS)).astype(np.int32)
    return batch


def later_batch(batch, seed, t0):
    """``batch``'s events shuffled, the keys but the user's moved by 3 (new
    rows beside old ones), new labels, values and timestamps from ``t0``.
    Every pre-transform keeps as many events as in ``batch``, so JAX's fold
    compiles once a config."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(EVENTS)
    out = {k: v[perm] for k, v in batch.items()}
    for k in KEY_RANGES:
        if k != "user_id":
            out[k] = out[k] + 3
    fresh = event_batch(seed, t0)
    for k in jax_ac.LABELS_V2 + jax_ac.NEGATIVE_LABELS + ("engagement", "timestamp"):
        out[k] = fresh[k]
    return out


def test_build_catalog_is_the_reference_catalog():
    got, want = ac.build_catalog(), jax_ac.build_catalog()
    assert [c.name for c in got] == [c.name for c in want]
    for g, w in zip(got, want):
        assert (g.keys, g.realtime, g.n_outputs) == (w.keys, w.realtime, w.n_outputs)
        assert (g.group.name, g.group.features, g.group.labels, g.group.metrics, g.group.half_lives_s) == \
            (w.group.name, w.group.features, w.group.labels, w.group.metrics, w.group.half_lives_s)
        assert g.group.output_names() == w.group.output_names()
        assert getattr(g.pre_transform, "__name__", None) == getattr(w.pre_transform, "__name__", None)
    assert (ac.LABELS_V2, ac.NEGATIVE_LABELS, ac.CONTINUOUS_FEATURES, ac.DAY) == \
        (jax_ac.LABELS_V2, jax_ac.NEGATIVE_LABELS, jax_ac.CONTINUOUS_FEATURES, jax_ac.DAY)


@pytest.mark.parametrize("name", ["remove_user_id_zero", "filter_in_network", "filter_out_of_network"])
def test_pre_transform_masks(name):
    batch = event_batch(3, 1000)
    got, want = getattr(ac, name)(batch), getattr(jax_ac, name)(batch)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and 0 < got.sum() < EVENTS


@pytest.mark.parametrize("name", CONFIGS)
def test_apply_events_folds_as_jax(name):
    """Two seeded batches (the second an hour later, so rows decay) through
    the config's pre-transform, key resolution and fold: the same rows
    allocated, the stores within FOLD_RTOL, timestamps exact."""
    cfg = next(c for c in ac.build_catalog() if c.name == name)
    jcfg = next(c for c in jax_ac.build_catalog() if c.name == name)
    store, resolver = ac.init_stores([cfg], CAPACITY, device="cpu")[name]
    jstore, jresolver = jax_ac.init_stores([jcfg], CAPACITY)[name]
    assert store.values.device.type == "cpu" and store.values.shape == jstore.values.shape
    first = event_batch(1, 100_000)
    for batch in (first, later_batch(first, 2, 103_600)):
        store = ac.apply_events(cfg, store, resolver, batch)
        jstore = jax_ac.apply_events(jcfg, jstore, jresolver, batch)
    assert resolver._map == jresolver._map and len(resolver._map) > 1
    np.testing.assert_allclose(store.values.numpy(), np.asarray(jstore.values), rtol=FOLD_RTOL, atol=0)
    np.testing.assert_array_equal(store.last_ts.numpy(), np.asarray(jstore.last_ts))


def test_empty_after_transform_is_noop():
    cfg = next(c for c in ac.build_catalog() if c.name == "user_aggregate_v2")
    store, resolver = ac.init_stores([cfg], 8, device="cpu")[cfg.name]
    batch = event_batch(4, 1000)
    batch["user_id"] = np.zeros(EVENTS, np.int64)  # all removed
    assert ac.apply_events(cfg, store, resolver, batch) is store


def test_init_stores_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ac.init_stores(ac.build_catalog()[:1], 8)


def test_prediction_catalog_in_order():
    got = [(f.name, f.kind.value, f.family, sorted(f.tags), f.width) for f in pc.CATALOG._by_name.values()]
    want = [(f.name, f.kind.value, f.family, sorted(f.tags), f.width) for f in jax_pc.CATALOG._by_name.values()]
    assert got == want and len(got) >= 300
    assert [k.value for k in pc.FeatureKind] == [k.value for k in jax_pc.FeatureKind]
    assert pc.CATALOG.families() == jax_pc.CATALOG.families()
    assert [f.name for f in pc.CATALOG.binary_labels()] == [f.name for f in jax_pc.CATALOG.binary_labels()]
    families = pc.CATALOG.families()
    assert [(s.name, s.width) for s in pc.CATALOG.schema(families)] == \
        [(s.name, s.width) for s in jax_pc.CATALOG.schema(families)]


def test_predicted_heads_bind_to_catalog_labels():
    assert pc.PREDICTED_HEAD_LABELS == jax_pc.PREDICTED_HEAD_LABELS
    assert tuple(masknet.DEFAULT_HEAD_NAMES) == tuple(jax_masknet.DEFAULT_HEAD_NAMES)
    assert pc.validate_heads(masknet.DEFAULT_HEAD_NAMES) == [] == jax_pc.validate_heads(masknet.DEFAULT_HEAD_NAMES)
    heads = list(masknet.DEFAULT_HEAD_NAMES) + ["not_a_head"]
    assert pc.validate_heads(heads) == jax_pc.validate_heads(heads) == ["not_a_head"]
