"""The port's host copies of the label closure, UUA and experiment tracking
(the_algorithm_tpu_torch/{actions/uua,training/labels,training/tracking}.py)
against the JAX package's modules on the same events, logs and runs.

Both sides are host Python over the same inputs: everything compares
exactly (labels, ids and timestamps as arrays; UUA records field by field;
run files key by key).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch_port_util  # noqa: F401  (pins torch to one thread)

from the_algorithm_tpu.actions import uua as juua
from the_algorithm_tpu.training import labels as jlb
from the_algorithm_tpu.training import tracking as jtk
from the_algorithm_tpu_torch.actions import uua
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.training import labels as lb
from the_algorithm_tpu_torch.training import tracking as tk

CLIENT_ACTIONS = [("tweet", "favorite"), ("tweet", "reply"), ("tweet", "retweet"), ("tweet", "quote"),
                  ("tweet", "click"), ("profile", "visit"), ("video", "quality_view"), ("tweet", "bookmark"),
                  ("tweet", "share"), ("tweet", "linger"), ("tweet", "open_link"), ("tweet", "screenshot"),
                  ("tweet", "not_interested"), ("user", "block"), ("user", "mute"), ("tweet", "report"),
                  ("tweet", "impression"), ("tweet", "nonsense")]


def _raw_events(seed=0, n=400, users=6, tweets=12):
    """Seeded raw client events: every action the label rules read (and one
    the adapter drops), dwell times around both bars, the meta flags."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        item_type, action = CLIENT_ACTIONS[rng.integers(len(CLIENT_ACTIONS))]
        e = {"user_id": int(rng.integers(users)), "item_type": item_type, "action": action,
             "item_id": int(rng.integers(tweets)), "ts_ms": int(rng.integers(0, 200_000) * 1000)}
        if rng.random() < 0.5:
            e["dwell_s"] = float(rng.choice([5, 10, 30, 119, 120, 300]))
        if rng.random() < 0.3:
            e["engaged_by_author"] = bool(rng.random() < 0.5)
        if rng.random() < 0.3:
            e["engaged"] = True
        out.append(e)
    return out


def _served_lines(seed=1, users=6, tweets=12):
    rng = np.random.default_rng(seed)
    return [json.dumps({"key": "home", "user_id": int(u), "served_at": int(rng.integers(0, 150_000)),
                        "candidates": [{"tweet_id": int(t), "score": 0.5, "source": "x", "predicted": {"fav": 0.1}}
                                       for t in rng.choice(tweets, 5, replace=False)]})
            for u in rng.integers(0, users, 40)]


def _record(a):
    d = dataclasses.asdict(a)
    d["action_type"] = a.action_type.value
    return d


def _actions(pkg, raw):
    return [a for e in raw for a in pkg.client_event_adapter(e)]


def test_action_types_and_head_catalog_equal_jax():
    assert [(t.name, t.value) for t in uua.ActionType] == [(t.name, t.value) for t in juua.ActionType]
    assert {t.value for t in uua.NEGATIVE_ACTIONS} == {t.value for t in juua.NEGATIVE_ACTIONS}
    assert lb.HEAD_NAMES == jlb.HEAD_NAMES == tuple(masknet.DEFAULT_HEAD_NAMES)
    for got, want in zip(lb.HEAD_LABEL_RULES, jlb.HEAD_LABEL_RULES):
        assert (got.head, {t.value for t in got.action_types}, got.min_dwell_s, got.needs_meta) == (
            want.head, {t.value for t in want.action_types}, want.min_dwell_s, want.needs_meta)


@pytest.mark.parametrize("adapter,events", [
    ("client_event_adapter", _raw_events(2, n=60)),
    ("tls_favs_adapter", [{"fav_type": k, "user_id": 3, "tweet_id": 9, "ts_ms": 5, "author_id": a}
                          for k in ("fav", "unfav", "retweet") for a in (None, 4)]),
    ("social_graph_adapter", [{"op": op, "source_id": s, "target_id": 7, "ts_ms": 11}
                              for op in ("follow", "unfollow", "block", "unblock", "mute", "unmute", "report", "poke")
                              for s in (1, None)]),
])
def test_adapters_equal_jax(adapter, events):
    got = [_record(a) for e in events for a in getattr(uua, adapter)(e)]
    want = [_record(a) for e in events for a in getattr(juua, adapter)(e)]
    assert got == want and got


def test_enricher_equals_jax():
    raw = _raw_events(3, n=80)
    authors = {t: 100 + t for t in range(0, 12, 2)}
    runs = []
    for pkg in (uua, juua):
        plan = pkg.EnrichmentPlan([pkg.EnrichmentStage(lambda a: a.item_id, pkg.AuthorHydrator(authors)),
                                   pkg.EnrichmentStage(lambda a: a.user_id, pkg.NoopHydrator())])
        runs.append([_record(a) for a in pkg.enrich(_actions(pkg, raw), plan)])
    assert runs[0] == runs[1]
    assert any(r["author_id"] is not None for r in runs[0])


@pytest.mark.parametrize("window", [24 * 3600, 600])
def test_join_labels_equals_jax(window):
    raw = _raw_events()
    served = lb.parse_served_log(_served_lines())
    jserved = jlb.parse_served_log(_served_lines())
    got = lb.join_labels(served, _actions(uua, raw), attribution_window_s=window)
    want = jlb.join_labels(jserved, _actions(juua, raw), attribution_window_s=window)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3].any() and not got[3].all()


@pytest.mark.parametrize("downsample", [1.0, 0.3])
def test_build_training_examples_equals_jax(downsample):
    raw = _raw_events(4)

    def feature_fn(users, tweets):
        return np.stack([users, tweets, users * 7 + tweets], axis=1)

    got = lb.build_training_examples(_served_lines(5), _actions(uua, raw), feature_fn,
                                     negative_downsample=downsample, rng=np.random.default_rng(9))
    want = jlb.build_training_examples(_served_lines(5), _actions(juua, raw), feature_fn,
                                       negative_downsample=downsample, rng=np.random.default_rng(9))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def _write_runs(pkg, root):
    t = [100.0]
    for name, aucs, final in (("a", [0.6, 0.72], None), ("b", [0.69], {"auc": 0.8}), ("c", [], None)):
        tr = pkg.ExperimentTracker(root, name, hparams={"lr": 0.1, "name": name}, clock=lambda: t[0])
        for i, v in enumerate(aucs):
            t[0] += 1.0
            tr.log_metrics(i, {"auc": v, "loss": 1 - v})
        tr.record_export(f"/models/{name}/1", 1)
        tr.finish("done", final_metrics=final)
    with open(f"{root}/a/metrics.jsonl", "a") as f:
        f.write('{"step": 9, "auc":')  # a torn tail write
    return root


def test_tracking_run_files_and_compare_runs_equal_jax(tmp_path):
    mine, theirs = _write_runs(tk, str(tmp_path / "port")), _write_runs(jtk, str(tmp_path / "jax"))
    assert tk.list_runs(mine) == jtk.list_runs(theirs) == ["a", "b", "c"]
    for name in ("a", "b", "c"):
        got, want = tk.load_run(mine, name), jtk.load_run(theirs, name)
        for run in (got, want):
            run.pop("git_rev"), run.pop("user")
        assert got == want
        a, b = tk.ExperimentTracker.__new__(tk.ExperimentTracker), jtk.ExperimentTracker.__new__(jtk.ExperimentTracker)
        a._metrics_path, b._metrics_path = f"{mine}/{name}/metrics.jsonl", f"{theirs}/{name}/metrics.jsonl"
        assert a.metrics() == b.metrics()
    for mode in ("max", "min"):
        assert tk.compare_runs(mine, "auc", mode) == jtk.compare_runs(theirs, "auc", mode)
        # each package reads the other's runs
        assert tk.compare_runs(theirs, "loss", mode) == jtk.compare_runs(mine, "loss", mode)
    assert tk.compare_runs(mine, "auc") == [("b", 0.8), ("a", 0.72)]
