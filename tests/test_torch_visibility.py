"""The port's visibility layer (pipeline/visibility*.py) against the JAX
package's: the enums, every level's rule table, the JAX test's rule-table
cases, seeded feature maps at every SafetyLevel (decisions, the metric
recorder's counts, the stats counters), the store-backed engine and the
pipeline filter.

The seeded maps draw from the keys each level's rules read. They are found
by evaluating JAX's engine on mappings that log every key asked of them
(and every label a set-valued key is asked for), over a few rounds of
random maps, since a condition reads its later keys only when its earlier
ones pass. Scores are drawn around every threshold written in the rule
sources.
"""

import inspect
import re

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread per worker)
from test_visibility_rules import CASES
from the_algorithm_tpu.core import metrics as jax_metrics
from the_algorithm_tpu.pipeline import component as jax_component
from the_algorithm_tpu.pipeline import visibility as jax_vis
from the_algorithm_tpu.pipeline import visibility_rules as jax_rules
from the_algorithm_tpu.pipeline import visibility_rules_breadth as jax_breadth
from the_algorithm_tpu_torch.core import metrics
from the_algorithm_tpu_torch.pipeline import component
from the_algorithm_tpu_torch.pipeline import visibility as vis
from the_algorithm_tpu_torch.pipeline import visibility_rules as rules

LEVELS = [lvl.name for lvl in jax_vis.SafetyLevel]
MAPS = 200  # seeded feature maps a level
DISCOVERY_ROUNDS, DISCOVERY_MAPS = 3, 24
KEYWORDS = ("kw0", "kw1", "kw2")  # values of keys a rule intersects as sets


def _thresholds():
    """Every float literal in (0, 1] of the rule sources: the score cut-offs."""
    src = "".join(inspect.getsource(m) for m in (jax_vis, jax_rules, jax_breadth))
    return sorted({float(x) for x in re.findall(r"(?<![\w.])(0\.\d+|1\.0)(?![\w.])", src)})


THRESHOLDS = _thresholds()


class Asked(set):
    """A set-valued feature that logs each name asked for and whether it was
    iterated (a set intersection)."""

    def __init__(self, log, key):
        super().__init__()
        self.log, self.key = log, key

    def __contains__(self, name):
        self.log.setdefault(self.key, ("labels", set()))[1].add(name)
        return False

    def __iter__(self):
        self.log[self.key] = ("keywords", set())
        return iter(())


class Logging(dict):
    """A feature map that logs each key asked of it with its default; set
    defaults come back as :class:`Asked`."""

    def __init__(self, log, values=()):
        super().__init__(values)
        self.log = log

    def get(self, key, default=None):
        if key in self:
            return super().get(key)
        if isinstance(default, (tuple, list, set, frozenset)):
            return Asked(self.log, key)
        self.log.setdefault(key, ("value", default))
        return default


def draw(rng, vocab):
    """One seeded feature map over a level's vocabulary: about two keys set
    a map, so that most maps trigger a rule or two and not the level's
    first drop."""
    out = {}
    present = min(0.6, 2.0 / max(len(vocab), 1))
    for key, (kind, info) in sorted(vocab.items()):
        if rng.random() >= present:
            continue  # absent: the rule's default
        if kind == "labels":
            names = sorted(info)
            out[key] = {n for n in names if rng.random() < 1.5 / max(len(names), 1)}
        elif kind == "keywords":
            out[key] = {k for k in KEYWORDS if rng.random() < 0.4}
        elif isinstance(info, bool):
            out[key] = bool(rng.random() < 0.5)
        elif isinstance(info, float):
            t = THRESHOLDS[rng.integers(len(THRESHOLDS))]
            out[key] = float(rng.choice([rng.random(), t, t + 1e-6, t - 1e-6]))
        elif isinstance(info, int):
            out[key] = int(rng.integers(0, 5))
        elif isinstance(info, str):
            out[key] = str(rng.choice(["drop", "interstitial", "allow"]))
        else:
            out[key] = bool(rng.random() < 0.5)
    return out


def level_vocab(engine, level, rng):
    """The keys ``level``'s rules read in JAX's engine, as :func:`draw` takes them."""
    vocab = {}
    engine.evaluate(level, Logging(vocab))
    for _ in range(DISCOVERY_ROUNDS):
        for _ in range(DISCOVERY_MAPS):
            engine.evaluate(level, Logging(vocab, draw(rng, vocab)))
    return vocab


def outcome(res):
    return res.action.name, int(res.action), res.reason, list(res.triggered_rules)


class Exploding(dict):
    """A feature map whose every read raises (a store that is down)."""

    def get(self, key, default=None):
        raise RuntimeError("store unavailable")


def test_actions_and_safety_levels_are_the_reference_enums():
    assert [(a.name, a.value) for a in vis.Action] == [(a.name, a.value) for a in jax_vis.Action]
    assert [(s.name, s.value) for s in vis.SafetyLevel] == [(s.name, s.value) for s in jax_vis.SafetyLevel]
    # the aliases too
    assert {n: m.value for n, m in vis.SafetyLevel.__members__.items()} == \
        {n: m.value for n, m in jax_vis.SafetyLevel.__members__.items()}
    assert len(jax_vis.SafetyLevel.__members__) > len(jax_vis.SafetyLevel)


@pytest.mark.parametrize("table", ["CATALOG_RULES", "STANDARD_RULES"])
def test_every_level_has_the_same_rules(table):
    got = getattr(rules if table == "CATALOG_RULES" else vis, table)
    want = getattr(jax_rules if table == "CATALOG_RULES" else jax_vis, table)
    assert [lvl.name for lvl in got] == [lvl.name for lvl in want]
    for lvl, rs in want.items():
        assert [(r.name, int(r.action), r.reason, r.fail_closed) for r in got[vis.SafetyLevel[lvl.name]]] == \
            [(r.name, int(r.action), r.reason, r.fail_closed) for r in rs], lvl
    assert rules.all_rule_names() == jax_rules.all_rule_names()


@pytest.mark.parametrize("case_id,level,features,want_action,want_rule", CASES, ids=[c[0] for c in CASES])
def test_rule_table_cases(case_id, level, features, want_action, want_rule):
    got = rules.catalog_engine().evaluate(vis.SafetyLevel[level.name], dict(features))
    want = jax_rules.catalog_engine().evaluate(level, dict(features))
    assert outcome(got) == outcome(want)
    assert got.action.name == want_action.name
    if want_rule is not None:
        assert want_rule in got.triggered_rules


@pytest.mark.parametrize("level", LEVELS)
def test_seeded_maps_decide_alike(level):
    """MAPS seeded maps (and one whose reads raise) through the catalog
    engine, and through the standard engine where it has the level: the
    same action, reason and triggered rules, the same recorder matrix and
    verdicts, the same stats counters."""
    rng = np.random.default_rng([17, LEVELS.index(level)])
    tables = [(rules.CATALOG_RULES, jax_rules.CATALOG_RULES)]
    if jax_vis.SafetyLevel[level] in jax_vis.STANDARD_RULES:
        tables.append((vis.STANDARD_RULES, jax_vis.STANDARD_RULES))
    for port_rules, jax_table in tables:
        stats, jstats = metrics.StatsReceiver(), jax_metrics.StatsReceiver()
        rec, jrec = vis.VisibilityResultsMetricRecorder(), jax_vis.VisibilityResultsMetricRecorder()
        engine = vis.VisibilityRuleEngine(port_rules, stats=stats, recorder=rec)
        jengine = jax_vis.VisibilityRuleEngine(jax_table, stats=jstats, recorder=jrec)
        lvl, jlvl = vis.SafetyLevel[level], jax_vis.SafetyLevel[level]
        vocab = level_vocab(jax_vis.VisibilityRuleEngine(jax_table), jlvl, rng)
        maps = [draw(rng, vocab) for _ in range(MAPS)]
        seen = set()
        for m in maps:
            got, want = engine.evaluate(lvl, dict(m)), jengine.evaluate(jlvl, dict(m))
            assert outcome(got) == outcome(want), m
            seen.add((want.action.name, tuple(want.triggered_rules)))
        assert outcome(engine.evaluate(lvl, Exploding())) == outcome(jengine.evaluate(jlvl, Exploding()))
        assert rec.matrix() == jrec.matrix()
        assert rec.verdict_counts == jrec.verdict_counts
        assert stats.counters() == jstats.counters()
        if vocab:  # the draws reach the rules: several outcomes
            assert len(seen) > 2, (level, seen)


class Takedowns:
    """A takedown store: tweet 7 is withheld in DE."""

    def is_withheld(self, tweet_id, country):
        return tweet_id == 7 and country == "DE"


def test_engine_with_stores():
    def author_state(author_id):
        return {3: 1, 4: 0}.get(author_id)

    engine = rules.catalog_engine_with_stores(Takedowns(), author_state)
    jengine = jax_rules.catalog_engine_with_stores(Takedowns(), author_state)
    assert [r.name for r in rules.store_backed_rules(Takedowns(), author_state)] == \
        [r.name for r in jax_rules.store_backed_rules(Takedowns(), author_state)]
    maps = [{"tweet_id": 7, "viewer_country": "DE"}, {"tweet_id": 7, "viewer_country": "US"},
            {"author_id": 3}, {"author_id": 4}, {"tweet_id": "x"}, {}, {"author_id": 3, "tweet_labels": {"abusive"}}]
    for level in ("TIMELINE_HOME", "TIMELINE_PROFILE", "SEARCH", "RECOMMENDATIONS"):
        for m in maps:
            got = engine.evaluate(vis.SafetyLevel[level], dict(m))
            want = jengine.evaluate(jax_vis.SafetyLevel[level], dict(m))
            assert outcome(got) == outcome(want), (level, m)
    assert engine.evaluate(vis.SafetyLevel.TIMELINE_HOME, {"tweet_id": 7, "viewer_country": "DE"}).action \
        == vis.Action.DROP
    # a fail-closed store rule whose store raises drops
    assert engine.evaluate(vis.SafetyLevel.TIMELINE_HOME, {"tweet_id": "x"}).action == vis.Action.DROP


def test_visibility_filter_apply():
    """Kept and removed ids, downranked scores and the stamped features."""
    rng = np.random.default_rng(5)
    feats = []
    for i in range(64):
        f = {"tweet_labels": set(rng.choice(["abusive", "nsfw_high_precision", "gore_and_violence", "pdna",
                                             "public_interest", "none"], size=rng.integers(0, 3)).tolist()),
             "toxicity_score": float(rng.choice([0.5, 0.85, 0.92, 0.99])),
             "viewer_follows_author": bool(rng.random() < 0.3), "is_deleted": bool(rng.random() < 0.05),
             "viewer_mutes_author": bool(rng.random() < 0.05), "is_nsfw_media": bool(rng.random() < 0.1)}
        feats.append(f)
    for level in ("TIMELINE_HOME", "RECOMMENDATIONS", "TIMELINE_PROFILE", "SEARCH"):
        for make, jmake in ((rules.catalog_engine, jax_rules.catalog_engine),
                            (vis.standard_engine, jax_vis.standard_engine)):
            got = vis.VisibilityFilter(make(), vis.SafetyLevel[level], downrank_factor=0.5).apply(
                None, [component.Candidate(id=i, features=dict(f), score=1.0 + i) for i, f in enumerate(feats)], None)
            want = jax_vis.VisibilityFilter(jmake(), jax_vis.SafetyLevel[level], downrank_factor=0.5).apply(
                None, [jax_component.Candidate(id=i, features=dict(f), score=1.0 + i) for i, f in enumerate(feats)],
                None)
            for g, w in ((got.kept, want.kept), (got.removed, want.removed)):
                assert [(c.id, c.score, c.features) for c in g] == [(c.id, c.score, c.features) for c in w]
            assert isinstance(got, component.FilterResult)
            if level == "TIMELINE_HOME":
                assert got.removed and got.kept
