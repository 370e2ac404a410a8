"""The port's action pipeline (the_algorithm_tpu_torch/actions/
{uua_adapters, enricher, recos_injector}.py, data/frs_world.raw_events)
against the JAX package's, compared exactly: every adapter on the JAX spec
table (tests/test_uua_adapters.py) and on 500 seeded raw events, the
enricher's staged runs and failure cases (tests/test_uua_enricher.py), the
recos-injector's feeds (ties in timestamps keep their input order), and
the feeds folded into UTEG (exactly) and RealGraph (rtol 1e-6: both fold
in stream order in f32; ``exp2`` may differ by an ulp).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_util  # noqa: F401  (one torch thread)
from test_uua_adapters import CASES

from the_algorithm_tpu.actions import enricher as jen
from the_algorithm_tpu.actions import recos_injector as jri
from the_algorithm_tpu.actions import uua as juua
from the_algorithm_tpu.actions import uua_adapters as jua
from the_algorithm_tpu.graph import realgraph as jrealgraph
from the_algorithm_tpu.graph import uteg as juteg
from the_algorithm_tpu_torch.actions import enricher as en
from the_algorithm_tpu_torch.actions import recos_injector as ri
from the_algorithm_tpu_torch.actions import uua
from the_algorithm_tpu_torch.actions import uua_adapters as ua
from the_algorithm_tpu_torch.data import frs_world as fw
from the_algorithm_tpu_torch.graph import realgraph, uteg

SHAPE = fw.FrsShape(num_users=256, num_authors=64, tweet_space=1024)


def _norm(a):
    return (a.user_id, a.action_type.name, a.item_id, a.timestamp_ms, a.author_id, a.product_surface,
            dict(a.metadata))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_adapter_spec_cases_match_jax(case):
    source, event, want = CASES[case].values
    got = [_norm(a) for a in ua.adapt(source, event)]
    assert got == [_norm(a) for a in jua.adapt(source, event)]
    assert [(g[0], g[1], g[2]) for g in got] == [(u, t.name, i) for u, t, i in want]


def test_seeded_events_match_jax():
    events = fw.raw_events(3, 500, SHAPE)
    assert {k for k, _ in events} == set(ua.ADAPTERS) == set(jua.ADAPTERS)
    n = 0
    for source, event in events:
        got = [_norm(a) for a in ua.adapt(source, event)]
        assert got == [_norm(a) for a in jua.adapt(source, event)], (source, event)
        n += len(got)
    assert 300 < n < 500  # some of each kind drop
    with pytest.raises(KeyError):
        ua.adapt("nope", {})
    assert [r for r in ua.rekey_uua_adapter(ua.adapt(*events[0])[0])][0][0] == events[0][1]["user_id"]


class _Store:
    """tests/test_uua_enricher.py's StoreHydrator, for either package."""

    def __init__(self, pkg, tweet_author, fail_ids=(), tolerate_ids=()):
        self.pkg, self.tweet_author = pkg, tweet_author
        self.fail_ids, self.tolerate_ids, self.calls = set(fail_ids), set(tolerate_ids), []

    def hydrate(self, instruction, key, envelope):
        a = envelope.action
        self.calls.append((instruction, key.value if key else None))
        if instruction == "HYDRATE_AUTHOR":
            assert key is not None and key.key_type == "tweet" and key.value == a.item_id
            if a.item_id in self.fail_ids:
                raise self.pkg.HydrationError(f"store lost tweet {a.item_id}")
            if a.item_id in self.tolerate_ids:
                return envelope
            envelope.action = dataclasses.replace(a, author_id=self.tweet_author[a.item_id])
        elif instruction == "HYDRATE_AUTHOR_META" and a.author_id is not None:
            envelope.action.metadata["author_rep"] = 0.5
        return envelope


def _enricher_cases(port):
    pkg, U = (en, uua) if port else (jen, juua)
    act = lambda uid, tweet: U.UnifiedUserAction(user_id=uid, action_type=U.ActionType.CLIENT_TWEET_FAV,  # noqa
                                                 item_id=tweet, timestamp_ms=1000)
    plan = pkg.Plan((pkg.Stage(pkg.StageType.REPARTITION, ("REPARTITION_TWEET_ID",)),
                     pkg.Stage(pkg.StageType.HYDRATION, ("HYDRATE_AUTHOR",)),
                     pkg.Stage(pkg.StageType.HYDRATION, ("HYDRATE_AUTHOR_META",))))

    def run(acts, **kw):
        hyd = _Store(pkg, {101: 7, 102: 8}, **kw)
        out = pkg.run_staged(acts, plan, hyd)
        return ([(_norm(e.action), e.output_topic, e.plan.completed) for e in out.final],
                [(_norm(e.action), why) for e, why in out.dead_letters], out.partitioned_batches, hyd.calls)

    out = [run([act(1, 101), act(2, 102), act(3, 101)]), run([act(1, 101), act(2, 102)], fail_ids={102}),
           run([act(1, 103)], tolerate_ids={103})]
    d = pkg.EnrichmentDriver(None, "p", _Store(pkg, {}), pkg.DefaultPartitioner())
    errs = []
    for env in (pkg.Envelope(act(1, 1), pkg.Plan(())),
                pkg.Envelope(act(1, 1), pkg.Plan((pkg.Stage(pkg.StageType.REPARTITION, ("A", "B")),))),
                pkg.Envelope(act(1, 1), pkg.Plan((pkg.Stage(pkg.StageType.HYDRATION, ()),))),
                pkg.Envelope(act(1, 1), pkg.Plan((pkg.Stage(pkg.StageType.REPARTITION, ("X",)),)))):
        try:
            d.execute(None, env)
            errs.append(None)
        except (RuntimeError, ValueError) as e:
            errs.append((type(e).__name__, str(e)))
    out.append(errs)
    p = pkg.DefaultPartitioner()
    e = pkg.Envelope(dataclasses.replace(act(1, 9), author_id=4), plan)
    out.append([(k.key_type, k.value) for k in (p.repartition("REPARTITION_TWEET_ID", e),
                                                p.repartition("REPARTITION_AUTHOR_ID", e))])
    return out


def test_enricher_cases_match_jax():
    got, want = _enricher_cases(True), _enricher_cases(False)
    assert got == want
    assert got[0][2] == 2 and len(got[1][1]) == 1 and got[2][0][0][0][4] is None


def _feeds(port, events):
    pkg_ua, pkg_ri = (ua, ri) if port else (jua, jri)
    acts = [a for k, e in events for a in pkg_ua.adapt(k, e)]
    if port:
        res = en.run_staged(acts, fw.ENRICH_PLAN, fw.AuthorHydrator(SHAPE.num_authors, SHAPE.tweet_space))
        final = [e.action for e in res.final]
    else:  # JAX's driver with the same plan and hydrator, over JAX's actions
        plan = jen.Plan(tuple(jen.Stage(jen.StageType[s.stage_type.name], s.instructions)
                              for s in fw.ENRICH_PLAN.stages))
        hyd = fw.AuthorHydrator(SHAPE.num_authors, SHAPE.tweet_space)
        res = jen.run_staged(acts, plan, hyd)
        final = [e.action for e in res.final]
    return pkg_ri.route(final)


def test_route_and_fold_match_jax():
    events = fw.raw_events(5, 1200, SHAPE)
    # ties in timestamps: the stable sort keeps input order
    got, want = _feeds(True, events), _feeds(False, events)
    for name in ("uteg", "simclusters_favs", "realgraph"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=f"{name}.{k}")
    assert len(got.uteg["user_ids"]) > 50 and len(got.realgraph["src"]) > 50
    ts = got.uteg["timestamps"]
    assert (np.diff(ts) >= 0).all() and (np.diff(ts) == 0).any()

    # folded into UTEG and RealGraph
    u = got.uteg
    graph = uteg.record_engagements(uteg.init_graph(SHAPE.num_users, width=16, device="cpu"), u["user_ids"],
                                    u["tweet_ids"], u["types"], u["timestamps"])
    jgraph = juteg.record_engagements(juteg.init_graph(SHAPE.num_users, width=16), u["user_ids"], u["tweet_ids"],
                                      u["types"], u["timestamps"])
    for a, b in zip(graph, jgraph):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    r = got.realgraph
    args = (r["src"], r["dst"], r["interaction_type"], r["timestamps"])
    table = realgraph.apply_interactions(realgraph.init_table(SHAPE.num_users, 8, device="cpu"), *args)
    jtable = jrealgraph.apply_interactions(jrealgraph.init_table(SHAPE.num_users, 8),
                                           *(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(table.neighbor_ids.numpy(), np.asarray(jtable.neighbor_ids))
    np.testing.assert_array_equal(table.last_ts.numpy(), np.asarray(jtable.last_ts))
    np.testing.assert_allclose(table.counts.numpy(), np.asarray(jtable.counts), rtol=1e-6)
    # a routed follow is a RealGraph edge of its user
    follow = realgraph.INTERACTION_TYPES.index("follow")
    i = int(np.flatnonzero(r["interaction_type"] == follow)[-1])
    assert r["dst"][i] in table.neighbor_ids[r["src"][i]].tolist()
