"""The port's push notifications (the_algorithm_tpu_torch/models/
push_rankers.py, mixers/{push_candidates, pushservice}.py) against the JAX
package's.

Tolerances: the light ranker and ClemNet from JAX's ``init`` through
``params_from_flax``, in eval mode and over two train steps: logits and the
updated ``batch_stats`` within rtol 1e-5 / atol 1e-6 (f32 means and sums
in another order). Every case of tests/test_push_candidates.py and
tests/test_pushservice.py runs in both packages with the same outcome, and
``PushPipeline.run`` with the same sources and models picks the same
winner, score (rtol 1e-5) and NTab record.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread)

from the_algorithm_tpu.mixers import push_candidates as jpc
from the_algorithm_tpu.mixers import pushservice as jps
from the_algorithm_tpu.models import push_rankers as jpr
from the_algorithm_tpu.pipeline import component as jcomp
from the_algorithm_tpu_torch.mixers import push_candidates as pc
from the_algorithm_tpu_torch.mixers import pushservice as ps
from the_algorithm_tpu_torch.models import push_rankers as pr
from the_algorithm_tpu_torch.pipeline import component as comp

RTOL, ATOL = 1e-5, 1e-6
SMALL_BLOCKS = (dict(dense_size=16, conv_filters=2), dict(dense_size=16, conv_filters=2, residual=True),
                dict(dense_size=8))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _same_stats(got, want):
    for k, v in want.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            _same_stats(got[k], v)
        else:
            _close(got[k], v)


def _models(kind):
    rng = np.random.default_rng(0)
    B, F = 32, 12
    x = rng.normal(size=(B, F)).astype(np.float32) * 2 + 0.5
    if kind == "light":
        jm = jpr.LightRankingMLP(hidden=(16, 8), num_heads=2)
        m = pr.LightRankingMLP(F, hidden=(16, 8), num_heads=2, device="cpu")
    else:
        jm = jpr.ClemNet(blocks=tuple(jpr.ClemNetBlockParams(**b) for b in SMALL_BLOCKS), num_heads=3)
        m = pr.ClemNet(F, blocks=tuple(pr.ClemNetBlockParams(**b) for b in SMALL_BLOCKS), num_heads=3, device="cpu")
    variables = jax.jit(lambda k, x: jm.init(k, x, train=True))(jax.random.PRNGKey(3), jnp.asarray(x))
    pr.params_from_flax(m, variables)
    return jm, m, variables, x


@pytest.mark.parametrize("kind", ["light", "clemnet"])
def test_rankers_match_flax(kind):
    jm, m, variables, x = _models(kind)
    _close(m(torch.from_numpy(x), train=False).detach(), jm.apply(variables, jnp.asarray(x), train=False))
    apply_train = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(1)
    for step in range(2):
        xb = (x if step == 0 else rng.normal(size=x.shape).astype(np.float32) - 1.0)
        want, upd = apply_train({"params": params, "batch_stats": stats}, jnp.asarray(xb))
        got = m(torch.from_numpy(xb), train=True).detach()
        _close(got, want)
        stats = upd["batch_stats"]
        _same_stats(pr.batch_stats(m), jax.tree_util.tree_map(np.asarray, stats))
    # eval after training: the updated running stats in use
    _close(m(torch.from_numpy(x), train=False).detach(),
           jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))


def test_clemnet_gradient_matches_flax():
    jm, m, variables, x = _models("clemnet")
    y = (np.arange(x.shape[0]) % 2).astype(np.float32)

    def jloss(p):
        logits, _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return jnp.mean((logits[:, 0] - y) ** 2)

    jg = jax.jit(jax.grad(jloss))(variables["params"])
    loss = torch.mean((m(torch.from_numpy(x), train=True)[:, 0] - torch.from_numpy(y)) ** 2)
    loss.backward()
    b0 = m.blocks[0]
    _close(b0.cw_dense.kernel.grad, jg["block_0"]["cw_dense"]["kernel"])
    _close(b0.conv_weight.grad, np.transpose(np.asarray(jg["block_0"]["conv"]["kernel"]), (2, 1, 0)))
    _close(m.heads.kernel.grad, jg["heads"]["kernel"])


def test_channel_wise_dense_channels_independent():
    """tests/test_visibility_push_ts.py:82-96, and the same numbers as flax."""
    layer = jpr.ChannelWiseDense(output_size=5)
    x = jnp.ones((2, 7, 3))
    params = layer.init(jax.random.PRNGKey(0), x)
    m = pr.ChannelWiseDense(7, 3, 5, device="cpu")
    with torch.no_grad():
        m.kernel.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"])))
        m.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
    xt = torch.ones(2, 7, 3)
    out = m(xt).detach()
    assert out.shape == (2, 5, 3)
    _close(out, layer.apply(params, x))
    x2 = xt.clone()
    x2[:, :, 0] = 0.0
    out2 = m(x2).detach()
    assert not np.allclose(out[:, :, 0], out2[:, :, 0])
    np.testing.assert_allclose(out[:, :, 1:], out2[:, :, 1:])


# -- tests/test_push_candidates.py and tests/test_pushservice.py, both packages ----


def _pkgs(port):
    return (pc, ps, comp) if port else (jpc, jps, jcomp)


def _static(C, cands):
    class StaticSource(C.CandidateSource):
        def get(self, target, params):
            return [C.Candidate(id=i, features=dict(f)) for i, f in cands]
    return StaticSource()


def _candidate_cases(port):
    pcm, psm, C = _pkgs(port)
    out = {}
    adaptors = pcm.build_push_adaptors(earlybird_source=_static(C, [(1, {})]), trends_source=_static(C, [(2, {})]))
    out["names"] = [a.name for a in adaptors]
    a = pcm.AdaptorSource(_static(C, [(5, {})]), pcm.CRT.TREND_TWEET, "Trends")
    got = a.get(psm.PushTarget(user_id=1), None)
    out["stamp"] = (got[0].features["crt"].name, got[0].source)
    cfg = pcm.PushFatigueConfig()
    now = 100_000
    ntab = pcm.NTabStore()
    ntab.record_sent(1, pcm.SentNotification(9, pcm.CRT.OON_TWEET, now - 3600 * 30))
    r = [pcm.crt_allowed(ntab, 1, pcm.CRT.OON_TWEET, now, cfg)]
    ntab.record_sent(1, pcm.SentNotification(10, pcm.CRT.OON_TWEET, now - 3600 * 5))
    r += [pcm.crt_allowed(ntab, 1, pcm.CRT.OON_TWEET, now, cfg), pcm.crt_allowed(ntab, 1, pcm.CRT.IN_NETWORK_TWEET,
                                                                                  now, cfg)]
    g = pcm.NTabStore()
    for i in range(4):
        g.record_sent(1, pcm.SentNotification(i, pcm.CRT.IN_NETWORK_TWEET, now - 3600 * (i + 5)))
    r.append(pcm.crt_allowed(g, 1, pcm.CRT.TREND_TWEET, now, cfg))
    iv = pcm.NTabStore()
    iv.record_sent(1, pcm.SentNotification(9, pcm.CRT.IN_NETWORK_TWEET, now - 3000))
    r.append(pcm.crt_allowed(iv, 1, pcm.CRT.IN_NETWORK_TWEET, now, cfg))
    c = pcm.NTabStore()
    n2 = 10 * 86400
    c.record_sent(1, pcm.SentNotification(9, pcm.CRT.TREND_TWEET, n2 - 3 * 86400))
    c.record_feedback(1, 9, caret=True)
    r += [pcm.crt_allowed(c, 1, pcm.CRT.TREND_TWEET, n2, cfg), pcm.crt_allowed(c, 1, pcm.CRT.TREND_TWEET,
                                                                                 n2 + 5 * 86400, cfg)]
    out["fatigue"] = r
    assert r == [True, False, True, False, False, False, True]
    t = psm.PushTarget(user_id=1)
    q = pcm.quiet_hours_predicate(22, 8)
    out["quiet"] = [q(t, h * 3600) for h in range(24)] + [pcm.quiet_hours_predicate(1, 5)(t, h * 3600)
                                                          for h in range(24)]

    def scores(ids):
        s = {"nsfw": np.asarray([0.9 if i == 2 else 0.0 for i in ids]), "toxicity": np.zeros(len(ids))}
        return {k: torch.from_numpy(v) for k, v in s.items()} if port else s

    cs = [C.Candidate(id=i) for i in (1, 2, 3)]
    out["health"] = pcm.health_model_predicate(scores)(None, cs)
    d = pcm.NTabStore()
    d.record_sent(1, pcm.SentNotification(7, pcm.CRT.OON_TWEET, 10))
    out["dedup"] = [pcm.not_already_sent(d)(t, C.Candidate(id=i)) for i in (7, 8)]
    oon = C.Candidate(id=1, features={"crt": pcm.CRT.OON_TWEET, "social_proof": 0.0})
    inn = C.Candidate(id=2, features={"crt": pcm.CRT.IN_NETWORK_TWEET})
    out["oon"] = [pcm.min_social_proof_for_oon(1.0)(t, x) for x in (oon, inn)]
    ratio = pcm.tweet_engagement_ratio_predicate(0.5)
    out["ratio"] = [ratio(t, C.Candidate(id=1, features=f)) for f in (
        {"fav_count": 5, "reply_count": 100}, {"fav_count": 80, "reply_count": 100}, {"fav_count": 0, "reply_count": 5})]
    lang = pcm.language_match_predicate()
    target = type("Target", (), {"languages": ("en",)})()
    out["lang"] = [lang(target, C.Candidate(id=1, features=f)) for f in ({"language": "en"}, {"language": "ja"}, {})]
    return out


def test_push_candidates_cases_match_jax():
    assert _candidate_cases(True) == _candidate_cases(False)


def _pipeline(port, sources, ntab=None, **kw):
    _, psm, _ = _pkgs(port)
    pcm = pc if port else jpc
    return psm.PushPipeline(
        sources=sources, light_predict=lambda f: f[:, 0],
        heavy_predict=lambda f: np.stack([f[:, 0], f[:, 0]], axis=1),
        featurize=lambda t, c: np.asarray([float(c.features.get("retrieval_score", c.id))], np.float32),
        heavy_head_weights=np.asarray([1.0, 0.5]), ntab=ntab,
        fatigue_config=pcm.PushFatigueConfig() if ntab is not None else None, **kw)


def _service_cases(port):
    pcm, psm, C = _pkgs(port)
    out = {}
    pol = psm.FatiguePolicy(max_per_day=2, min_interval_s=100)
    out["eligible"] = [psm.target_is_eligible(t, 1000, pol) for t in (
        psm.PushTarget(user_id=1), psm.PushTarget(1, has_device=False), psm.PushTarget(1, recent_notification_count=2),
        psm.PushTarget(1, last_notification_ts=950), psm.PushTarget(1, notifications_enabled=False))]

    def make(**kw):
        d = dict(sources=[_static(C, [(i, {}) for i in (1, 5, 9)])], light_predict=lambda f: f[:, 0],
                 heavy_predict=lambda f: np.stack([f[:, 0], 1 - f[:, 0]], axis=1),
                 featurize=lambda t, c: np.array([c.id / 10.0, t.open_rate], np.float32),
                 heavy_head_weights=np.array([1.0, 0.0]), light_keep=2)
        d.update(kw)
        return psm.PushPipeline(**d)

    w = make().run(psm.PushTarget(user_id=1), now=10 ** 6)
    out["best"] = (w.id, w.score, w.features["push_light_score"])
    calls = []
    make(heavy_predict=lambda f: calls.append(f.shape[0]) or np.stack([f[:, 0], f[:, 0]], 1)).run(
        psm.PushTarget(user_id=1), now=10 ** 6)
    out["light_keep"] = calls
    out["ineligible"] = make().run(psm.PushTarget(1, notifications_enabled=False), 10 ** 6)

    class Boom(C.CandidateSource):
        def get(self, target, params):
            raise RuntimeError("nope")

    out["fail_open"] = (make(sources=[Boom()]).run(psm.PushTarget(user_id=1), now=10 ** 6),
                        make(sources=[Boom(), _static(C, [(2, {})])]).run(psm.PushTarget(user_id=1), now=10 ** 6).id)
    # tests/test_push_candidates.py's end-to-end cases
    ntab = pcm.NTabStore()
    src = pcm.AdaptorSource(_static(C, [(10, {"retrieval_score": 5.0}), (11, {"retrieval_score": 3.0})]),
                            pcm.CRT.OON_TWEET, "ContentRecommenderMixer")
    p = dataclasses.replace(_pipeline(port, [src], ntab=ntab), candidate_predicates=[pcm.not_already_sent(ntab)])
    first = p.run(psm.PushTarget(user_id=1), now=10 ** 6)
    out["take"] = (first.id, first.score, sorted(ntab.sent_tweet_ids(1)),
                   p.run(psm.PushTarget(user_id=1), now=10 ** 6 + 3600 * 12))

    def scores(ids):
        return {"toxicity": np.asarray([0.9 if i == 10 else 0.0 for i in ids])}

    src = pcm.AdaptorSource(_static(C, [(10, {"retrieval_score": 5.0}), (11, {"retrieval_score": 3.0})]),
                            pcm.CRT.IN_NETWORK_TWEET, "Earlybird")
    p = dataclasses.replace(_pipeline(port, [src]), batch_candidate_predicates=[pcm.health_model_predicate(scores)])
    out["health"] = p.run(psm.PushTarget(user_id=1), now=10 ** 6).id
    src = pcm.AdaptorSource(_static(C, [(10, {})]), pcm.CRT.IN_NETWORK_TWEET, "EB")
    p = dataclasses.replace(_pipeline(port, [src]), target_predicates=[pcm.quiet_hours_predicate(22, 8)])
    out["quiet"] = (p.run(psm.PushTarget(user_id=1), now=23 * 3600), p.run(psm.PushTarget(user_id=1),
                                                                           now=12 * 3600).id)
    return out


def test_pushservice_cases_match_jax():
    got, want = _service_cases(True), _service_cases(False)
    assert got == want
    assert got["best"][0] == 9 and got["take"][3] is None and got["health"] == 11


def test_push_pipeline_with_rankers_matches_jax():
    """Two adaptors, the light ranker and ClemNet (flax init carried over),
    the health predicate, NTab and fatigue: the same winner, score and NTab
    in both packages, twice (the second run inside the minimum interval)."""
    jl, light, lv, _ = _models("light")
    jc, heavy, cv, _ = _models("clemnet")
    rng = np.random.default_rng(5)
    feats = {i: rng.normal(size=12).astype(np.float32) for i in range(100, 140)}
    jlight = jax.jit(lambda x: jl.apply(lv, x, train=False)[:, 0])
    jheavy = jax.jit(lambda x: jax.nn.sigmoid(jc.apply(cv, x, train=False)))
    outs = []
    for port in (True, False):
        pcm, psm, C = _pkgs(port)
        ntab = pcm.NTabStore()
        srcs = pcm.build_push_adaptors(
            earlybird_source=_static(C, [(i, {"social_proof": 1.0}) for i in range(100, 120)]),
            content_mixer_source=_static(C, [(i, {"social_proof": float(i % 3)}) for i in range(115, 140)]))
        if port:
            lp = lambda x: light(torch.from_numpy(x))[:, 0].detach()  # noqa: E731
            hp = lambda x: torch.sigmoid(heavy(torch.from_numpy(x))).detach()  # noqa: E731
        else:
            lp, hp = (lambda x: jlight(jnp.asarray(x))), (lambda x: jheavy(jnp.asarray(x)))
        health = pcm.health_model_predicate(lambda ids: {"toxicity": np.asarray([0.9 if i % 7 == 0 else 0.1
                                                                                  for i in ids])})
        pipe = psm.PushPipeline(sources=srcs, light_predict=lp, heavy_predict=hp,
                                featurize=lambda t, c: feats[c.id], heavy_head_weights=np.asarray([1.0, 0.5, 0.25]),
                                light_keep=8, candidate_predicates=[pcm.not_already_sent(ntab),
                                                                    pcm.min_social_proof_for_oon(1.0)],
                                batch_candidate_predicates=[health], ntab=ntab,
                                fatigue_config=pcm.PushFatigueConfig())
        runs = []
        for u, now in ((1, 10 ** 6), (1, 10 ** 6 + 60), (2, 10 ** 6)):
            w = pipe.run(psm.PushTarget(user_id=u), now)
            runs.append(None if w is None else (w.id, w.score, w.features["crt"].name, w.source,
                                                w.features["push_light_score"]))
        outs.append((runs, [[(n.tweet_id, n.crt.name, n.sent_at) for n in ntab.history(u)] for u in (1, 2)]))
    (got, gn), (want, wn) = outs
    assert gn == wn and got[1] is None and got[0] is not None
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g[0] == w[0] and g[2:4] == w[2:4]
            np.testing.assert_allclose([g[1], g[4]], [w[1], w[4]], rtol=RTOL, atol=ATOL)
