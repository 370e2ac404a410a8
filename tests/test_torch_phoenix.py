"""The port's Phoenix model, scorer and loop (the_algorithm_tpu_torch/models/phoenix.py,
mixers/{phoenix_scorer, phoenix_loop}.py, and ``UserActionsQueryHydrator`` of
mixers/feature_hydrators.py) against the JAX package's.

Tolerances:

- f32 logits against flax ``apply`` on JAX's ``init`` params (carried by
  ``params_from_flax``): rtol 1e-5, atol 1e-6 (f32 sums in another order).
- bf16 logits against flax's bf16 forward: atol 6e-2 on logits of |x| < ~3.
  Both round every product, activation and residual add to bf16 (8 bits of
  mantissa: 2^-8 relative), but XLA's CPU backend has no bf16 × bf16 → f32
  product and rounds otherwise than torch's; a few such roundings through 2
  blocks and the head make the 1-3e-2 differences seen. The same bound holds
  each bf16 forward to the f32 one.
- The head scores: the weighted sum of 13 heads in f32 on each side, rtol
  1e-6. History assembly, the store, the log and the training arrays: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread)

from the_algorithm_tpu.mixers import feature_hydrators as jfh
from the_algorithm_tpu.mixers import phoenix_loop as jpl
from the_algorithm_tpu.mixers import phoenix_scorer as jps
from the_algorithm_tpu.models import phoenix as jp
from the_algorithm_tpu.pipeline.component import Candidate as JCandidate
from the_algorithm_tpu_torch.mixers import feature_hydrators as fh
from the_algorithm_tpu_torch.mixers import phoenix_loop as pl
from the_algorithm_tpu_torch.mixers import phoenix_scorer as ps
from the_algorithm_tpu_torch.models import phoenix
from the_algorithm_tpu_torch.pipeline.component import Candidate

L, C = 16, 12
SMALL = dict(d_model=32, n_layers=2, n_heads=4, max_history=L, author_buckets=1024)
RTOL, ATOL = 1e-5, 1e-6
BF16_ATOL = 6e-2
SCORE_RTOL = 1e-6


def _history(kind, rng):
    """(action_ids, author_hashes, age_s, valid) [L]: full, mostly padding
    (3 valid at the end), or empty. Author hashes take both signs and pass
    the bucket count (the model takes them mod the buckets)."""
    n_valid = {"full": L, "mostly_padding": 3, "empty": 0}[kind]
    valid = np.zeros(L, bool)
    valid[L - n_valid:] = True
    return dict(action_ids=np.where(valid, rng.integers(1, phoenix.NUM_ACTIONS, L), 0).astype(np.int32),
                author_hashes=np.where(valid, rng.integers(-3000, 3000, L), 0).astype(np.int32),
                age_s=np.where(valid, rng.integers(0, 10 ** 6, L), 0).astype(np.int32),
                valid=valid)


def _candidates(rng):
    valid = np.ones(C, bool)
    valid[-3:] = False
    return dict(author_hashes=rng.integers(-5000, 5000, C).astype(np.int32),
                bool_features=(rng.random((C, phoenix.NUM_BOOL_FEATURES)) < 0.5).astype(np.float32),
                valid=valid)


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """(flax model, its params, the port's model with them) at SMALL width."""
    cfg = dict(SMALL, dtype=dtype)
    jm = jp.PhoenixModel(jp.PhoenixConfig(**cfg))
    rng = np.random.default_rng(0)
    seq, cands = _history("full", rng), _candidates(rng)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jp.UserActionSequence(**{k: jnp.asarray(v) for k, v in seq.items()}),
                              jp.CandidateFeatures(**{k: jnp.asarray(v) for k, v in cands.items()}))
    m = phoenix.PhoenixModel(phoenix.PhoenixConfig(**cfg), device="cpu")
    m.load_state_dict(phoenix.params_from_flax(params))
    return jm, params, m


def _forward(dtype, seq, cands):
    jm, params, m = _models(dtype)
    want = np.asarray(jax.jit(jm.apply)(params,
                                        jp.UserActionSequence(**{k: jnp.asarray(v) for k, v in seq.items()}),
                                        jp.CandidateFeatures(**{k: jnp.asarray(v) for k, v in cands.items()})))
    with torch.inference_mode():
        got = m(phoenix.UserActionSequence(**{k: torch.from_numpy(v) for k, v in seq.items()}),
                phoenix.CandidateFeatures(**{k: torch.from_numpy(v) for k, v in cands.items()})).numpy()
    return got, want


@pytest.mark.parametrize("history", ["full", "mostly_padding", "empty"])
def test_f32_logits_match_flax(history):
    rng = np.random.default_rng(1)
    got, want = _forward("float32", _history(history, rng), _candidates(rng))
    assert got.shape == (C, phoenix.NUM_ACTIONS) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("history", ["full", "mostly_padding", "empty"])
def test_bf16_logits_match_flax(history):
    rng = np.random.default_rng(2)
    seq, cands = _history(history, rng), _candidates(rng)
    got, want = _forward("bfloat16", seq, cands)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    # the same params in f32: bf16 stays near it on both sides
    jm, params, _ = _models("bfloat16")
    m32 = phoenix.PhoenixModel(phoenix.PhoenixConfig(**SMALL, dtype="float32"), device="cpu")
    m32.load_state_dict(phoenix.params_from_flax(params))
    with torch.inference_mode():
        f32 = m32(phoenix.UserActionSequence(**{k: torch.from_numpy(v) for k, v in seq.items()}),
                  phoenix.CandidateFeatures(**{k: torch.from_numpy(v) for k, v in cands.items()})).numpy()
    np.testing.assert_allclose(got, f32, rtol=0, atol=BF16_ATOL)


def test_predictions_mask_invalid_candidates_and_history_moves_them():
    jm, params, m = _models("float32")
    rng = np.random.default_rng(3)
    seq, cands = _history("mostly_padding", rng), _candidates(rng)
    t = {k: torch.from_numpy(v) for k, v in seq.items()}
    tc = phoenix.CandidateFeatures(**{k: torch.from_numpy(v) for k, v in cands.items()})
    with torch.inference_mode():
        probs = phoenix.predict_next_actions(m, phoenix.UserActionSequence(**t), tc).numpy()
        t["action_ids"] = t["action_ids"].clone()
        t["action_ids"][-1] = int(phoenix.ActionName.CLIENT_TWEET_REPORT)
        moved = phoenix.predict_next_actions(m, phoenix.UserActionSequence(**t), tc).numpy()
    want = np.asarray(jax.jit(functools.partial(jp.predict_next_actions, jm))(
        params, jp.UserActionSequence(**{k: jnp.asarray(v) for k, v in seq.items()}),
        jp.CandidateFeatures(**{k: jnp.asarray(v) for k, v in cands.items()})))
    np.testing.assert_allclose(probs, want, rtol=RTOL, atol=ATOL)
    assert np.all(probs[~cands["valid"]] == 0.0) and np.all((probs[cands["valid"]] > 0) & (probs[cands["valid"]] < 1))
    assert not np.allclose(probs[cands["valid"]], moved[cands["valid"]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(dtype):
    _, params, m = _models(dtype)
    back = phoenix.params_to_flax(m.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(m.state_dict())
    for path, leaf in leaves:
        node = back
        for p in path:
            node = node[p.key]
        want = np.asarray(leaf)
        assert node.dtype == want.dtype and node.shape == want.shape and np.array_equal(node, want), path


def test_multi_action_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (C, phoenix.NUM_ACTIONS)).astype(np.float32)
    labels = (rng.random((C, phoenix.NUM_ACTIONS)) < 0.2).astype(np.float32)
    valid = rng.random(C) < 0.7
    got = phoenix.multi_action_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(valid))
    want = jp.multi_action_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def _events(rng, n, authors=40):
    """Raw (ts_ms, action_id, author_hash) events, with repeats of the same
    action and author inside one 5-minute window and dwells among them."""
    ts = rng.integers(0, 3 * 3600 * 1000, n)
    ev = [(int(t), int(rng.integers(1, phoenix.NUM_ACTIONS)), int(rng.integers(0, authors))) for t in ts]
    ev += [(t + 1000, a, h) for t, a, h in ev[: n // 4]]  # same window, same (action, author)
    ev += [(int(t), int(phoenix.ActionName.CLIENT_TWEET_RECAP_DWELLED), 3) for t in ts[:5]]
    return ev


@pytest.mark.parametrize("max_length,exclude_dwells", [(16, False), (16, True), (256, False), (4, True)])
def test_aggregate_history_matches_jax(max_length, exclude_dwells):
    ev = _events(np.random.default_rng(5), 60)
    kw = dict(now_ms=4 * 3600 * 1000, max_length=max_length, exclude_dwells=exclude_dwells)
    got, want = phoenix.aggregate_history(ev, **kw), jp.aggregate_history(ev, **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_user_actions_hydrator_matches_jax():
    ev = _events(np.random.default_rng(6), 40)

    class Q:
        user_id, now = 7, 4 * 3600

    for events in (ev, []):
        got = fh.UserActionsQueryHydrator(lambda uid: events, max_length=L, device="cpu").hydrate(Q(), None)
        want = jfh.UserActionsQueryHydrator(lambda uid: events, max_length=L).hydrate(Q(), None)
        assert got["user_actions_size"] == want["user_actions_size"]
        assert (got["user_actions_contains_explicit_signals"]
                == want["user_actions_contains_explicit_signals"])
        if want["user_actions"] is None:
            assert got["user_actions"] is None
            continue
        for g, w in zip(got["user_actions"], want["user_actions"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the scorer ------------------------------------------------------------------


def _scorer_candidates(Cand):
    """Candidates for every branch: retweets (source-author remap), replies,
    quotes, long and short videos, MaskNet fallbacks, a missing author."""
    out = []
    for i in range(10):
        f = {"author_id": i + 3}
        if i % 3 == 0:
            f.update(source_user_id=40 + i, source_tweet_id=900 + i)
        if i % 4 == 1:
            f["in_reply_to_tweet_id"] = 5
        if i == 2:
            f["quoted_tweet_id"] = 6
        if i in (4, 5):
            f.update(has_video=True, video_duration_ms=30_000 if i == 4 else 5_000)
        if i in (6, 7):
            f.update(predicted_fav=0.33, predicted_share=0.25, predicted_dwell=0.5)
        if i == 9:
            del f["author_id"]
        out.append(Cand(id=100 + i, features=f))
    return out


def _probs(n, rng):
    """Probabilities with zero rows and zero columns (missing predictions)."""
    p = rng.random((n, phoenix.NUM_ACTIONS)).astype(np.float32)
    p[6] = 0.0
    p[:, int(phoenix.ActionName.CLIENT_TWEET_SHARE)] = 0.0
    p[:, int(phoenix.ActionName.CLIENT_TWEET_SHARE_VIA_COPY_LINK)] = 0.0
    p[:, int(phoenix.ActionName.CLIENT_TWEET_CLICK_SEND_VIA_DIRECT_MESSAGE)] = 0.0
    return p


def _scored(mod, Cand, predict, actions="present", heads=None):
    class Q:
        features = {"user_actions": actions}

    seen = {}

    def spy(a, b, v, ua):
        seen.update(authors=np.asarray(a).copy(), bools=np.asarray(b).copy(), valid=np.asarray(v).copy())
        return predict(a, b, v, ua)

    cands = _scorer_candidates(Cand)
    kw = {} if heads is None else {"heads": heads(mod)}
    mod.PhoenixScorer(spy, **kw).score(Q(), cands, None)
    return cands, seen


def _same_scored(got, want):
    for g, w in zip(got, want):
        assert g.id == w.id
        assert sorted(g.features) == sorted(w.features)
        for k in g.features:
            if k.startswith("phoenix_"):
                assert g.features[k] == w.features[k], k
        if w.score is None:
            assert g.score is None
        else:
            np.testing.assert_allclose(g.score, w.score, rtol=SCORE_RTOL)


def _prod_heads(mod):
    return [h if h.name not in ("fav", "bookmark") else mod.PhoenixHead(
        h.name, h.actions, h.weight, h.prod_feature, h.eligible, use_prod=True) for h in mod.PHOENIX_HEADS]


@pytest.mark.parametrize("case", ["heads", "use_prod", "only_if"])
def test_phoenix_scorer_matches_jax(case):
    probs = _probs(10, np.random.default_rng(7))
    kw = dict(heads=_prod_heads) if case == "use_prod" else {}
    if case == "only_if":
        kw["actions"] = None
    got, seen = _scored(ps, Candidate, lambda *a: probs, **kw)
    want, jseen = _scored(jps, JCandidate, lambda *a: probs, **kw)
    _same_scored(got, want)
    for k in jseen:
        np.testing.assert_array_equal(seen[k], jseen[k])
    if case == "heads":
        assert seen["authors"][0] == 40  # a retweet reads its source author
        assert got[4].features.get("phoenix_vqv") is not None and "phoenix_dwell" not in got[4].features
        assert got[6].features["phoenix_fav"] == np.float32(0.33)  # a zero row falls back to MaskNet's
    if case == "only_if":
        assert all(c.score is None for c in got) and not seen


def test_phoenix_scorer_over_the_model_matches_jax():
    """The scorer with each package's model behind it: the port's
    ``scorer_predict_fn`` against a predict fn over flax ``apply``."""
    jm, params, m = _models("float32")
    rng = np.random.default_rng(8)
    seq = _history("full", rng)

    predict = jax.jit(functools.partial(jp.predict_next_actions, jm))

    def jax_predict(a, b, v, ua):
        cands = jp.CandidateFeatures(jnp.asarray(a), jnp.asarray(b), jnp.asarray(v))
        return np.asarray(predict(params, ua, cands))

    class Q:
        pass

    got, want = _scorer_candidates(Candidate), _scorer_candidates(JCandidate)
    q, jq = Q(), Q()
    q.features = {"user_actions": phoenix.UserActionSequence(**{k: torch.from_numpy(v) for k, v in seq.items()})}
    jq.features = {"user_actions": jp.UserActionSequence(**{k: jnp.asarray(v) for k, v in seq.items()})}
    ps.PhoenixScorer(phoenix.scorer_predict_fn(m)).score(q, got, None)
    jps.PhoenixScorer(jax_predict).score(jq, want, None)
    for g, w in zip(got, want):
        assert sorted(g.features) == sorted(w.features)
        for k in g.features:
            np.testing.assert_allclose(g.features[k], w.features[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.score, w.score, rtol=RTOL, atol=ATOL)


def test_candidate_bool_features_match_jax():
    for c, jc in zip(_scorer_candidates(Candidate), _scorer_candidates(JCandidate)):
        np.testing.assert_array_equal(ps.candidate_bool_features(c), jps.candidate_bool_features(jc))
    assert [(h.name, tuple(int(a) for a in h.actions), h.weight, h.prod_feature) for h in ps.PHOENIX_HEADS] == [
        (h.name, tuple(int(a) for a in h.actions), h.weight, h.prod_feature) for h in jps.PHOENIX_HEADS]
    assert ps.MAX_CANDIDATES == jps.MAX_CANDIDATES == 1400


# -- the loop --------------------------------------------------------------------


def _loop(mod, Cand):
    """Serve → store → rescoring hydration → rerank, and the training join,
    on a fake clock: returns everything each step left behind."""
    clock = [0.0]
    store = mod.PhoenixScoreStore(ttl_s=100.0, now_fn=lambda: clock[0])
    se = mod.ScoredPhoenixCandidatesSideEffect(store)

    class Q:
        def __init__(self, uid, now):
            self.user_id, self.now, self.features = uid, now, {}

    rng = np.random.default_rng(9)
    for uid in range(3):
        served = [Cand(id=1000 * uid + i, score=0.5, features={
            "author_id": (uid + i) % 5, **({f"phoenix_{h}": float(rng.random()) for h in mod.HEAD_NAMES[:4]}
                                           if i % 3 else {}),
            **({"source_tweet_id": 1} if i == 4 else {})}) for i in range(6)]
        se.run(Q(uid, 100 + uid), served, None)
    log = [(r.user_id, r.tweet_id, r.author_id, r.served_ts, r.head_scores.tolist(), r.bool_features.tolist(),
            r.position) for r in se.log]
    fresh = [Cand(id=1001, score=1.0), Cand(id=1002, score=None), Cand(id=1003, score=2.0)]
    mod.PhoenixRescoringFeatureHydrator(store).hydrate(Q(1, 0), fresh, None)
    mod.PhoenixModelRerankingScorer(alpha=0.25).score(Q(1, 0), fresh, None)
    reranked = [(c.id, c.score, sorted(c.features.items())) for c in fresh]
    clock[0] = 150.0
    expired = store.get(1, 1001)

    engagements = {(r.user_id, r.tweet_id): [int(phoenix.ActionName.SERVER_TWEET_FAV), 5]
                   for r in se.log if r.tweet_id % 2 == 0}
    batches = mod.training_batch(se.log, engagements, lambda uid: uid, author_buckets=4, max_candidates=3)
    arrays = [(seq, [np.asarray(a) for a in cands], np.asarray(labels)) for seq, cands, labels in batches]
    return log, reranked, expired, len(store), arrays


def test_phoenix_loop_matches_jax():
    got, want = _loop(pl, Candidate), _loop(jpl, JCandidate)
    log, reranked, expired, n, arrays = got
    jlog, jreranked, jexpired, jn, jarrays = want
    assert log == jlog and n == jn and expired is None and jexpired is None
    assert [(i, f) for i, _, f in reranked] == [(i, f) for i, _, f in jreranked]
    for (_, s, _), (_, js, _) in zip(reranked, jreranked):
        np.testing.assert_allclose(s, js, rtol=SCORE_RTOL)
    assert len(arrays) == len(jarrays) == 3
    for (seq, cands, labels), (jseq, jcands, jlabels) in zip(arrays, jarrays):
        assert seq == jseq
        for a, b in zip(cands + [labels], jcands + [jlabels]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
