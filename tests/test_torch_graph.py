"""The port's engagement graphs (the_algorithm_tpu_torch/graph/{uteg,graphjet}.py)
against the JAX package's on the same numpy inputs.

Ring appends are exact. Ranked ids, their order (ties included) and the
social-proof / co-occurrence counts are exact: the seed weights are
multiples of 1/8 and the type weights of 1/4, so every score is summed
exactly in either order; the scores are compared at rtol 1e-6 all the same.
UTG scores are one f32 division and square root on both sides (rtol 1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.graph import graphjet as jg
from the_algorithm_tpu.graph import uteg as ju
from the_algorithm_tpu_torch.graph import graphjet, uteg

U, W, T_SPACE, WR = 64, 8, 120, 12  # users, left ring width, tweet ids, right ring width
NOW = 10_000
RTOL = 1e-6


def _events(seed, n, rows, vals_hi, hot_row=None):
    """n events; ``hot_row`` gets a burst of 2·W events inside the batch."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, n).astype(np.int32)
    if hot_row is not None:
        r[5 : 5 + 2 * W] = hot_row
    v = rng.integers(0, vals_hi, n).astype(np.int32)
    ty = rng.integers(0, 6, n).astype(np.int32)
    ts = np.sort(rng.integers(NOW - 5_000, NOW, n)).astype(np.int32)
    return r, v, ty, ts


def _np(tables):
    return [np.asarray(t) for t in tables]


@functools.lru_cache(maxsize=None)
def _worlds():
    """(jax left graph, jax right index, jax uug) fed two batches each, one
    user getting many events inside one batch."""
    left, right, uug = ju.init_graph(U, W), jg.init_right_index(T_SPACE, WR), jg.init_user_user(U, W)
    for b in range(2):
        u, t, ty, ts = _events(10 + b, 300, U, T_SPACE, hot_row=3)
        left = ju.record_engagements(left, u, t, ty, ts)
        right = jg.record_right(right, t, u, ts)
        su, du, ty2, ts2 = _events(20 + b, 200, U, U, hot_row=7)
        uug = jg.record_user_user(uug, su, du, ty2, ts2)
    return left, right, uug


def test_ring_appends_equal_the_per_event_loop():
    jl, jr_, juu = _worlds()
    left, right, uug = (uteg.init_graph(U, W, device="cpu"), graphjet.init_right_index(T_SPACE, WR, device="cpu"),
                        graphjet.init_user_user(U, W, device="cpu"))
    for b in range(2):
        u, t, ty, ts = _events(10 + b, 300, U, T_SPACE, hot_row=3)
        left = uteg.record_engagements(left, u, t, ty, ts)
        right = graphjet.record_right(right, t, u, ts)
        su, du, ty2, ts2 = _events(20 + b, 200, U, U, hot_row=7)
        uug = graphjet.record_user_user(uug, torch.from_numpy(su), du, ty2, ts2)  # a tensor of rows, too
    for got, want in ((left, jl), (right, jr_), (uug, juu)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ring_append_rows_index_as_numpy_does():
    tables = [np.full((5, 3), PAD_ID, np.int32)]
    want = ju.record_engagements(ju.EngagementGraph(*(jnp.asarray(tables[0]),) * 3), [-1, 4, -5], [7, 8, 9],
                                 [1, 1, 1], [1, 2, 3])
    got = uteg.record_engagements(uteg.EngagementGraph.from_numpy(*(tables[0],) * 3, device="cpu"), [-1, 4, -5],
                                  [7, 8, 9], [1, 1, 1], [1, 2, 3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(IndexError):
        uteg.record_engagements(got, [5], [1], [1], [1])


def _seeds(seed, R, S, rows):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, (R, S)).astype(np.int32)
    ids[0, -1] = PAD_ID
    ids[1, :3] = [-1, rows + 3, -(rows + 2)]  # read the rows JAX's gather reads
    ids[2, 1] = ids[2, 0]  # a repeated seed
    weights = (rng.integers(1, 9, (R, S)) / 8).astype(np.float32)
    return ids, weights


@functools.partial(jax.jit, static_argnames=("max_results", "min_social_proof", "exclude_types", "use_min_ts"))
def _jax_recommend(g, seeds, weights, tw, min_ts, *, max_results, min_social_proof, exclude_types, use_min_ts):
    return jax.vmap(lambda s, w: ju.recommend(
        g, s, w, max_results=max_results, type_weights=tw, min_social_proof=min_social_proof,
        exclude_types=exclude_types, min_timestamp=min_ts if use_min_ts else None))(seeds, weights)


UTEG_CASES = {
    "default": dict(max_results=40),
    "every slot kept": dict(max_results=1000),
    "min_timestamp": dict(max_results=30, min_timestamp=NOW - 2_500),
    "exclude_types": dict(max_results=30, exclude_types=(ju.EngagementType.CLICK, ju.EngagementType.QUOTE)),
    "min_social_proof": dict(max_results=30, min_social_proof=2),
    "type weights": dict(max_results=30, type_weights=np.asarray([0.25, 0.5, 1.0, 2.0, 0.75, 1.5], np.float32)),
    # engagement types outside [0, 6) read the type weight JAX's gather reads
    "out-of-range types": dict(max_results=30, type_weights=np.asarray([0.25, 0.5, 1.0, 2.0, 0.75, 1.5], np.float32),
                               bad_types=True),
}


@pytest.mark.parametrize("case", list(UTEG_CASES))
def test_uteg_recommend_matches_jax(case):
    kw = dict(UTEG_CASES[case])
    jl, _, _ = _worlds()
    if kw.pop("bad_types", False):
        types = np.asarray(jl.engagement_type).copy()
        types[:, 0], types[:, 1], types[:, 2] = -1, 6 + 3, -(6 + 2)
        jl = ju.EngagementGraph(jl.tweet_ids, jnp.asarray(types), jl.timestamps)
    seeds, weights = _seeds(1, 5, 6, U)
    tw = kw.pop("type_weights", ju.DEFAULT_TYPE_WEIGHTS)
    min_ts = kw.pop("min_timestamp", None)
    excl = tuple(int(e) for e in kw.pop("exclude_types", ()))
    want = _jax_recommend(jl, jnp.asarray(seeds), jnp.asarray(weights), jnp.asarray(tw), jnp.int32(min_ts or 0),
                          max_results=kw["max_results"], min_social_proof=kw.get("min_social_proof", 1),
                          exclude_types=excl, use_min_ts=min_ts is not None)
    g = uteg.EngagementGraph.from_numpy(*_np(jl), device="cpu")
    got = uteg.recommend(g, torch.from_numpy(seeds), torch.from_numpy(weights), type_weights=torch.from_numpy(tw),
                         min_timestamp=min_ts, exclude_types=excl, **kw)
    ids, scores, proof = (np.asarray(w) for w in want)
    assert got[0].shape == ids.shape
    np.testing.assert_array_equal(got[0].numpy(), ids)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=RTOL)
    np.testing.assert_array_equal(got[2].numpy(), proof)
    assert (ids != PAD_ID).sum(1).min() > 0


def test_uteg_ties_keep_jax_order():
    """Every weight 1: integer scores tie in bulk, k below the number of
    distinct ids, so the cut falls inside a tie."""
    jl, _, _ = _worlds()
    seeds, _ = _seeds(2, 4, 6, U)
    ones = np.ones(seeds.shape, np.float32)
    tw = np.ones(6, np.float32)
    want = _jax_recommend(jl, jnp.asarray(seeds), jnp.asarray(ones), jnp.asarray(tw), jnp.int32(0), max_results=7,
                          min_social_proof=1, exclude_types=(), use_min_ts=False)
    got = uteg.recommend(uteg.EngagementGraph.from_numpy(*_np(jl), device="cpu"), torch.from_numpy(seeds),
                         torch.from_numpy(ones), type_weights=torch.from_numpy(tw), max_results=7)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    s = np.asarray(want[1])
    assert (s[:, :-1] == s[:, 1:]).any()  # the case has ties


@functools.partial(jax.jit, static_argnames=("max_results", "min_cooccurrence", "use_min_ts", "use_mask"))
def _jax_related(left, right, src, min_ts, mask, *, max_results, min_cooccurrence, use_min_ts, use_mask):
    return jg.related_tweets_batch(left, right, src, max_results=max_results, min_cooccurrence=min_cooccurrence,
                                   min_timestamp=min_ts if use_min_ts else None,
                                   candidate_mask=mask if use_mask else None)


UTG_CASES = {
    "default": dict(max_results=25),
    "min_cooccurrence": dict(max_results=25, min_cooccurrence=2),
    "min_timestamp": dict(max_results=25, min_timestamp=NOW - 3_000),
    "candidate_mask": dict(max_results=25, candidate_mask=True),
}


@pytest.mark.parametrize("case", list(UTG_CASES))
def test_utg_related_tweets_matches_jax(case):
    kw = dict(UTG_CASES[case])
    jl, jr_, _ = _worlds()
    # a right-index user outside [0, U) reads the row JAX's gather reads
    user_ids = np.asarray(jr_.user_ids).copy()
    user_ids[5, 0], user_ids[9, 1] = U + 4, -3
    jr_ = jg.RightIndex(jnp.asarray(user_ids), jr_.timestamps)
    src = np.asarray([3, 5, 9, 40, -1, T_SPACE + 3, -(T_SPACE + 2), 77], np.int32)
    # a mask shorter than the tweet id space: ids past it read its last entry
    mask = np.random.default_rng(4).random(T_SPACE - 20) < 0.6
    min_ts = kw.pop("min_timestamp", None)
    use_mask = kw.pop("candidate_mask", False)
    want = _jax_related(jl, jr_, jnp.asarray(src), jnp.int32(min_ts or 0), jnp.asarray(mask),
                        max_results=kw["max_results"], min_cooccurrence=kw.get("min_cooccurrence", 1),
                        use_min_ts=min_ts is not None, use_mask=use_mask)
    left = uteg.EngagementGraph.from_numpy(*_np(jl), device="cpu")
    right = graphjet.RightIndex.from_numpy(*_np(jr_), device="cpu")
    got = graphjet.related_tweets(left, right, torch.from_numpy(src), min_timestamp=min_ts,
                                  candidate_mask=torch.from_numpy(mask) if use_mask else None, **kw)
    ids, scores, cooc = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), ids)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=RTOL)
    np.testing.assert_array_equal(got[2].numpy(), cooc)
    assert (ids != PAD_ID).sum() > 0


@functools.partial(jax.jit, static_argnames=("max_results", "min_social_proof", "use_min_ts"))
def _jax_users(g, seeds, weights, exclude, min_ts, *, max_results, min_social_proof, use_min_ts):
    return jax.vmap(lambda s, w, e: jg.recommend_users(
        g, s, w, max_results=max_results, exclude_ids=e, min_social_proof=min_social_proof,
        min_timestamp=min_ts if use_min_ts else None))(seeds, weights, exclude)


@pytest.mark.parametrize("min_social_proof,min_ts", [(1, None), (2, NOW - 2_500)])
def test_uug_recommend_users_matches_jax(min_social_proof, min_ts):
    _, _, juu = _worlds()
    seeds, weights = _seeds(3, 4, 5, U)
    exclude = np.random.default_rng(5).integers(0, U, (4, 6)).astype(np.int32)
    want = _jax_users(juu, jnp.asarray(seeds), jnp.asarray(weights), jnp.asarray(exclude), jnp.int32(min_ts or 0),
                      max_results=20, min_social_proof=min_social_proof, use_min_ts=min_ts is not None)
    got = graphjet.recommend_users(graphjet.UserUserGraph.from_numpy(*_np(juu), device="cpu"),
                                   torch.from_numpy(seeds), torch.from_numpy(weights), max_results=20,
                                   exclude_ids=torch.from_numpy(exclude), min_social_proof=min_social_proof,
                                   min_timestamp=min_ts)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_graph_entry_points_build_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: uteg.init_graph(4), lambda: graphjet.init_right_index(4), lambda: graphjet.init_user_user(4),
                  lambda: uteg.EngagementGraph.from_numpy(*np.zeros((3, 2, 2), np.int32)),
                  lambda: graphjet.RightIndex.from_numpy(*np.zeros((2, 2, 2), np.int32)),
                  lambda: graphjet.UserUserGraph.from_numpy(*np.zeros((3, 2, 2), np.int32))):
        with pytest.raises(RuntimeError, match="GPU"):
            build()
