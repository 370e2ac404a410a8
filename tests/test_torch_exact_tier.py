"""The port's exact retrieval tier against the JAX package's: the
full-corpus scan in f32 and bf16 (``ops/retrieval.exact_cosine_scan``),
``ExactScanBatchSource`` and ``TieredSannBatchSource`` through a small
``BatchedForYouEngine``, and the host copies of ``Decider`` and ``Param``.

Tolerances: scan scores at rtol 1e-5, atol 1e-6. Both sides sum K f32
products per corpus row in another order (in bf16 the inputs are rounded
alike and their products are exact in f32), so ids are equal except where
neighbouring scores lie within that tolerance: compared as score-aligned
sets, with at least 95% of the slots holding the same id. Engine lists:
ranked ids exactly, scores and features at rtol 1e-5 (the model's f32 sums),
as in test_torch_batched_foryou.py. Decider decisions are exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batched_foryou import HEADS, _setup, assert_same_lists, fixed_source, lift, query
from torch_port_util import PAD_ID, assert_same_topk

from the_algorithm_tpu.core import config as jconfig
from the_algorithm_tpu.core import decider as jdecider
from the_algorithm_tpu.mixers import batched_foryou as jbf
from the_algorithm_tpu.mixers import home_mixer as jhm
from the_algorithm_tpu.mixers import home_products as jhp
from the_algorithm_tpu.ops import retrieval as jr
from the_algorithm_tpu.ops import sparse as js
from the_algorithm_tpu_torch.core import config
from the_algorithm_tpu_torch.core.decider import Decider
from the_algorithm_tpu_torch.mixers import batched_foryou as bf
from the_algorithm_tpu_torch.mixers import home_mixer as hm
from the_algorithm_tpu_torch.mixers.home_products import EXACT_RETRIEVAL_TIER
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding

C, K, BLOCK, T = 300, 8, 1024, 2048  # two blocks
N, USERS = 12, 32  # query embedding slots, users with an embedding
X = 64
RTOL, ATOL = 1e-5, 1e-6
SAME_SLOTS = 0.95
MODES = {"f32": dict(compute_dtype=torch.float32), "bf16": dict(compute_dtype=torch.bfloat16),
         "turbo": dict(compute_dtype=torch.bfloat16, approx_block_topk=True)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def _corpus():
    """[T, K] corpus (PAD rows and slots among them) and [USERS, N] query
    embeddings, score-descending."""
    rng = np.random.default_rng(11)
    ids = np.stack([rng.choice(C, K, replace=False) for _ in range(T)]).astype(np.int32)
    scores = rng.uniform(0.05, 1.0, (T, K)).astype(np.float32)
    ids[-40:] = PAD_ID
    scores[-40:] = 0
    ids[100, 5:] = PAD_ID
    scores[100, 5:] = 0
    q_ids = np.stack([rng.choice(C, N, replace=False) for _ in range(USERS)]).astype(np.int32)
    q_scores = -np.sort(-rng.uniform(0.05, 1.0, (USERS, N)), axis=1).astype(np.float32)
    q_ids[4, 9:] = PAD_ID
    q_scores[4, 9:] = 0
    return ids, scores, q_ids, q_scores


def _assert_same_scan(got, want):
    rows, scores = (np.asarray(a) for a in got)
    want_rows, want_scores = (np.asarray(a) for a in want)
    assert rows.shape == want_rows.shape
    assert_same_topk(np.where(rows < 0, PAD_ID, rows), scores, np.where(want_rows < 0, PAD_ID, want_rows),
                     want_scores, rtol=RTOL, atol=ATOL)
    assert (rows == want_rows).mean() >= SAME_SLOTS


def _jax_scan(q, mode):
    kw = MODES[mode]
    ids, scores, q_ids, q_scores = _corpus()
    return jr.exact_cosine_scan(
        jnp.asarray(ids), jnp.asarray(scores), js.SparseEmbedding(jnp.asarray(q_ids[:q]), jnp.asarray(q_scores[:q])),
        num_clusters=C, max_results=X, block=BLOCK, compute_dtype=JAX_DTYPE[kw["compute_dtype"]],
        approx_block_topk=kw.get("approx_block_topk", False))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("q", [1, 3, 8])
def test_exact_scan_matches_jax(q, mode):
    ids, scores, q_ids, q_scores = _corpus()
    got = retrieval.exact_cosine_scan(
        torch.from_numpy(ids), torch.from_numpy(scores),
        SparseEmbedding(torch.from_numpy(q_ids[:q]), torch.from_numpy(q_scores[:q])),
        num_clusters=C, max_results=X, block=BLOCK, **MODES[mode])
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    _assert_same_scan(got, _jax_scan(q, mode))


def test_bf16_scan_scores_are_not_rounded_to_bf16():
    """The K-sum runs in f32: the bf16 scan's scores carry more than bf16's
    8 mantissa bits, and differ from the f32 scan's only by the inputs'
    rounding."""
    ids, scores, q_ids, q_scores = _corpus()
    args = (torch.from_numpy(ids), torch.from_numpy(scores),
            SparseEmbedding(torch.from_numpy(q_ids[:8]), torch.from_numpy(q_scores[:8])))
    _, s16 = retrieval.exact_cosine_scan(*args, num_clusters=C, max_results=X, block=BLOCK,
                                         compute_dtype=torch.bfloat16)
    _, s32 = retrieval.exact_cosine_scan(*args, num_clusters=C, max_results=X, block=BLOCK)
    assert not torch.equal(s16, s16.to(torch.bfloat16).float())
    np.testing.assert_allclose(s16.numpy(), s32.numpy(), rtol=2e-2)


def _emb_fn(uid):
    _, _, q_ids, q_scores = _corpus()
    return q_ids[uid % USERS], q_scores[uid % USERS]


ROW_TO_ID = (5000 + 3 * np.arange(T)).astype(np.int64)


def _exact_sources(turbo):
    ids, scores, _, _ = _corpus()
    kw = dict(num_clusters=C, max_results=40, row_to_id=ROW_TO_ID, block=BLOCK, turbo=turbo)
    return (jbf.ExactScanBatchSource(jnp.asarray(ids), jnp.asarray(scores), _emb_fn, **kw),
            bf.ExactScanBatchSource(torch.from_numpy(ids), torch.from_numpy(scores), _emb_fn, **kw))


@pytest.mark.parametrize("turbo", [False, True], ids=["f32", "turbo"])
def test_exact_scan_source_matches_jax(turbo):
    """Three queries scan as four (copies of the first); three lists come back."""
    jsrc, src = _exact_sources(turbo)
    users = (2, 9, 30)
    got = src.get_batch([query(hm, u) for u in users], None)
    want = jsrc.get_batch([query(jhm, u) for u in users], None)
    assert len(got) == len(want) == 3
    packed, n = src.dispatch([query(hm, u) for u in users], None)
    assert n == 3 and tuple(packed.shape) == (4, 40, 2)
    for g, w in zip(got, want):
        assert 0 < len(g) == len(w) <= 40 and set(g.ids) <= set(ROW_TO_ID)
        ids = np.full((1, 40), PAD_ID, np.int64)
        ids[0, :len(g)] = g.ids
        want_ids = np.full((1, 40), PAD_ID, np.int64)
        want_ids[0, :len(w)] = w.ids
        assert_same_topk(ids, np.pad(g.scores, (0, 40 - len(g)))[None], want_ids,
                         np.pad(w.scores, (0, 40 - len(w)))[None], rtol=RTOL, atol=ATOL)


def _tier_engines(availability, turbo=False):
    """Both packages' engines with the tiered SANN leg (fixed approximate
    rows, the exact scan over the small corpus) and two fixed legs."""
    s = _setup()
    jexact, exact = _exact_sources(turbo)
    out = []
    for name, pkg, ex, dec in (("jax", jbf, jexact, jdecider.Decider), ("torch", bf, exact, Decider)):
        tiered = pkg.TieredSannBatchSource(fixed_source(pkg, "simclusters_interested_in", 100, 40), ex,
                                           dec({"exact_retrieval_tier": availability}))
        sources = [tiered, fixed_source(pkg, "EarlybirdInNetwork", 120, 30), fixed_source(pkg, "DirectUteg", 140, 20)]
        out.append(pkg.BatchedForYouEngine(batch_sources=sources, scorer=s[name][None], head_names=HEADS,
                                           lift=lift(pkg), max_age_s=10 ** 9))
    return out


USERS_SERVED = (2, 7, 11, 19, 25)


def _in_tier(users, availability):
    d = Decider({"exact_retrieval_tier": availability})
    return [d.is_available_for_id("exact_retrieval_tier", u) for u in users]


@pytest.mark.parametrize("turbo", [False, True], ids=["f32", "turbo"])
def test_tiered_engine_with_sticky_routing_matches_jax(turbo):
    jeng, eng = _tier_engines(5000, turbo)
    tiers = _in_tier(USERS_SERVED, 5000)
    assert any(tiers) and not all(tiers)  # both legs serve this batch
    got = eng.serve_batch([query(hm, u) for u in USERS_SERVED])
    assert_same_lists(got, jeng.serve_batch([query(jhm, u) for u in USERS_SERVED]))
    merged, _ = eng.columns([query(hm, u) for u in USERS_SERVED])
    for c, in_tier in zip(merged, tiers):
        from_tier = np.isin(c.ids, ROW_TO_ID)
        assert from_tier.any() == in_tier
        np.testing.assert_array_equal(c.cols.get("exact_tier", np.zeros(len(c)))[from_tier], 1.0)
        assert not np.asarray(c.cols.get("exact_tier", np.zeros(len(c))))[~from_tier].any()


@pytest.mark.parametrize("forced", [True, False])
def test_param_override_routes_as_jax(forced):
    """EXACT_RETRIEVAL_TIER in the request's params, and as an ambient
    param_scope layer over empty params, overrides the decider."""
    jeng, eng = _tier_engines(5000)
    qs = [query(hm, u) for u in USERS_SERVED]
    jqs = [query(jhm, u) for u in USERS_SERVED]
    got = eng.serve_batch(qs, config.Params({EXACT_RETRIEVAL_TIER: forced}))
    assert_same_lists(got, jeng.serve_batch(jqs, jconfig.Params({jhp.EXACT_RETRIEVAL_TIER: forced})))
    with config.param_scope({EXACT_RETRIEVAL_TIER: forced}):
        merged, _ = eng.columns(qs, config.Params())
        scoped = eng.serve_batch(qs, config.Params())
    assert [[c.id for c in o] for o in scoped] == [[c.id for c in o] for o in got]
    for c in merged:
        assert np.isin(c.ids, ROW_TO_ID).any() == forced
    # params=None: the decider alone (the JAX package reads no param then)
    with config.param_scope({EXACT_RETRIEVAL_TIER: forced}):
        merged, _ = eng.columns(qs, None)
    assert [np.isin(c.ids, ROW_TO_ID).any() for c in merged] == _in_tier(USERS_SERVED, 5000)


@pytest.mark.parametrize("availability", [0, 3000, 8000])
def test_decider_matches_jax_for_10000_ids(availability):
    got = Decider({"exact_retrieval_tier": availability})
    want = jdecider.Decider({"exact_retrieval_tier": availability})
    ids = range(-5, 9995)
    decisions = [got.is_available_for_id("exact_retrieval_tier", i) for i in ids]
    assert decisions == [want.is_available_for_id("exact_retrieval_tier", i) for i in ids]
    share = np.mean(decisions)
    assert abs(share - availability / 10000) < 0.02


def test_decider_dials_match_jax():
    got, want = Decider(), jdecider.Decider()
    for value in (-3, 0, 4200, 10000, 12000):
        got.set_availability("f", value)
        want.set_availability("f", value)
        assert got.availability("f") == want.availability("f")
    assert got.availability("unset") == want.availability("unset") == 0
    assert got.is_available("f") and not got.is_available("unset")


def test_params_resolve_as_jax():
    """Explicit overrides > ambient param_scope layers (innermost wins) >
    default; bounded params clamp; keys by Param or by name."""
    bounded = (config.Param("k", 5, lo=1, hi=10), jconfig.Param("k", 5, lo=1, hi=10))
    flag = (config.Param("f", None), jconfig.Param("f", None))
    results = []
    for i, mod in enumerate((config, jconfig)):
        b, f = bounded[i], flag[i]
        p = mod.Params({b: 40})
        row = [p(b), p(f), mod.Params()(b), mod.Params({"k": -2})(b), p.with_overrides({"f": True})(f),
               dict(p.with_overrides({f: 3}).overrides())]
        with mod.param_scope({b: 7, f: False}):
            row += [mod.Params()(b), mod.Params()(f), p(b)]
            with mod.param_scope({"k": 0}):
                row += [mod.Params()(b), mod.Params()(f)]
            row += [mod.Params()(b)]
        row += [mod.EMPTY_PARAMS(b), mod.EMPTY_PARAMS(f)]
        results.append(row)
    assert results[0] == results[1]
    assert results[0][:3] == [10, None, 5]
