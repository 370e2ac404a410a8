"""The port's earlybird device scan (the_algorithm_tpu_torch/search/earlybird.py)
against the JAX package's on the same numpy index and queries.

Masks, ring writes and facet counts are exact. Ranked ids, and their order
among equal scores, are exact. Scores: both packages work in float32 but
sum in another order, so they differ in the last bits: rtol 1e-5, atol 1e-5
(atol for scores near zero).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.search import earlybird as je
from the_algorithm_tpu_torch.search import earlybird as eb

T, L, F, VOCAB, AUTHORS = 512, 8, len(eb.DOC_FEATURES), 12, 24
RTOL = ATOL = 1e-5
IX = eb.DOC_FEATURE_INDEX


@functools.lru_cache(maxsize=None)
def corpus(seed=0):
    """A seeded index: a small vocabulary (terms recur, phrases occur),
    empty ring slots, timestamps in few seconds (recency ties), flag and
    count columns, a language column."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, (T, L)).astype(np.int32)
    doclen = rng.integers(2, L + 1, T)
    tokens[np.arange(L)[None, :] >= doclen[:, None]] = PAD_ID
    author = rng.integers(0, AUTHORS, T).astype(np.int32)
    author[rng.random(T) < 0.05] = PAD_ID  # empty slots
    created = rng.integers(900, 920, T).astype(np.int32)
    feats = rng.random((T, F)).astype(np.float32)
    for flag in ("is_reply", "is_retweet", "language_match", "has_image", "has_video", "is_sensitive_content"):
        feats[:, IX[flag]] = rng.random(T) < 0.3
    for count in ("fav_count", "retweet_count", "reply_count"):
        feats[:, IX[count]] = rng.integers(0, 200, T)
    feats[:, IX["tweet_language"]] = rng.integers(0, 4, T) + rng.random(T) * 0.9  # truncates to the id
    ids = (5_000 + rng.permutation(T)).astype(np.int32)
    return tokens, author, created, feats, ids


def indexes(seed=0):
    arrays = corpus(seed)
    return (je.EarlybirdIndex(*(jnp.asarray(a) for a in arrays), jnp.int32(0)),
            eb.EarlybirdIndex.from_numpy(*arrays, 0, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


RELEVANCE = dict(recency_weight=2.0, recency_half_life_s=7.0, reply_demotion=0.5, retweet_demotion=0.3,
                 language_boost=0.25, text_weight=1.5, bm25_k1=1.1, bm25_b=0.6, proximity_weight=0.7)


def relevance_pair(custom: bool):
    jrel = je.default_relevance_params()
    if custom:
        w = np.random.default_rng(3).normal(0, 1, F).astype(np.float32)
        jrel = je.RelevanceParams(jnp.asarray(w), **{k: jnp.float32(v) for k, v in RELEVANCE.items()})
    return jrel, eb.RelevanceParams.from_numpy(*(np.asarray(x) for x in jrel), device="cpu")


@pytest.mark.parametrize("custom", [False, True])
def test_linear_score_matches_jax(custom):
    jidx, idx = indexes()
    jrel, rel = relevance_pair(custom)
    want = je.linear_score(jidx.features, jrel, created_ts=jidx.created_ts, now=jnp.int32(915))
    _close(eb.linear_score(idx.features, rel, created_ts=idx.created_ts, now=915), want)
    _close(eb.linear_score(idx.features, rel), je.linear_score(jidx.features, jrel))


def _query_tokens(seed, Qt):
    q = np.random.default_rng(seed).integers(1, VOCAB, Qt).astype(np.int32)
    q[-1] = PAD_ID  # an unused slot
    return q


@pytest.mark.parametrize("Qt", [1, 4, 16])
def test_text_relevance_matches_jax_and_the_reference(Qt):
    jidx, idx = indexes()
    q = _query_tokens(Qt, Qt)
    live = np.asarray(corpus()[1]) != PAD_ID
    kw = dict(k1=1.1, b=0.6, proximity_weight=0.7)
    got = eb.text_relevance(idx.tokens, torch.from_numpy(q), torch.from_numpy(live), **kw)
    _close(got, je.text_relevance(jidx.tokens, jnp.asarray(q), jnp.asarray(live),
                                  **{k: jnp.float32(v) for k, v in kw.items()}))
    # the plain-Python oracle scores the live docs alone (its idf counts them)
    tokens = corpus()[0][live]
    docs = [[int(t) for t in row if t != PAD_ID] for row in tokens]
    terms = [int(t) for t in q if t != PAD_ID]
    if len(terms) == Qt:  # the oracle's pair mean runs over every query slot
        want = eb.text_relevance_reference(docs, terms, **kw)
        np.testing.assert_allclose(got.numpy()[live], want, rtol=RTOL, atol=ATOL)
    stats = eb.text_corpus_stats(idx.tokens, torch.from_numpy(q), torch.from_numpy(live))
    for g, w in zip(stats, je.text_corpus_stats(jidx.tokens, jnp.asarray(q), jnp.asarray(live))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(eb.text_relevance(idx.tokens, torch.from_numpy(q), torch.from_numpy(live), corpus_stats=stats, **kw), got)


def test_text_relevance_reference_is_the_jax_packages():
    docs, terms = [[1, 2, 3], [3, 2, 2, 5], [], [5, 1]], [2, 5, 1]
    np.testing.assert_array_equal(eb.text_relevance_reference(docs, terms), je.text_relevance_reference(docs, terms))


def test_phrase_match_matches_jax():
    jidx, idx = indexes()
    tokens = corpus()[0]
    d = int(np.flatnonzero((tokens != PAD_ID).all(1))[0])  # a doc of L tokens holds all three
    phrases = np.full((3, 4), PAD_ID, np.int32)
    phrases[0, :2] = tokens[d, 2:4]
    phrases[1, :3] = tokens[d, 4:7]  # reaches the doc's tail
    phrases[2, 0] = tokens[d, 0]  # one token
    for p in (phrases, phrases[:1], phrases[1:2, :3]):
        got = eb.phrase_match(idx.tokens, torch.from_numpy(p))
        want = np.asarray(je.phrase_match(jidx.tokens, jnp.asarray(p)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()


def _query_pair(**fields):
    """The same SearchQuery for both packages; array fields from numpy."""
    base = dict(tokens=np.asarray([3, 5, PAD_ID], np.int32), require_all=False, min_ts=0, max_ts=2**31 - 1)
    base.update(fields)
    jq = je.SearchQuery(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else
                               jnp.int32(v) if isinstance(v, int) and not isinstance(v, bool) else v)
                           for k, v in base.items()})
    q = eb.SearchQuery(**{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in base.items()})
    return jq, q


def _bound(col, value, fill):
    """Bounds unconstrained (``fill``) but on one column."""
    b = np.full(F, fill, np.float32)
    b[IX[col]] = value
    return b


_GROUPS = np.zeros((2, F), np.float32)
_GROUPS[0, [IX["has_image"], IX["has_video"]]] = 1.0  # row 1 stays empty: no constraint
MATCH_CASES = {
    "OR terms": dict(),
    "AND terms": dict(require_all=True),
    "no terms": dict(tokens=np.full(4, PAD_ID, np.int32)),
    "time window": dict(min_ts=905, max_ts=912),
    "id window": dict(min_id=5_100, max_id=5_400),
    "phrases": dict(phrases=np.asarray([[3, 5, PAD_ID], [PAD_ID] * 3], np.int32)),
    "exclude": dict(exclude_tokens=np.asarray([7, PAD_ID], np.int32)),
    "follows": dict(followed_authors=np.asarray([1, 4, 9, 17, PAD_ID, PAD_ID], np.int32)),
    "from authors": dict(from_authors=np.asarray([2, 4], np.int32)),
    "follows and from": dict(followed_authors=np.asarray([4, 9, 2], np.int32),
                             from_authors=np.asarray([2, 4], np.int32)),
    "feature floor": dict(feature_min_bounds=_bound("fav_count", 50.0, -np.inf)),
    "feature ceiling": dict(feature_max_bounds=_bound("is_sensitive_content", 0.5, np.inf)),
    "any-of groups": dict(feature_any_groups=_GROUPS),
    "lang": dict(lang_id=2),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_mask_matches_jax(case):
    jidx, idx = indexes()
    jq, q = _query_pair(**MATCH_CASES[case])
    ok, overlap = eb.match_mask(idx, q)
    jok, joverlap = je.match_mask(jidx, jq)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(overlap.numpy(), np.asarray(joverlap))
    assert 0 < int(ok.sum()) < T


def _same_ranking(got, want):
    ids, scores = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), ids)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=RTOL, atol=ATOL)
    return ids


@pytest.mark.parametrize("custom", [False, True])
def test_search_by_relevance_matches_jax(custom):
    jidx, idx = indexes()
    jrel, rel = relevance_pair(custom)
    jq, q = _query_pair(max_ts=915, exclude_tokens=np.asarray([7, PAD_ID], np.int32))
    extra = corpus()[3][:, IX["has_image"]] < 0.5
    want = je.search(jidx, jq, max_results=40, relevance=jrel, extra_mask=jnp.asarray(extra))
    ids = _same_ranking(eb.search(idx, q, max_results=40, relevance=rel, extra_mask=torch.from_numpy(extra)), want)
    assert (ids != PAD_ID).all()


def test_search_with_a_model_score_ties_keep_jax_order():
    """A model score of 0 leaves the text score alone: whole classes of docs
    tie, and the cut of the top 60 falls inside a tie."""
    jidx, idx = indexes()
    jq, q = _query_pair()
    want = je.search(jidx, jq, max_results=60, model_score_fn=lambda f: jnp.zeros(f.shape[0]))
    _same_ranking(eb.search(idx, q, max_results=60, model_score_fn=lambda f: torch.zeros(f.shape[0])), want)
    s = np.asarray(want[1])
    assert (s[:-1] == s[1:]).sum() > 20


@pytest.mark.parametrize("max_results", [25, 2 * T])
def test_search_by_recency_keeps_jax_tie_order(max_results):
    """Timestamps in 20 seconds: the ranking is mostly ties."""
    jidx, idx = indexes()
    jq, q = _query_pair(tokens=np.full(2, PAD_ID, np.int32), max_ts=915)
    want = je.search(jidx, jq, max_results=max_results, rank_by="recency")
    ids = _same_ranking(eb.search(idx, q, max_results=max_results, rank_by="recency"), want)
    assert (ids == PAD_ID).any() == (max_results > T // 2)


def test_search_in_network_batch_matches_jax():
    jidx, idx = indexes()
    rng = np.random.default_rng(9)
    follows = np.full((4, 10), PAD_ID, np.int32)
    for r in range(4):
        follows[r, : 3 + 2 * r] = np.sort(rng.choice(AUTHORS, 3 + 2 * r, replace=False))
    follows[3, 0] = PAD_ID  # a PAD first: follow lists need not be sorted
    kw = je.parse_query("from:follows")
    kw.pop("from_follows")
    jq = je.SearchQuery(require_all=True, min_ts=jnp.int32(0), max_ts=jnp.int32(915), **kw)
    q = eb.SearchQuery(require_all=True, min_ts=0, max_ts=915, tokens=torch.from_numpy(np.array(kw.pop("tokens"))),
                       **kw)  # the rest of the operator-free kwargs are None
    for custom in (False, True):
        jrel, rel = relevance_pair(custom)
        want = je.search_in_network_batch(jidx, jq, jnp.asarray(follows), max_results=80, relevance=jrel)
        ids = _same_ranking(eb.search_in_network_batch(idx, q, torch.from_numpy(follows), max_results=80,
                                                       relevance=rel), want)
        assert (ids[:, 0] != PAD_ID).all() and (ids == PAD_ID).any()


def test_facet_counts_match_jax():
    rng = np.random.default_rng(4)
    facets = rng.integers(0, 15, (200, 4)).astype(np.int32)
    facets[rng.random((200, 4)) < 0.3] = PAD_ID
    match = rng.random(200) < 0.7
    for k in (3, 10):
        got = eb.facet_counts(torch.from_numpy(facets), torch.from_numpy(match), k)
        want = je.facet_counts(jnp.asarray(facets), jnp.asarray(match), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ingest_matches_jax_through_the_ring():
    cfg = je.EarlybirdConfig(capacity=16, max_tokens=L)
    jidx = je.init_index(cfg)
    idx = eb.init_index(eb.EarlybirdConfig(capacity=16, max_tokens=L), device="cpu")
    arrays = corpus(1)
    for start, B in ((0, 5), (5, 9), (14, 16), (30, 3)):  # the third batch wraps, the fourth writes a whole ring
        batch = [a[start : start + B] for a in arrays]
        jidx = je.ingest(jidx, *(jnp.asarray(a) for a in batch))
        idx = eb.ingest(idx, *(torch.from_numpy(a) for a in batch))
        for g, w in zip(idx[:5], jidx[:5]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert idx.write_pos == int(jidx.write_pos)


def test_doc_feature_reader_matches_jax():
    jidx, idx = indexes()
    ids = np.asarray([5_003, 4, 5_511, 99_999], np.int32)
    got, want = eb.doc_feature_reader(idx)(ids), je.doc_feature_reader(jidx)(ids)
    assert list(got) == list(want)
    for n in got:
        np.testing.assert_array_equal(got[n], want[n])


def test_index_entry_points_build_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = corpus()
    for build in (lambda: eb.init_index(eb.EarlybirdConfig(capacity=4)),
                  lambda: eb.EarlybirdIndex.from_numpy(*arrays, 0),
                  lambda: eb.default_relevance_params(),
                  lambda: eb.RelevanceParams.from_numpy(np.zeros(F, np.float32))):
        with pytest.raises(RuntimeError, match="GPU"):
            build()
