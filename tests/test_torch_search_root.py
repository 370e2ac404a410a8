"""The port's SuperRoot (the_algorithm_tpu_torch/search/root.py) against the
JAX package's over the same two tiers: routing, the merged ranking (ids
exact, scores rtol 1e-5 / atol 1e-5 as in tests/test_torch_earlybird.py),
early termination and the pagination cursor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from the_algorithm_tpu.search import earlybird as je
from the_algorithm_tpu.search import root as jrt
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.search import root as rt

RTOL = ATOL = 1e-5


def _tier_pair(name, ids_ts, span, text="hello world"):
    tweets = [eb.RawTweet(tweet_id=i, author_id=1 + i % 3, created_ts=t, text=text, fav_count=i % 7)
              for i, t in ids_ts]
    docs = eb.build_documents(tweets, eb.EarlybirdConfig(capacity=16, max_tokens=8))
    jdocs = je.build_documents([je.RawTweet(**t.__dict__) for t in tweets],
                               je.EarlybirdConfig(capacity=16, max_tokens=8))
    jtier = jrt.Tier(name, je.ingest(je.init_index(je.EarlybirdConfig(capacity=16, max_tokens=8)), *jdocs[:5]),
                     *span)
    tier = rt.Tier(name, eb.ingest(eb.init_index(eb.EarlybirdConfig(capacity=16, max_tokens=8), device="cpu"),
                                   *docs[:5]), *span)
    return jtier, tier


# realtime holds tweets at equal timestamps (ties for the cursor) and one id
# that the archive holds too
TIERS = {
    "realtime": ([(100, 900), (101, 950), (102, 990), (103, 950), (104, 950), (52, 960)], (800, 1000)),
    "full_archive": ([(50, 100), (51, 200), (52, 700), (53, 700), (54, 650)], (0, 799)),
}


def _roots(config=rt.SuperRootConfig()):
    pairs = [_tier_pair(n, *v) for n, v in TIERS.items()]
    return (jrt.SuperRoot([j for j, _ in pairs], jrt.SuperRootConfig(**config.__dict__)),
            rt.SuperRoot([t for _, t in pairs], config))


def _queries(min_ts=0, max_ts=1000, text="hello"):
    tokens = eb.tokenize(text, 8)
    return (je.SearchQuery(tokens=jnp.asarray(tokens), require_all=False, min_ts=jnp.int32(min_ts),
                           max_ts=jnp.int32(max_ts)),
            eb.SearchQuery(tokens=torch.from_numpy(tokens), require_all=False, min_ts=min_ts, max_ts=max_ts))


@pytest.mark.parametrize("window", [(0, 1000), (850, 1000), (0, 300)])
def test_route_matches(window):
    jroot, root = _roots()
    jq, q = _queries(*window)
    assert [t.name for t in root.route(q)] == [t.name for t in jroot.route(jq)]


@pytest.mark.parametrize("config,max_results", [(rt.SuperRootConfig(), 10), (rt.SuperRootConfig(), 3),
                                                (rt.SuperRootConfig(min_full_results=2), 2),
                                                (rt.SuperRootConfig(min_full_results=100), 4),
                                                (rt.SuperRootConfig(max_tiers=1), 10)])
def test_search_merges_like_jax(config, max_results):
    jroot, root = _roots(config)
    jq, q = _queries()
    ids, scores, per = root.search(q, max_results=max_results)
    jids, jscores, jper = jroot.search(jq, max_results=max_results)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, jscores, rtol=RTOL, atol=ATOL)
    assert [r.tier for r in per] == [r.tier for r in jper]
    for r, jr in zip(per, jper):
        np.testing.assert_array_equal(r.ids, jr.ids)


@pytest.mark.parametrize("page_size", [1, 2, 4])
def test_paginate_matches(page_size):
    jroot, root = _roots()
    jq, q = _queries()
    pages = list(root.paginate(q, page_size=page_size, max_pages=10))
    jpages = list(jroot.paginate(jq, page_size=page_size, max_pages=10))
    assert len(pages) == len(jpages) > 1
    for (ids, scores), (jids, jscores) in zip(pages, jpages):
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=RTOL, atol=ATOL)


def test_a_partitioned_tier_is_refused_not_scanned_unsharded(monkeypatch):
    """A tier with a mesh goes through the partition fan-out (``search_sharded``,
    held to JAX's in tests/test_torch_sharded_search.py), never the
    single-index scan."""
    _, tier = _tier_pair("sharded", [(1, 10)], (0, 100))
    tier.mesh = object()
    _, q = _queries(0, 100)
    seen = []

    def partitioned(mesh, index, query, *, max_results, **kw):
        seen.append(mesh)
        return eb.search(index, query, max_results=max_results, **kw)

    monkeypatch.setattr(eb, "search_sharded", partitioned)
    ids, _, _ = rt.SuperRoot([tier]).search(q, max_results=4)
    assert seen == [tier.mesh] and ids.tolist() == [1]
