"""The port's timeline ranker and topic social proof
(the_algorithm_tpu_torch/mixers/{timeline_ranker, topic_social_proof}.py)
against the JAX package's.

Tolerances: both timeline-ranker forms on one seeded earlybird index (256
docs) and UTEG graph: the recap stream's ids equal but among near-ties and
its scores at rtol/atol 1e-5 (f32 relevance sums in another order, as
tests/test_torch_earlybird.py holds them), the recycled stream's ids and
scores equal at rtol 1e-6. TSPS single and batch forms with every gate:
topic ids exactly, relevance rtol 1e-6, followed masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID, assert_same_topk

from the_algorithm_tpu.graph import uteg as juteg
from the_algorithm_tpu.mixers import timeline_ranker as jtlr
from the_algorithm_tpu.mixers import topic_social_proof as jtsps
from the_algorithm_tpu.ops.sparse import SparseEmbedding as JSparse
from the_algorithm_tpu.search import earlybird as jeb
from the_algorithm_tpu.search import root as jroot
from the_algorithm_tpu_torch.graph import uteg
from the_algorithm_tpu_torch.mixers import timeline_ranker as tlr
from the_algorithm_tpu_torch.mixers import topic_social_proof as tsps
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.search import root

P = int(PAD_ID)
T, L, AUTHORS = 256, 4, 16


def _world(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 50, (T, L)).astype(np.int32)
    authors = (np.arange(T) % AUTHORS).astype(np.int32)
    ts = rng.integers(0, 1000, T).astype(np.int32)
    feats = rng.random((T, len(jeb.DOC_FEATURES))).astype(np.float32)
    ids = np.arange(5000, 5000 + T, dtype=np.int32)
    ev = 160
    users = rng.integers(0, 32, ev).astype(np.int32)
    tweets = rng.integers(0, 64, ev).astype(np.int32)
    types = rng.integers(0, 6, ev).astype(np.int32)
    ev_ts = np.sort(rng.integers(0, 1000, ev)).astype(np.int32)
    cfg = dict(capacity=T, max_tokens=L)
    jindex = jeb.ingest(jeb.init_index(jeb.EarlybirdConfig(**cfg)), *(jnp.asarray(a) for a in
                                                                       (tokens, authors, ts, feats, ids)))
    index = eb.ingest(eb.init_index(eb.EarlybirdConfig(**cfg), device="cpu"),
                      *(torch.from_numpy(a) for a in (tokens, authors, ts, feats, ids)))
    jg = juteg.record_engagements(juteg.init_graph(32, width=8), users, tweets, types, ev_ts)
    g = uteg.record_engagements(uteg.init_graph(32, width=8, device="cpu"), users, tweets, types, ev_ts)
    return jindex, index, jg, g


# follow lists of one length: JAX's eager search compiles once per shape
CASES = [([1, 5, 9, 14], [1.0, 0.5, 0.25, 2.0], 100, 900), ([3, 4, 7, 8], [1.0, 1.0, 1.0, 1.0], 0, 1000),
         ([0, 2, 6, 10], [0.5, 0.5, 2.0, 1.0], 500, 700)]


def _same(got, want):
    assert_same_topk(got.in_network_ids[None], got.in_network_scores[None], np.asarray(want.in_network_ids)[None],
                     np.asarray(want.in_network_scores)[None], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.oon_ids, np.asarray(want.oon_ids))
    np.testing.assert_allclose(got.oon_scores, np.asarray(want.oon_scores), rtol=1e-6)
    assert isinstance(got.in_network_ids, np.ndarray) and isinstance(got.oon_ids, np.ndarray)


def test_ranked_timeline_matches_jax():
    jindex, index, jg, g = _world()
    cfg, jcfg = tlr.TimelineRankerConfig(max_in_network=40, max_out_of_network=20), \
        jtlr.TimelineRankerConfig(max_in_network=40, max_out_of_network=20)
    for follows, weights, lo, hi in CASES:
        kw = dict(followed_authors=follows, seed_weights=weights, min_ts=lo, max_ts=hi)
        got = tlr.get_ranked_timeline(index, g, config=cfg, **kw)
        want = jtlr.get_ranked_timeline(jindex, jg, config=jcfg, **kw)
        _same(got, want)
        assert (got.in_network_ids != P).sum() > 0
        authors = {5000 + i: i % AUTHORS for i in range(T)}
        assert all(authors[int(i)] in follows for i in got.in_network_ids if i != P)


def test_ranked_timeline_multitier_matches_jax():
    _, _, jg, g = _world()

    def tiers(port):
        pkg, rpkg = (eb, root) if port else (jeb, jroot)
        out = []
        for name, docs, span in (("realtime", [(10, 900, 5), (11, 950, 5), (12, 990, 6)], (800, 1000)),
                                 ("archive", [(5, 100, 5), (6, 200, 7), (11, 700, 5)], (0, 799))):
            tweets = [pkg.RawTweet(tweet_id=i, author_id=a, created_ts=t, text="x", fav_count=i % 3)
                      for i, t, a in docs]
            cfg = pkg.EarlybirdConfig(capacity=8, max_tokens=4)
            idx = pkg.init_index(cfg, device="cpu") if port else pkg.init_index(cfg)
            out.append(rpkg.Tier(name, pkg.ingest(idx, *pkg.build_documents(tweets, cfg)[:5]), *span))
        return rpkg.SuperRoot(out, rpkg.SuperRootConfig(min_full_results=100))

    kw = dict(followed_authors=[5, 7], seed_weights=[1.0, 0.5], min_ts=0, max_ts=1000)
    got = tlr.get_ranked_timeline_multitier(tiers(True), g, **kw)
    want = jtlr.get_ranked_timeline_multitier(tiers(False), jg, **kw)
    _same(got, want)
    assert set(got.in_network_ids.tolist()) == {10, 11, 5, 6}  # both tiers, 11 deduped, author 6 not followed


def _embs(rng, n, K, ids_hi):
    ids = np.full((n, K), P, np.int32)
    sc = np.zeros((n, K), np.float32)
    for r in range(n):
        k = int(rng.integers(1, K + 1))
        ids[r, :k] = np.sort(rng.choice(ids_hi, k, False))
        sc[r, :k] = rng.random(k) + 0.05
    ids[-1], sc[-1] = P, 0.0  # an empty embedding
    return ids, sc


@pytest.mark.parametrize("gates", [{}, {"followed": True}, {"not_interested": True}, {"allowed": True},
                                   {"quality": True}, {"followed": True, "not_interested": True, "allowed": True,
                                                       "quality": True}])
def test_topic_social_proof_matches_jax(gates):
    rng = np.random.default_rng(len(gates))
    K, NT, B = 4, 24, 6
    ti, tsc = _embs(rng, NT, K, 12)
    wi, wsc = _embs(rng, B, K, 12)
    kw, jkw = {}, {}
    cfg = dict(min_relevance=0.1, max_topics_per_tweet=5)
    if gates.get("followed"):
        f = np.asarray([0, 3, 7, P], np.int32)
        kw["followed_topics"], jkw["followed_topics"] = torch.from_numpy(f), jnp.asarray(f)
    if gates.get("not_interested"):
        n = np.asarray([1, 2, 20], np.int32)
        kw["not_interested_topics"], jkw["not_interested_topics"] = torch.from_numpy(n), jnp.asarray(n)
    batch_kw, jbatch_kw = dict(kw), dict(jkw)
    if gates.get("allowed"):
        a = rng.random(NT) < 0.7
        batch_kw["topic_allowed"], jbatch_kw["topic_allowed"] = torch.from_numpy(a), jnp.asarray(a)
    if gates.get("quality"):
        q = rng.random(NT).astype(np.float32)
        batch_kw.update(quality_scores=torch.from_numpy(q), min_quality=0.3)
        jbatch_kw.update(quality_scores=jnp.asarray(q), min_quality=0.3)
    topics, jtopics = SparseEmbedding(torch.from_numpy(ti), torch.from_numpy(tsc)), JSparse(jnp.asarray(ti),
                                                                                             jnp.asarray(tsc))
    got = tsps.topic_social_proof_batch(SparseEmbedding(torch.from_numpy(wi), torch.from_numpy(wsc)), topics,
                                        config=tsps.TopicSocialProofConfig(**cfg), **batch_kw)
    want = jtsps.topic_social_proof_batch(JSparse(jnp.asarray(wi), jnp.asarray(wsc)), jtopics,
                                          config=jtsps.TopicSocialProofConfig(**cfg), **jbatch_kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for b in range(B):
        one = tsps.topic_social_proof(SparseEmbedding(torch.from_numpy(wi[b]), torch.from_numpy(wsc[b])), topics,
                                      config=tsps.TopicSocialProofConfig(**cfg), **kw)
        jone = jtsps.topic_social_proof(JSparse(jnp.asarray(wi[b]), jnp.asarray(wsc[b])), jtopics,
                                        config=jtsps.TopicSocialProofConfig(**cfg), **jkw)
        for x, y in zip(one, jone):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
        if not batch_kw.keys() - kw.keys():  # no batch-only gate: the batch row is the single form
            for x, y in zip(one, got):
                np.testing.assert_array_equal(x.numpy(), y[b].numpy())


def test_tsps_chunks_give_the_same_answer(monkeypatch):
    rng = np.random.default_rng(9)
    ti, tsc = _embs(rng, 40, 5, 16)
    wi, wsc = _embs(rng, 33, 5, 16)
    args = (SparseEmbedding(torch.from_numpy(wi), torch.from_numpy(wsc)),
            SparseEmbedding(torch.from_numpy(ti), torch.from_numpy(tsc)))
    whole = tsps.topic_social_proof_batch(*args)
    monkeypatch.setattr(tsps, "TSPS_CHUNK_BYTES", 40 * 5 * 5 * 4 * 4)  # 4 tweets a chunk
    for x, y in zip(tsps.topic_social_proof_batch(*args), whole):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
