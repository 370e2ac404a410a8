"""The port's earlybird ingester and persistence (``search/ingester.py``,
``search/persistence.py``) against the JAX package's, on the same writes:
every index column after the write service's fanout bit-equal, engagement
increments, deletes and feature updates with JAX's slot rules, the author
mask and a masked search, snapshots across the packages (fault 3), replay,
roll-off and the query cache."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PAD_ID

from the_algorithm_tpu.actions import uua as juua
from the_algorithm_tpu.search import earlybird as jeb
from the_algorithm_tpu.search import ingester as jing
from the_algorithm_tpu.search import persistence as jpers
from the_algorithm_tpu.storage import tweetypie as jtp
from the_algorithm_tpu_torch.actions import uua
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.search import ingester as ing
from the_algorithm_tpu_torch.search import persistence as pers
from the_algorithm_tpu_torch.storage import tweetypie as tp

CAP, L = 32, 8
SIDES = ((tp, eb, ing, uua, {"device": "cpu"}), (jtp, jeb, jing, juua, {}))


def _columns(index):
    return [np.asarray(index.tokens), np.asarray(index.author), np.asarray(index.created_ts),
            np.asarray(index.features), np.asarray(index.tweet_ids), int(index.write_pos)]


def _same(a, b):
    for x, y in zip(_columns(a)[:5], _columns(b)[:5]):
        np.testing.assert_array_equal(x, y)
    assert int(a.write_pos) == int(b.write_pos)


def _session(pkg, eb_pkg, ing_pkg, uua_pkg, kw):
    """The write service wired to an ingester: posts past the ring's length
    (so the ring wraps), an edit, deletes, an undelete, engagements and
    author updates. Returns the ingester and its index after each step."""
    svc = pkg.TweetWriteService()
    g = ing_pkg.EarlybirdIngester(eb_pkg.EarlybirdConfig(capacity=CAP, max_tokens=L), store=svc.store, **kw)
    pkg.ingester_fanout(svc, g)
    steps, posted = [], []
    rng = np.random.default_rng(4)
    for i in range(CAP + 8):
        reply = posted[int(rng.integers(len(posted)))] if posted and i % 3 == 0 else None
        t = svc.post_tweet(int(rng.integers(1, 9)), f"tweet {i} about #topic{i % 4} https://t.co/{i}",
                           now=1000 + i, reply_to=reply, media=("p.jpg",) if i % 5 == 0 else ())
        posted.append(t.tweet_id)
    steps.append(g.index)
    svc.edit_tweet(posted[-1], "edited text", now=1100)
    svc.delete_tweet(posted[-2])
    svc.delete_tweet(posted[-3])
    svc.undelete_tweet(posted[-3])
    steps.append(g.index)
    A = uua_pkg.ActionType
    kinds = [A.CLIENT_TWEET_FAV, A.SERVER_TWEET_FAV, A.CLIENT_TWEET_UNFAV, A.SERVER_TWEET_RETWEET,
             A.CLIENT_TWEET_REPLY, A.SERVER_TWEET_QUOTE, A.CLIENT_PROFILE_VISIT]
    actions = [uua_pkg.UnifiedUserAction(user_id=u, action_type=kinds[u % len(kinds)],
                                         item_id=posted[int(rng.integers(len(posted)))] if u % 9 else 77, timestamp_ms=0)
               for u in range(200)]
    n = g.apply_engagements(actions)
    steps.append(g.index)
    g.apply_user_updates({3: ing_pkg.AuthorState.SUSPENDED, 5: ing_pkg.AuthorState.PROTECTED})
    g.apply_user_updates({5: ing_pkg.AuthorState.NORMAL})
    return g, steps, n, posted


def test_fanout_index_matches_jax_column_by_column():
    (g, steps, n, _), (jg, jsteps, jn, _) = (_session(*s) for s in SIDES)
    for a, b in zip(steps, jsteps):
        _same(a, b)
    assert n == jn and g.log_offset == jg.log_offset
    np.testing.assert_array_equal(g.visible_author_mask().numpy(), np.asarray(jg.visible_author_mask()))
    assert not g.visible_author_mask().all()


def test_masked_search_matches_jax():
    (g, *_), (jg, *_) = (_session(*s) for s in SIDES)
    toks = eb.tokenize("tweet topic1", L)
    q = eb.SearchQuery(tokens=torch.from_numpy(toks), require_all=False, min_ts=0, max_ts=5000)
    jq = jeb.SearchQuery(tokens=jnp.asarray(toks), require_all=False, min_ts=jnp.int32(0), max_ts=jnp.int32(5000))
    for kw in ({}, {"rank_by": "recency"}):
        ids, scores = g.search(q, max_results=16, **kw)
        jids, jscores = jg.search(jq, max_results=16, **kw)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert (ids != PAD_ID).sum() > 2
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-5)
        authors = dict(zip(g.index.tweet_ids.tolist(), g.index.author.tolist()))
        assert all(authors[int(i)] != 3 for i in ids.tolist() if i != PAD_ID)  # no suspended author served


def _ring_with_a_repeat():
    """A [16]-slot index holding ids 500..507, with 503 again at slot 9."""
    out = []
    for pkg, np_or_jnp, kw in ((eb, torch.from_numpy, {"device": "cpu"}), (jeb, jnp.asarray, {})):
        cfg = pkg.EarlybirdConfig(capacity=16, max_tokens=4)
        B = 10
        ids = np.r_[np.arange(500, 508), 900, 503].astype(np.int32)
        tokens = np.full((B, 4), PAD_ID, np.int32)
        feats = np.arange(B * cfg.num_features, dtype=np.float32).reshape(B, -1)
        out.append(pkg.ingest(pkg.init_index(cfg, **kw), *(np_or_jnp(a) for a in (
            tokens, np.arange(B, dtype=np.int32), np.arange(B, dtype=np.int32) + 1000, feats, ids))))
    return out


def test_feature_updates_follow_jax_slot_rules():
    index, jindex = _ring_with_a_repeat()
    ids = np.asarray([503, 501, 12345, 501, 900, 503], np.int32)  # a repeat in the ring, a miss, repeats in the batch
    cols = np.asarray([0, 1, 2, 1, 3, 0], np.int32)
    vals = np.asarray([1.5, 2.0, 9.0, 4.0, -1.0, 0.25], np.float32)
    got = pers.increment_feature(index, torch.from_numpy(ids), torch.from_numpy(cols), torch.from_numpy(vals))
    want = jpers.increment_feature(jindex, jnp.asarray(ids), jnp.asarray(cols), jnp.asarray(vals))
    _same(got, want)
    f = got.features.numpy()
    assert f[3, 0] == index.features[3, 0] + 1.75 and f[9, 0] == index.features[9, 0]  # the lower slot, summed
    got = pers.apply_feature_updates(index, torch.from_numpy(ids[[0, 1, 2, 4]]), torch.from_numpy(cols[[0, 1, 2, 4]]),
                                     torch.from_numpy(vals[[0, 1, 2, 4]]))
    want = jpers.apply_feature_updates(jindex, jnp.asarray(ids[[0, 1, 2, 4]]), jnp.asarray(cols[[0, 1, 2, 4]]),
                                       jnp.asarray(vals[[0, 1, 2, 4]]))
    _same(got, want)
    # one column for the whole batch, as the ingester sends it
    _same(pers.increment_feature(index, torch.from_numpy(ids), 7, torch.from_numpy(vals)),
          jpers.increment_feature(jindex, jnp.asarray(ids), jnp.int32(7), jnp.asarray(vals)))
    assert torch.equal(index.features, _ring_with_a_repeat()[0].features)  # the input index is untouched


def test_delete_follows_jax_slot_rules():
    index, jindex = _ring_with_a_repeat()
    g = ing.EarlybirdIngester(eb.EarlybirdConfig(capacity=16, max_tokens=4), index=index)
    jg = jing.EarlybirdIngester(jeb.EarlybirdConfig(capacity=16, max_tokens=4), index=jindex)
    for batch in ([503], [99999], [501, 501, 900]):
        g.delete_tweets(batch)
        jg.delete_tweets(batch)
        _same(g.index, jg.index)
    assert g.index.author[9] == 9 and g.index.author[3] == PAD_ID


def test_engagements_on_ids_past_int32_are_misses():
    """UUA actions on ids the int32 id column cannot hold (a tweet the
    ingester refused) are misses: the batch's other increments land once,
    as they do without them, and the offset counts every action."""
    index, _ = _ring_with_a_repeat()
    A = uua.ActionType

    def act(item, kind=A.CLIENT_TWEET_FAV):
        return uua.UnifiedUserAction(user_id=1, action_type=kind, item_id=item, timestamp_ms=0)

    good = [act(503), act(501, A.SERVER_TWEET_RETWEET), act(900), act(12345)]
    late = [act(2**31), act(-(2**31) - 1, A.SERVER_TWEET_RETWEET), act((524_288 << 12) | 3)]
    mixed = [late[0], good[0], late[1], good[1], good[2], late[2], good[3]]
    g, want = (ing.EarlybirdIngester(eb.EarlybirdConfig(capacity=16, max_tokens=4), index=index) for _ in range(2))
    assert g.apply_engagements(mixed) == want.apply_engagements(good)
    _same(g.index, want.index)
    assert g.log_offset == len(mixed) and not torch.equal(g.index.features, index.features)


def test_micro_batches_equal_per_event_ingest():
    """While a batch fits the ring, ingesting documents one at a time or in
    micro-batches gives the same index (the card check's CPU mirror)."""
    rng = np.random.default_rng(1)
    raws = [eb.RawTweet(tweet_id=int(i), author_id=int(rng.integers(9)), created_ts=100 + i, text=f"doc {i} #x")
            for i in range(40)]
    cfg = eb.EarlybirdConfig(capacity=CAP, max_tokens=L)
    one, batched = (ing.EarlybirdIngester(cfg, device="cpu") for _ in range(2))
    for r in raws:
        one.ingest_tweets([r], now=200)
    for s in range(0, len(raws), 13):
        batched.ingest_tweets(raws[s:s + 13], now=200)
    _same(one.index, batched.index)


def _flushed(pkg, index, path, offset):
    pkg.flush_index(index, path, log_offset=offset)
    return path


def test_fault_3_jax_snapshot_loads_equal_in_port(tmp_path):
    (g, *_), (jg, *_) = (_session(*s) for s in SIDES)
    path = _flushed(jpers, jg.index, str(tmp_path / "jax.npz"), 41)
    assert np.load(path)["features"].shape[1] == len(eb.DOC_FEATURES) == 184
    loaded, offset = pers.load_index(path, device="cpu")
    assert offset == 41 and isinstance(loaded.write_pos, int)
    _same(loaded, jg.index)
    _same(loaded, g.index)


def test_fault_3_a_narrow_snapshot_loads_in_jax_and_raises_in_port(tmp_path):
    cfg = jeb.EarlybirdConfig(capacity=8, max_tokens=4, num_features=119)
    path = _flushed(jpers, jeb.init_index(cfg), str(tmp_path / "old.npz"), 3)
    jloaded, _ = jpers.load_index(path)  # the reference takes any width
    assert jloaded.features.shape == (8, 119)
    with pytest.raises(ValueError, match="119.*184"):
        pers.load_index(path, device="cpu")
    loaded, offset = pers.load_index(path, num_features=119, device="cpu")  # named, it loads as before
    _same(loaded, jloaded)
    assert offset == 3


def test_port_snapshot_loads_in_jax_and_replays_alike(tmp_path):
    (g, *_), (jg, *_) = (_session(*s) for s in SIDES)
    path = _flushed(pers, g.index, str(tmp_path / "port.npz"), g.log_offset)
    with np.load(path) as z:
        assert z["write_pos"].dtype == np.int32 and z["write_pos"].shape == ()
    jloaded, joffset = jpers.load_index(path)
    _same(g.index, jloaded)
    raws = [jeb.RawTweet(tweet_id=7000 + i, author_id=i, created_ts=3000 + i, text=f"tail {i}") for i in range(3)]
    docs = [np.asarray(a) for a in jeb.build_documents(raws, jeb.EarlybirdConfig(capacity=CAP, max_tokens=L), now=3010)]

    def replay(offset):
        assert offset == joffset
        return (*docs[:5], offset + 3)

    loaded, offset = pers.load_index(path, replay=replay, device="cpu")
    jloaded, jnew = jpers.load_index(path, replay=replay)
    assert offset == jnew == joffset + 3
    _same(loaded, jloaded)


def test_roll_expired_matches_jax():
    (g, *_), (jg, *_) = (_session(*s) for s in SIDES)
    arch = eb.init_index(eb.EarlybirdConfig(capacity=16, max_tokens=L), device="cpu")
    jarch = jeb.init_index(jeb.EarlybirdConfig(capacity=16, max_tokens=L))
    got = pers.roll_expired(g.index, arch, now=1030, retention_s=10)
    want = jpers.roll_expired(jg.index, jarch, now=1030, retention_s=10)
    assert got[2] == want[2] > 0
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert pers.roll_expired(got[0], got[1], now=0, retention_s=10)[2] == 0


def test_query_cache_matches_jax():
    outs = []
    for mod in (pers, jpers):
        t = [0.0]
        cache = mod.QueryCache(max_items=2, ttl_s=5.0, max_stale_writes=1, clock=lambda: t[0])
        seen = []
        for step, key in enumerate(["a", "b", "a", "c", "a", "b", "b"]):
            if step == 3:
                cache.on_write()
            if step == 5:
                cache.on_write(2)
                t[0] = 4.0
            if step == 6:
                t[0] = 10.0
            seen.append(cache.get_or_compute((key,), lambda: f"{key}{step}"))
        outs.append((seen, cache.hits, cache.misses))
    assert outs[0] == outs[1]


def test_action_map_matches_jax():
    assert {a.name: v for a, v in ing._ACTION_TO_FEATURE.items()} == \
        {a.name: v for a, v in jing._ACTION_TO_FEATURE.items()}
    assert [s.name for s in ing.AuthorState] == [s.name for s in jing.AuthorState]
    assert dataclasses.fields(eb.RawTweet) and len(dataclasses.fields(eb.RawTweet)) == len(
        dataclasses.fields(jeb.RawTweet))


def test_readers_see_whole_versions_while_ingesting():
    """A reader thread takes ``ingester.index`` while a writer ingests one
    document at a time: every version it reads is whole (each write builds
    new tables and swaps them in with one assignment)."""
    import sys
    import threading

    g = ing.EarlybirdIngester(eb.EarlybirdConfig(capacity=256, max_tokens=4), device="cpu")
    raws = [eb.RawTweet(tweet_id=10_000 + i, author_id=i % 7, created_ts=i, text=f"doc {i}") for i in range(120)]
    bad, stop = [], threading.Event()

    def read():
        while not stop.is_set():
            v = g.index
            n = int((v.tweet_ids != PAD_ID).sum())
            if n != v.write_pos or not bool((v.author[:n] == torch.arange(n) % 7).all()):
                bad.append(n)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=read) for _ in range(4)]
    try:
        for r in readers:
            r.start()
        for r in raws:
            g.ingest_tweets([r], now=200)
    finally:
        stop.set()
        for r in readers:
            r.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(r.is_alive() for r in readers) and not bad
    assert g.index.write_pos == len(raws)
