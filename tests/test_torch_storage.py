"""The port's tweetypie copy (``storage/tweetypie.py``) against the JAX
package's: the write service's event sequence and store, the hydrator
catalog, the read-through cache, conversation resolution and the earlybird
bridge, driven by one script on both sides and compared exactly; and fault
10, a write the ingester refuses: the JAX package drops it silently, the
port keeps the error."""

import dataclasses

import numpy as np
import pytest
from torch_port_util import PAD_ID  # noqa: F401  (pins torch to one thread)

from the_algorithm_tpu.search import earlybird as jeb
from the_algorithm_tpu.search import ingester as jing
from the_algorithm_tpu.storage import tweetypie as jtp
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.search import ingester as ing
from the_algorithm_tpu_torch.storage import tweetypie as tp

CFG = dict(capacity=64, max_tokens=8)
LATE = 524_288  # the first second whose ids (now << 12) pass 2**31


def _script(pkg):
    """One write-path session: posts (roots, a reply chain, a quote, media),
    edits, a refused edit, chain-scoped deletes, undeletes and takedowns.
    Returns the service, the fanout events and the refusals."""
    store = pkg.TweetStore()
    svc = pkg.TweetWriteService(store=store, cache=pkg.CachingTweetStore(store))
    events, refused = [], []
    for kind in ("create", "delete", "undelete", "edit"):
        svc.on(kind, lambda ev: events.append((ev.kind, ev.tweet.tweet_id, ev.edit_of, ev.tweet.conversation_id)))
    root = svc.post_tweet(1, "hello #tpu world https://t.co/a", now=100, media=("a.jpg",))
    r1 = svc.post_tweet(2, "@one reply", now=101, reply_to=root.tweet_id)
    r2 = svc.post_tweet(1, "self reply", now=101, reply_to=r1.tweet_id)
    r3 = svc.post_tweet(1, "deeper", now=102, reply_to=r2.tweet_id)
    q = svc.post_tweet(3, "quoting $TPU", now=103, quoted_tweet_id=root.tweet_id, media=("v.mp4",))
    v1 = svc.edit_tweet(root.tweet_id, "hello edited", now=200)
    v2 = svc.edit_tweet(v1.tweet_id, "hello edited twice", now=300)
    for call in (lambda: svc.edit_tweet(q.tweet_id, "late", now=103 + 3601),
                 lambda: svc.post_tweet(4, "   ", now=104),
                 lambda: svc.post_tweet(4, "x", now=104, reply_to=999),
                 lambda: svc.undelete_tweet(r3.tweet_id)):
        try:
            call()
        except pkg.WriteError as e:
            refused.append(str(e))
    svc.takedown(v1.tweet_id, ["de", "fr"])
    deleted = svc.delete_tweet(root.tweet_id)
    restored = svc.undelete_tweet(v2.tweet_id)
    svc.delete_tweet(r2.tweet_id)
    svc.store.increment_counts(q.tweet_id, favs=3, retweets=1)
    return svc, events, refused, (deleted, restored, [root, r1, r2, r3, q, v1, v2])


def _store_dump(store):
    return {tid: dataclasses.asdict(t) for tid, t in store._tweets.items()}


def test_write_service_events_and_store_match_jax():
    got, want = _script(tp), _script(jtp)
    assert got[1] == want[1] and got[1]  # the fanout events, in order
    assert got[2] == want[2] and len(got[2]) == 4
    assert got[3][:2] == want[3][:2]
    assert _store_dump(got[0].store) == _store_dump(want[0].store)
    ids = [t.tweet_id for t in got[3][2]]
    for tid in ids:
        assert got[0].edits.versions(tid) == want[0].edits.versions(tid)
        assert got[0].edits.latest(tid) == want[0].edits.latest(tid)
        assert got[0].takedowns.countries(tid) == want[0].takedowns.countries(tid)
    assert not got[0].hook_errors and got[0].hook_failures == 0


def _hydrated(pkg, svc, ids):
    viewer = pkg.ViewerContext(user_id=9, country="de", faved_ids={ids[0]}, muted_conversations={ids[0]})
    out = []
    for fields in (pkg.HydrationField.CORE, pkg.HydrationField.ALL,
                   pkg.HydrationField.COUNTS | pkg.HydrationField.QUOTED | pkg.HydrationField.EDIT):
        for h in svc.store.get_tweets(ids + [12345], fields, viewer=viewer, takedowns=svc.takedowns,
                                      edits=svc.edits):
            out.append(dataclasses.asdict(h))
    return out


def test_hydrator_catalog_matches_jax():
    assert [(n, f.name) for n, f, _ in tp.HYDRATOR_CATALOG] == [(n, f.name) for n, f, _ in jtp.HYDRATOR_CATALOG]
    (svc, *_, (_, _, tweets)), (jsvc, *_, (_, _, jtweets)) = _script(tp), _script(jtp)
    assert _hydrated(tp, svc, [t.tweet_id for t in tweets]) == _hydrated(jtp, jsvc, [t.tweet_id for t in jtweets])
    assert svc.store.author_map() == jsvc.store.author_map()


def test_caching_store_matches_jax():
    outs = []
    for pkg in (tp, jtp):
        store = pkg.TweetStore()
        for i in range(6):
            store.create(pkg.Tweet(i, author_id=i % 2, text=f"t{i}", created_ts=i))
        cache = pkg.CachingTweetStore(store, capacity=4)
        seen = []
        for ids in ([0, 1, 2], [1, 2, 9], [3, 4, 0], [0, 5]):
            seen.append([dataclasses.asdict(h) for h in cache.get_tweets(ids, pkg.HydrationField.COUNTS)])
        store.increment_counts(0, favs=2)
        cache.invalidate(0)
        seen.append([dataclasses.asdict(h) for h in cache.get_tweets([0, 9], pkg.HydrationField.COUNTS)])
        outs.append((seen, cache.hits, cache.misses))
    assert outs[0] == outs[1]


def test_conversation_entities_and_bridge_match_jax():
    (svc, *_, (_, _, tweets)), (jsvc, *_, (_, _, jtweets)) = _script(tp), _script(jtp)
    for t, jt in zip(tweets, jtweets):
        assert svc.resolver.resolve(t) == jsvc.resolver.resolve(jt)
        assert tp.extract_entities(t.text) == tp.extract_entities(jt.text)
        assert dataclasses.asdict(tp.extract_entities(t.text)) == dataclasses.asdict(jtp.extract_entities(jt.text))
        raw = tp.to_raw_tweet(svc.store, t, now=400, language="ja", user_rep=0.5)
        jraw = jtp.to_raw_tweet(jsvc.store, jt, now=400, language="ja", user_rep=0.5)
        assert isinstance(raw, eb.RawTweet)
        assert dataclasses.asdict(raw) == dataclasses.asdict(jraw)


def _wired(pkg, eb_pkg, ing_pkg, **kw):
    svc = pkg.TweetWriteService()
    g = ing_pkg.EarlybirdIngester(eb_pkg.EarlybirdConfig(**CFG), store=svc.store, **kw)
    pkg.ingester_fanout(svc, g)
    return svc, g


def _columns(index):
    return [np.asarray(index.tokens), np.asarray(index.author), np.asarray(index.created_ts),
            np.asarray(index.features), np.asarray(index.tweet_ids), int(index.write_pos)]


def _same_columns(a, b):
    for x, y in zip(a[:5], b[:5]):
        np.testing.assert_array_equal(x, y)
    assert a[5] == b[5]


def test_fault_10_jax_drops_a_late_write_silently():
    """A tweet posted at now >= 524,288 s gets an id past 2**31; the JAX
    ingester cannot store it, and the write service swallows the error."""
    svc, g = _wired(jtp, jeb, jing)
    svc.post_tweet(1, "indexed", now=LATE - 1)
    before = _columns(g.index)
    t = svc.post_tweet(1, "lost", now=LATE)  # no exception reaches the writer
    assert t.tweet_id >= 2**31 and t.tweet_id in svc.store._tweets
    _same_columns(_columns(g.index), before)  # the index never saw it
    assert not hasattr(svc, "hook_errors") and g.log_offset == 1  # and nothing says so
    with pytest.raises(OverflowError):
        g.delete_tweets([t.tweet_id])


def test_fault_10_port_records_the_refused_write():
    svc, g = _wired(tp, eb, ing, device="cpu")
    first = svc.post_tweet(1, "indexed", now=LATE - 1)
    assert first.tweet_id < 2**31 and first.tweet_id in g.index.tweet_ids.tolist()
    before = _columns(g.index)
    t = svc.post_tweet(1, "refused", now=LATE)  # the write itself succeeds
    assert t.tweet_id in svc.store._tweets
    assert len(svc.hook_errors) == 1 and svc.hook_failures == 1
    event, err = svc.hook_errors[0]
    assert event.kind == "create" and event.tweet.tweet_id == t.tweet_id
    assert isinstance(err, ValueError) and str(t.tweet_id) in str(err) and str(2**31 - 1) in str(err)
    _same_columns(_columns(g.index), before)
    assert g.log_offset == 1
    # a batch is all-or-nothing: the good tweet of a mixed batch is not ingested either
    with pytest.raises(ValueError, match=str(t.tweet_id)):
        g.ingest_tweets([svc.store._tweets[first.tweet_id], t], now=LATE)
    _same_columns(_columns(g.index), before)
    with pytest.raises(ValueError, match=str(t.tweet_id)):
        g.delete_tweets([first.tweet_id, t.tweet_id])
    _same_columns(_columns(g.index), before)
    svc.delete_tweet(t.tweet_id)  # the tombstone is refused too, and recorded
    assert [e.kind for e, _ in svc.hook_errors] == ["create", "delete"]


def test_refused_writes_keep_a_bounded_record():
    """Every post past the limit fails its ingest; the service counts each
    one but keeps only the last HOOK_ERRORS_KEPT exceptions (each holds its
    batch through its traceback)."""
    svc, g = _wired(tp, eb, ing, device="cpu")
    before = _columns(g.index)
    kept = tp.TweetWriteService.HOOK_ERRORS_KEPT
    late = [svc.post_tweet(1 + i % 4, f"late {i}", now=LATE + i) for i in range(3 * kept)]
    assert svc.hook_failures == 3 * kept and len(svc.hook_errors) == kept
    assert [e.tweet.tweet_id for e, _ in svc.hook_errors] == [t.tweet_id for t in late[-kept:]]
    assert all(isinstance(err, ValueError) for _, err in svc.hook_errors)
    _same_columns(_columns(g.index), before)


def test_late_writes_below_the_limit_index_alike():
    """At now = 524,287 s both packages index the post, to the same columns."""
    cols = []
    for pkg, eb_pkg, ing_pkg, kw in ((tp, eb, ing, {"device": "cpu"}), (jtp, jeb, jing, {})):
        svc, g = _wired(pkg, eb_pkg, ing_pkg, **kw)
        t = svc.post_tweet(1, "just in time", now=LATE - 1)
        assert t.tweet_id == ((LATE - 1) << 12)
        cols.append(_columns(g.index))
    _same_columns(*cols)
