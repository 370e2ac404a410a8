"""The port's host copies — feature hashing, the analyzer chain, the earlybird
schema tables, the query parser and the ingester's document builder —
against the JAX package's originals. Everything here is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from the_algorithm_tpu.core import hashing as jh
from the_algorithm_tpu.search import analyzer as ja
from the_algorithm_tpu.search import earlybird as je
from the_algorithm_tpu_torch.core import hashing
from the_algorithm_tpu_torch.search import analyzer
from the_algorithm_tpu_torch.search import earlybird as eb

BYTES = [b"", b"a", b"abc", b"x" * 15, b"y" * 16, b"z" * 17, b"0123456789abcdef0123456789", "é漢字".encode()]


@pytest.mark.parametrize("seed", [0, 1, 2**40 + 7])
def test_murmur3_matches(seed):
    for data in BYTES:
        assert hashing.murmur3_x64_128(data, seed) == jh.murmur3_x64_128(data, seed)


def test_feature_id_matches():
    for name in ["user.fav_count", "a#b", "#lead", "tail#", "engagement.rate#favorite", "漢字#x"]:
        assert hashing.feature_id(name) == jh.feature_id(name)


@pytest.mark.parametrize("bits", [1, 12, 22, 31, 32])
def test_multiplicative_hash_forms_match(bits):
    rng = np.random.default_rng(bits)
    ids = np.concatenate([rng.integers(-(2**62), 2**62, 500), [0, -1, 2**32 - 1, 2**32, -(2**63), 2**63 - 1]])
    buckets = rng.integers(-(2**40), 2**40, ids.shape[0])
    want = np.asarray(jh.multiplicative_hash_jnp(jnp.asarray(ids.astype(np.uint32)),
                                                 jnp.asarray(buckets.astype(np.uint32)), bits))
    np.testing.assert_array_equal(hashing.multiplicative_hash_np(ids, buckets, bits),
                                  jh.multiplicative_hash_np(ids, buckets, bits))
    np.testing.assert_array_equal(hashing.multiplicative_hash_np(ids, buckets, bits), want)
    got = hashing.multiplicative_hash(torch.from_numpy(ids), torch.from_numpy(buckets), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


TEXTS = [
    "Hello World!! how are you",
    "check https://www.Example.com/path?q=1, and www.t.co/x #JAX @Someone $TSLA",
    "Café naïve ÉTÉ — ｆｕｌｌｗｉｄｔｈ",
    "日本語のテキスト 한국어 mixed 中文 words",
    "running jumped studies happily ies",
    "",
    "#漢字 tag and @user_1 and $A.B",
]


@pytest.mark.parametrize("stemming", [False, True])
def test_analyzer_and_tokenize_match(stemming):
    for text in TEXTS:
        got = analyzer.analyze(text, stemming=stemming)
        want = ja.analyze(text, stemming=stemming)
        assert [(t.text, t.cls.value) for t in got] == [(t.text, t.cls.value) for t in want]
        for n in (1, 8, 32):
            np.testing.assert_array_equal(eb.tokenize(text, n, stemming=stemming),
                                          je.tokenize(text, n, stemming=stemming))
        assert analyzer.extract_entities(text) == ja.extract_entities(text)


def test_schema_tables_are_the_jax_packages():
    assert eb.DOC_FEATURES == je.DOC_FEATURES and len(eb.DOC_FEATURES) == 184
    assert eb.DOC_FEATURE_INDEX == je.DOC_FEATURE_INDEX
    assert dict(eb.FIELD_CATALOG) == dict(je.FIELD_CATALOG) and len(eb.FIELD_CATALOG) == 192
    assert eb.LANGUAGE_IDS == je.LANGUAGE_IDS
    for t in (eb._COUNT_FIELDS, eb._SINGLE_COL_FILTERS, eb._ANY_GROUP_FILTERS, eb._SAFE_MAX, eb._MIN_COUNT_OPS,
              eb._URL_SHORTENERS, eb._MEDIA_DOMAINS, eb._DEFAULT_WEIGHT_TABLE):
        name = next(n for n in dir(eb) if getattr(eb, n) is t)
        assert t == getattr(je, name), name
    np.testing.assert_array_equal(eb._COUNT_MASK, je._COUNT_MASK)
    for code in ("en", "JA", "xx", "", None, "pt-br"):
        assert eb.language_id(code) == je.language_id(code)
    assert eb.EarlybirdConfig() == eb.EarlybirdConfig(**je.EarlybirdConfig().__dict__)
    assert [f.name for f in eb.RawTweet.__dataclass_fields__.values()] == list(je.RawTweet.__dataclass_fields__)


# every operator of tests/test_search_query_language.py and tests/test_earlybird_operators.py
QUERIES = [
    "hello -spam", '"hello world" -spam', 'tpu "exact phrase" -bad -worse', '"hello world"', "",
    "hello from:1", "hello from:follows", "from:follows", "hello lang:en", "hello lang:ja", "hello lang:zz",
    "hello filter:images", "hello filter:replies", "hello filter:retweets", "hello filter:links",
    "hello -filter:retweets", "hello filter:media", "hello filter:videos", "hello filter:cards", "filter:safe",
    "hello min_faves:100", "hello min_retweets:50", "min_replies:3 min_quotes:2 min_score:0.5",
    "hello lang:en min_faves:40 -filter:replies", "hello since_time:25 until_time:45",
    "hello since_id:701 max_id:704", "hello -sharding", "weird:op min_faves:abc -", '"a" "b c" "d e f g h"',
]


def _same_kwargs(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, bool):
            assert g is w, k
        elif isinstance(g, torch.Tensor):
            assert g.dtype == {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}[np.asarray(w).dtype]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
        else:
            assert isinstance(g, int) and g == int(w), k


@pytest.mark.parametrize("text", QUERIES)
def test_parse_query_matches(text):
    _same_kwargs(eb.parse_query(text), je.parse_query(text))
    _same_kwargs(eb.parse_query(text, max_tokens=4, max_phrases=1, phrase_len=2),
                 je.parse_query(text, max_tokens=4, max_phrases=1, phrase_len=2))


def test_build_query_matches():
    for text, kw in [("hello from:follows", dict(follows=[3, 1, 2])), ("hello since_time:25", dict(max_ts=99)),
                     ("hello", dict(min_ts=5, require_all=False))]:
        got, want = eb.build_query(text, **kw), je.build_query(text, **kw)
        assert got._fields == want._fields
        _same_kwargs(got._asdict(), want._asdict())
    with pytest.raises(ValueError):
        eb.build_query("hello from:follows")
    q = eb.build_query("hello filter:media", follows=[1]).to("cpu")
    assert q.tokens.device.type == "cpu" and q.feature_any_groups.shape[0] == 1


def test_build_documents_matches():
    tweets = [
        eb.RawTweet(tweet_id=1, author_id=2, created_ts=1000, text="check this out https://x.com #jax @you",
                    fav_count=7, is_reply=True, language="en", author_followers=100, has_image=True, has_video=True),
        eb.RawTweet(tweet_id=2, author_id=3, created_ts=900, text="Ünïcode 日本語 $TSLA https://t.co/a www.youtube.com/v",
                    language="ja", retweet_count=4, is_trend_tweet=True, author_following=9, user_rep=0.5),
        eb.RawTweet(tweet_id=3, author_id=4, created_ts=800, text="#a #b #c @x @y lots of words words words 😀 CAPS"),
    ]
    jtweets = [je.RawTweet(**t.__dict__) for t in tweets]
    for kw in (dict(), dict(now=4600, ui_language="ja", max_facets=3,
                            url_reputation={"x.com": 0.9, "youtube.com": 0.2}, card_store={2: "poll", 3: "summary"})):
        got = eb.build_documents(tweets, eb.EarlybirdConfig(capacity=4, max_tokens=8), **kw)
        want = je.build_documents(jtweets, je.EarlybirdConfig(capacity=4, max_tokens=8), **kw)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
