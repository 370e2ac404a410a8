"""Earlybird text-analysis chain: normalize → classify → segment → stem.

≡ the reference's analyzer stack feeding the Lucene index
(``src/java/com/twitter/search/common/`` tokenizers/normalizers + the
Penguin text processing in ``ingester/``): tweet text runs through unicode
normalization, a Twitter-aware tokenizer that PRESERVES token classes
(hashtags, mentions, cashtags, URLs are first-class index terms distinct
from their bare words), CJK bigram segmentation (the CJKAnalyzer shingle
approach — no dictionary), and an optional light English stemmer. Each
typed token hashes to a stable int32 term id with its class folded into
the hash, so ``#jax`` and ``jax`` occupy different postings.

A host-side copy of ``the_algorithm_tpu/search/analyzer.py`` (whose package
imports JAX).
"""

from __future__ import annotations

import dataclasses
import enum
import re
import unicodedata
from typing import Iterable, List

import numpy as np

from the_algorithm_tpu_torch.core.hashing import murmur3_x64_128
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


class TokenClass(enum.Enum):
    """Index-term classes (≡ the tokenizer's TwitterTokenStream types)."""

    WORD = "w"
    HASHTAG = "h"
    MENTION = "m"
    CASHTAG = "c"
    URL = "u"
    CJK_BIGRAM = "j"
    STEM = "s"  # stemmed variant of a WORD


@dataclasses.dataclass(frozen=True)
class Token:
    text: str  # normalized surface (class marker stripped)
    cls: TokenClass

    def term(self) -> str:
        """The indexed term string — class-prefixed so classes never
        collide (``#jax`` indexes as ``h:jax``, word ``jax`` as ``w:jax``)."""
        return f"{self.cls.value}:{self.text}"


# entity patterns run BEFORE word splitting so punctuation inside them
# survives (the reference extracts entities pre-tokenization)
_URL_RE = re.compile(r"https?://[^\s]+|www\.[^\s]+", re.IGNORECASE)
_HASHTAG_RE = re.compile(r"#([\w一-鿿]+)")
_MENTION_RE = re.compile(r"@(\w+)")
_CASHTAG_RE = re.compile(r"\$([A-Za-z][A-Za-z._]{0,9})\b")
_WORD_RE = re.compile(r"[0-9a-z_]+")
# CJK unified ideographs + hiragana/katakana + hangul
_CJK_RE = re.compile(
    r"[぀-ヿ㐀-䶿一-鿿가-힯]+")

_STEM_SUFFIXES = (
    "ingly", "edly", "ations", "ation", "ings", "ing", "edly", "ied",
    "ies", "ed", "es", "ly", "s",
)


def normalize(text: str) -> str:
    """NFKC fold + casefold + accent strip (the unicode normalizer)."""
    t = unicodedata.normalize("NFKC", text).casefold()
    # strip combining marks (é → e), then recompose — NFD splits Hangul
    # syllables into conjoining jamo, which NFC reassembles (accentless
    # Latin has no mark left to recompose)
    t = "".join(
        c for c in unicodedata.normalize("NFD", t)
        if not unicodedata.combining(c)
    )
    return unicodedata.normalize("NFC", t)


def stem(word: str) -> str:
    """Light English suffix stripper (the optional stemming stage — a
    deterministic Porter-lite: longest matching suffix first; y-restoring
    ies/ied keep stems ≥2, the rest ≥3)."""
    for suf in _STEM_SUFFIXES:
        restore_y = suf in ("ied", "ies")
        min_base = 2 if restore_y else 3
        if word.endswith(suf) and len(word) - len(suf) >= min_base:
            base = word[: len(word) - len(suf)]
            if restore_y:
                base += "y"
            return base
    return word


def _cjk_bigrams(run: str) -> Iterable[str]:
    if len(run) == 1:
        yield run
        return
    for i in range(len(run) - 1):
        yield run[i:i + 2]


def url_domain(url: str) -> str:
    """Registrable-ish domain of a URL (scheme/path/port/www stripped)."""
    u = url.lower()
    u = re.sub(r"^https?://", "", u)
    u = re.sub(r"^www\.", "", u)
    return u.split("/")[0].split("?")[0].split(":")[0]


def analyze(
    text: str,
    *,
    stemming: bool = False,
) -> List[Token]:
    """The full chain → typed tokens in surface order.

    URLs emit BOTH the full normalized URL term and the domain term (the
    reference indexes resolved URL + domain facets); hashtags/mentions/
    cashtags keep their class; CJK runs emit overlapping bigrams; with
    ``stemming`` each word also emits its stem (as a distinct STEM-class
    term, so exact matches still outrank stemmed matches).
    """
    out: List[Token] = []
    t = normalize(text)

    def consume(regex, make):
        nonlocal t

        def repl(m):
            for tok in make(m):
                out.append(tok)
            return " "

        t = regex.sub(repl, t)

    consume(_URL_RE, lambda m: [
        Token(m.group(0).rstrip(".,;:!?)"), TokenClass.URL),
        Token(url_domain(m.group(0)), TokenClass.URL),
    ])
    consume(_HASHTAG_RE, lambda m: [Token(m.group(1), TokenClass.HASHTAG)])
    consume(_MENTION_RE, lambda m: [Token(m.group(1), TokenClass.MENTION)])
    consume(_CASHTAG_RE, lambda m: [Token(m.group(1), TokenClass.CASHTAG)])

    # CJK runs → bigrams; remaining latin words → WORD (+ optional STEM)
    pos = 0
    for m in _CJK_RE.finditer(t):
        for w in _WORD_RE.findall(t[pos:m.start()]):
            out.append(Token(w, TokenClass.WORD))
            if stemming and (s := stem(w)) != w:
                out.append(Token(s, TokenClass.STEM))
        for bg in _cjk_bigrams(m.group(0)):
            out.append(Token(bg, TokenClass.CJK_BIGRAM))
        pos = m.end()
    for w in _WORD_RE.findall(t[pos:]):
        out.append(Token(w, TokenClass.WORD))
        if stemming and (s := stem(w)) != w:
            out.append(Token(s, TokenClass.STEM))
    return out


def term_id(token: Token) -> int:
    """Stable int32 postings id (murmur3 over the class-prefixed term)."""
    h1, _ = murmur3_x64_128(token.term().encode("utf-8"))
    return int(np.int32(h1 & 0x7FFFFFFF))


def token_ids(
    text: str,
    max_tokens: int,
    *,
    stemming: bool = False,
) -> np.ndarray:
    """[max_tokens] int32 term ids, PAD padded — the index/query encoder."""
    out = np.full(max_tokens, int(PAD_ID), np.int32)
    for i, tok in enumerate(analyze(text, stemming=stemming)[:max_tokens]):
        out[i] = term_id(tok)
    return out


def extract_entities(text: str) -> dict:
    """Facet-grade entities (the ingester's URL/hashtag/mention extraction):
    {hashtags, mentions, cashtags, urls, domains} of the normalized text."""
    toks = analyze(text)
    full = [t for t in toks if t.cls is TokenClass.URL]
    # analyze emits (full, domain) pairs for each URL
    full_urls = [t.text for i, t in enumerate(full) if i % 2 == 0]
    domains = [t.text for i, t in enumerate(full) if i % 2 == 1]
    return {
        "hashtags": [t.text for t in toks if t.cls is TokenClass.HASHTAG],
        "mentions": [t.text for t in toks if t.cls is TokenClass.MENTION],
        "cashtags": [t.text for t in toks if t.cls is TokenClass.CASHTAG],
        "urls": full_urls,
        "domains": domains,
    }
