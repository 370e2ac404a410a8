"""The seeded For You candidate world that ``bench.py`` serves.

Numpy builders that reproduce the candidate sources' world of ``bench.py``'s
For You phase (``bench.py:422-494`` and its query draw ``:508-513``) draw for
draw, from the same seed and in the same order: the earlybird index, the
UTEG engagement events, each user's UTEG seeds and the in-network follow
lists. bench.py builds no UTG world; the one here is a right-hand index fed
the same events (tweet → user), with source tweets drawn from a second seed
among the tweets that have an engager. The sizes are arguments;
:data:`FULL` holds the bench's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from the_algorithm_tpu_torch.graph import graphjet, uteg
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.search import earlybird as eb

NOW = 10_000_000  # bench.py's clock (seconds)
TWEET_ID_BASE = 3_000_000  # the index's external tweet ids start here


@dataclasses.dataclass(frozen=True)
class ForYouShape:
    num_users: int = 16_384  # NU
    num_authors: int = 4_096  # A
    eb_docs: int = 1 << 18  # the realtime-tier partition's docs
    eb_tokens: int = 8  # token ids per doc
    vocab: int = 50_000  # token ids drawn from [1, vocab)
    eb_age_s: int = 40 * 3600  # docs are up to this old
    events_per_user: int = 16  # FAVORITE events: num_users × this
    tweet_space: int = 1 << 15  # engaged tweet ids drawn from [0, tweet_space)
    uteg_width: int = 32  # the UTEG graph's ring width
    seeds: int = 8  # UTEG seeds per user
    follows: int = 48  # followed authors per user
    follow_width: int = 64  # follow lists padded to this with PAD_ID
    utg_width: int = 128  # the UTG right index's ring width
    utg_sources: int = 256  # UTG source tweets per batch


FULL = ForYouShape()


@dataclasses.dataclass
class ForYouWorld:
    shape: ForYouShape
    eb_tokens: np.ndarray  # [D, L] int32
    eb_author: np.ndarray  # [D] int32
    eb_created: np.ndarray  # [D] int32
    eb_features: np.ndarray  # [D, F] float32
    eb_tweet_ids: np.ndarray  # [D] int32
    ev_users: np.ndarray  # [E] int32, in event order
    ev_tweets: np.ndarray  # [E] int32
    ev_types: np.ndarray  # [E] int32 (all FAVORITE)
    ev_ts: np.ndarray  # [E] int32, ascending
    seeds: np.ndarray  # [NU, S] int32: user u's seeds are row u % NU
    follows: np.ndarray  # [R, FW] int32: sorted follow lists, PAD padded
    utg_sources: np.ndarray  # [B] int32 source tweets with an engager


def build(shape: ForYouShape = FULL, users: int = 32, seed: int = 7, utg_seed: int = 11) -> ForYouWorld:
    """The world, with follow lists for ``users`` users: the next ``users``
    draws of bench.py's ``make_query`` sequence after its seed draw."""
    s = shape
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, s.vocab, (s.eb_docs, s.eb_tokens)).astype(np.int32)
    author = (np.arange(s.eb_docs) % s.num_authors).astype(np.int32)
    created = (NOW - rng.integers(0, s.eb_age_s, s.eb_docs)).astype(np.int32)
    features = rng.random((s.eb_docs, len(eb.DOC_FEATURES))).astype(np.float32)
    tweet_ids = np.arange(TWEET_ID_BASE, TWEET_ID_BASE + s.eb_docs, dtype=np.int32)

    n_ev = s.num_users * s.events_per_user
    ev_users = rng.integers(0, s.num_users, n_ev).astype(np.int32)
    ev_tweets = rng.integers(0, s.tweet_space, n_ev).astype(np.int32)
    ev_types = np.full(n_ev, int(uteg.EngagementType.FAVORITE), np.int32)
    ev_ts = np.sort(rng.integers(NOW - 86_400, NOW, n_ev)).astype(np.int32)

    seeds = rng.integers(0, s.num_users, (s.num_users, s.seeds)).astype(np.int32)
    follows = np.full((users, s.follow_width), PAD_ID, np.int32)
    for i in range(users):
        follows[i, : s.follows] = np.sort(rng.choice(s.num_authors, s.follows, False))[: s.follow_width]

    engaged = np.unique(ev_tweets)
    utg_sources = np.random.default_rng(utg_seed).choice(engaged, s.utg_sources, replace=False).astype(np.int32)
    return ForYouWorld(s, tokens, author, created, features, tweet_ids, ev_users, ev_tweets, ev_types, ev_ts,
                       seeds, follows, utg_sources)


def earlybird_index(world: ForYouWorld, device=None) -> eb.EarlybirdIndex:
    """The earlybird index, full (its write position past the last doc, as
    bench.py builds it), on ``device`` (default: the card)."""
    return eb.EarlybirdIndex.from_numpy(world.eb_tokens, world.eb_author, world.eb_created, world.eb_features,
                                        world.eb_tweet_ids, world.shape.eb_docs, device=device)


def in_network_query() -> eb.SearchQuery:
    """bench.py's in-network leg: the ``from:follows`` operator query over
    [0, NOW], its follow set resolved per user row at search time (CPU
    tensors)."""
    kw = eb.parse_query("from:follows")
    kw.pop("from_follows")
    return eb.SearchQuery(require_all=True, min_ts=0, max_ts=NOW, **kw)


def engagement_graph(world: ForYouWorld, device=None) -> uteg.EngagementGraph:
    """The UTEG graph fed every event, on ``device`` (default: the card)."""
    g = uteg.init_graph(world.shape.num_users, width=world.shape.uteg_width, device=device)
    return uteg.record_engagements(g, world.ev_users, world.ev_tweets, world.ev_types, world.ev_ts)


def right_index(world: ForYouWorld, device=None) -> graphjet.RightIndex:
    """The UTG right index (tweet → users) fed the same events in the same
    order, on ``device`` (default: the card)."""
    r = graphjet.init_right_index(world.shape.tweet_space, width=world.shape.utg_width, device=device)
    return graphjet.record_right(r, world.ev_tweets, world.ev_users, world.ev_ts)
