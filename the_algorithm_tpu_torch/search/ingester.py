"""Earlybird ingester: event streams → live index maintenance.

Counterpart of ``the_algorithm_tpu/search/ingester.py``
(``src/java/com/twitter/search/ingester/``: the tweet ingestion pipeline —
tweetypie create/delete events through text analysis into index documents —
plus the engagement-count updater and the user-updates pipeline that pushes
author safety states into the index; and ``feature_update_service/``).

One coordinator class consumes the framework's real streams:

- tweet creates (``storage/tweetypie.Tweet``) → ``to_raw_tweet``
  conversation/entity enrichment → ``build_documents`` (host) → one
  ``ingest`` a batch;
- UUA engagement actions → per-id host pre-sums → one
  ``persistence.increment_feature`` a touched column (an item id the int32
  id column cannot hold is a miss, dropped before any column is written);
- tweet deletes → in-index tombstone (author := PAD so the doc stops
  matching — the reference's delete pipeline);
- user updates (suspend/protect) → an author-state table consulted at
  query time through :meth:`EarlybirdIngester.visible_author_mask`.

Every write builds a new index and replaces ``self.index`` with one
assignment, so a reader holding the old one keeps a consistent version. A
batch longer than the ring writes slots twice, as in the JAX package
(which write survives is unspecified).

Where the port differs: tweet ids are int32 in the index, and
:meth:`~EarlybirdIngester.ingest_tweets` and
:meth:`~EarlybirdIngester.delete_tweets` raise ``ValueError`` for an id
outside [-2**31, 2**31 - 1] before building anything, so a batch is
all-or-nothing. The JAX ingester raises ``OverflowError`` mid-build, and its
write service's fanout drops that error: a tweet posted at ``now >=
524,288`` s (whose id ``(now << 12) | seq`` passes 2**31) never reaches its
index, silently. A tweet-id → doc-id map would lift the limit; the JAX
package has none (earlybird keeps a tweet-id mapper per segment).
"""

from __future__ import annotations

import enum
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.actions.uua import ActionType, UnifiedUserAction
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.search import persistence
from the_algorithm_tpu_torch.storage import tweetypie as tp

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1

# UUA engagement → which doc-feature count it bumps (the engagement
# updater's mapping; unfavs decrement)
_ACTION_TO_FEATURE: Dict[ActionType, tuple] = {
    ActionType.CLIENT_TWEET_FAV: ("fav_count", 1.0),
    ActionType.SERVER_TWEET_FAV: ("fav_count", 1.0),
    ActionType.CLIENT_TWEET_UNFAV: ("fav_count", -1.0),
    ActionType.SERVER_TWEET_UNFAV: ("fav_count", -1.0),
    ActionType.CLIENT_TWEET_REPLY: ("reply_count", 1.0),
    ActionType.SERVER_TWEET_REPLY: ("reply_count", 1.0),
    ActionType.CLIENT_TWEET_RETWEET: ("retweet_count", 1.0),
    ActionType.SERVER_TWEET_RETWEET: ("retweet_count", 1.0),
    ActionType.CLIENT_TWEET_QUOTE: ("quote_count", 1.0),
    ActionType.SERVER_TWEET_QUOTE: ("quote_count", 1.0),
}


class AuthorState(enum.IntEnum):
    """≡ the user-updates pipeline's antisocial states."""

    NORMAL = 0
    PROTECTED = 1
    SUSPENDED = 2
    DEACTIVATED = 3


def check_tweet_ids(ids: Iterable[int]) -> None:
    """Raise ``ValueError`` for the first id the int32 id column cannot hold."""
    for i in ids:
        if not INT32_MIN <= int(i) <= INT32_MAX:
            raise ValueError(f"tweet id {int(i)} is outside the index's int32 range "
                             f"[{INT32_MIN}, {INT32_MAX}]")


class EarlybirdIngester:
    """The ingestion pipelines around one live index (on ``device``, by
    default the card, when no index is given)."""

    def __init__(
        self,
        config: eb.EarlybirdConfig,
        index: Optional[eb.EarlybirdIndex] = None,
        store: Optional[tp.TweetStore] = None,
        ui_language: str = "en",
        url_reputation: Optional[Mapping] = None,  # domain -> rep [0,1]
        card_store: Optional[Mapping] = None,  # tweet_id -> card type
        device=None,
    ):
        self.config = config
        self.index = index if index is not None else eb.init_index(config, device)
        self.store = store
        self.ui_language = ui_language
        self.author_state: Dict[int, AuthorState] = {}
        self.log_offset = 0  # consumed-event offset (Kafka-offset analog)
        # the URL/card resolution stores (the ingester resolve stage:
        # shortener expansion + domain reputation + card hydration)
        self.url_reputation = url_reputation
        self.card_store = card_store

    # -- tweet ingestion pipeline -------------------------------------------

    def ingest_tweets(self, tweets: Sequence, *, now: int = 0) -> int:
        """Tweet creates → documents → ring append. Accepts RawTweet or
        tweetypie Tweet records (enriched via the tweetypie bridge)."""
        check_tweet_ids(t.tweet_id for t in tweets)
        raws = []
        for t in tweets:
            if isinstance(t, eb.RawTweet):
                raws.append(t)
            elif self.store is not None:
                raws.append(tp.to_raw_tweet(
                    self.store, t, now=now, language=self.ui_language))
            else:
                raise ValueError(
                    "tweetypie Tweet ingestion needs a TweetStore"
                )
        if not raws:
            return 0
        docs = eb.build_documents(
            raws, self.config, ui_language=self.ui_language, now=now,
            url_reputation=self.url_reputation, card_store=self.card_store,
        )
        self.index = eb.ingest(self.index, *docs[:5])
        self.log_offset += len(raws)
        return len(raws)

    # -- engagement-count updater -------------------------------------------

    def apply_engagements(self, actions: Sequence[UnifiedUserAction]) -> int:
        """UUA actions → batched in-index count increments (one device call
        per touched feature column, each id's deltas summed on the host in
        event order first). An item id outside int32 names no indexed tweet
        (ingest refuses it): a miss, dropped like any id not in the ring."""
        by_feature: Dict[str, Dict[int, float]] = {}
        for a in actions:
            m = _ACTION_TO_FEATURE.get(a.action_type)
            if m is None or not INT32_MIN <= int(a.item_id) <= INT32_MAX:
                continue
            name, delta = m
            col = by_feature.setdefault(name, {})
            col[int(a.item_id)] = col.get(int(a.item_id), 0.0) + delta
        n = 0
        for name, deltas in by_feature.items():
            ids = np.fromiter(deltas.keys(), np.int32, len(deltas))
            vals = np.fromiter(deltas.values(), np.float32, len(deltas))
            self.index = persistence.increment_feature(
                self.index, torch.from_numpy(ids), eb.DOC_FEATURE_INDEX[name], torch.from_numpy(vals))
            n += ids.shape[0]
        self.log_offset += len(actions)
        return n

    # -- delete pipeline ------------------------------------------------------

    def delete_tweets(self, tweet_ids: Sequence[int]) -> None:
        """Tombstone: clear the author column so the doc stops matching
        (every query requires ``author != PAD``); the lowest slot of an id
        held twice, and nothing for an id not in the ring."""
        check_tweet_ids(tweet_ids)
        ids = torch.tensor([int(i) for i in tweet_ids], dtype=torch.int32)
        slot, found = persistence.find_slots(self.index, ids)
        self.index = self.index._replace(
            author=self.index.author.index_put((slot[found],), torch.tensor(PAD_ID, dtype=torch.int32,
                                                                           device=slot.device)))

    # -- user-updates pipeline -------------------------------------------------

    def apply_user_updates(
        self, updates: Mapping[int, AuthorState]
    ) -> None:
        """Author safety-state stream (suspend/protect/deactivate)."""
        self.author_state.update(
            {int(k): AuthorState(v) for k, v in updates.items()}
        )

    def visible_author_mask(self, index: Optional[eb.EarlybirdIndex] = None) -> torch.Tensor:
        """[T] bool — docs of ``index`` (default: the live one) whose author
        is currently servable; AND this into ``match_mask`` output (the
        collector-level author filter)."""
        index = self.index if index is None else index
        bad = [a for a, s in self.author_state.items() if s != AuthorState.NORMAL]
        if not bad:
            return torch.ones((index.capacity,), dtype=torch.bool, device=index.author.device)
        return ~torch.isin(index.author, torch.tensor(bad, dtype=torch.int32, device=index.author.device))

    # -- search with ingester-side filters ------------------------------------

    def search(self, query: eb.SearchQuery, *, max_results: int, **kw):
        """Query the live index with the author-state mask applied
        (one ``eb.search`` call — the mask rides ``extra_mask``)."""
        index = self.index  # one version for the mask and the scan
        return eb.search(
            index, query, max_results=max_results,
            extra_mask=self.visible_author_mask(index), **kw,
        )
