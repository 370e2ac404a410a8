"""Tweetypie-equivalent: the tweet CRUD source of truth + hydration pipeline.

Counterpart of ``the_algorithm_tpu/storage/tweetypie.py`` (``tweetypie/``,
SURVEY.md L0): ``GetTweetsHandler`` read path over Manhattan+cache, a
``TweetHydration`` pipeline filling optional field groups (core data,
counts, media, visibility, quoted tweet), write/delete paths. Host code,
copied whole: the records, the hydrator catalog in its order, the write
service's id formula and its chain-scoped delete, undelete and takedown.
:func:`to_raw_tweet` builds the port's ``search/earlybird.RawTweet``.

One difference, on purpose: a fanout hook that raises still never fails
the write, but :class:`TweetWriteService` counts it in ``hook_failures`` and
keeps the last ``HOOK_ERRORS_KEPT`` in ``hook_errors`` instead of dropping
it. The JAX service swallows it, so a
tweet the ingester refuses (an id past int32: ids are ``(now << 12) | seq``,
past 2**31 from ``now = 524,288`` s on) leaves the index silently.

In-process: a dict-backed store (the Manhattan stand-in — SURVEY.md §4
"fake stores (dict-backed)") with the same shape: typed Tweet records,
hydration options selecting field groups, soft deletes, count updates fed by
the UUA stream. The serving pipelines hydrate candidate features from here.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import threading
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Set


class HydrationField(enum.Flag):
    """≡ the hydration option groups in GetTweetOptions (r5: the named
    hydrator catalog below maps each flag to its ``hydrator/*.scala``
    counterparts)."""

    CORE = enum.auto()  # text, author, created_at
    COUNTS = enum.auto()  # fav/retweet/reply/quote counts
    MEDIA = enum.auto()
    VISIBILITY = enum.auto()  # safety labels
    QUOTED = enum.auto()  # one level of quoted-tweet core
    # r5 breadth (TweetHydration.scala pipeline)
    LANGUAGE = enum.auto()  # LanguageHydrator
    ENTITIES = enum.auto()  # Mention/Url/Hashtag/CashtagEntitiesHydrator
    CARD = enum.auto()  # CardHydrator (+ Card2)
    PLACE = enum.auto()  # PlaceHydrator / ProfileGeoHydrator
    CONVERSATION = enum.auto()  # ConversationId/Control/MutedHydrator
    DIRECTED = enum.auto()  # DirectedAt / ReplyScreenNameHydrator
    EDIT = enum.auto()  # EditControl/Edit/EditPerspectiveHydrator
    PERSPECTIVE = enum.auto()  # PerspectiveHydrator (viewer engagement)
    SOURCE = enum.auto()  # DeviceSource / SourceTweetHydrator
    CONTRIBUTOR = enum.auto()  # ContributorHydrator
    TAKEDOWN = enum.auto()  # TakedownHydrator (country withholding)
    SELF_THREAD = enum.auto()  # self-thread metadata
    NOTE = enum.auto()  # NoteTweetSuffixHydrator
    PREVIOUS_COUNTS = enum.auto()  # PreviousTweetCountsHydrator (edits)
    MEDIA_REFS = enum.auto()  # MediaKey/Refs/Tags/UrlFieldsHydrator
    ALL = (CORE | COUNTS | MEDIA | VISIBILITY | QUOTED | LANGUAGE
           | ENTITIES | CARD | PLACE | CONVERSATION | DIRECTED | EDIT
           | PERSPECTIVE | SOURCE | CONTRIBUTOR | TAKEDOWN | SELF_THREAD
           | NOTE | PREVIOUS_COUNTS | MEDIA_REFS)


@dataclasses.dataclass
class Tweet:
    tweet_id: int
    author_id: int
    text: str
    created_ts: int
    reply_to: Optional[int] = None
    quoted_tweet_id: Optional[int] = None
    media: Sequence[str] = ()
    fav_count: int = 0
    retweet_count: int = 0
    reply_count: int = 0
    quote_count: int = 0
    safety_labels: Set[str] = dataclasses.field(default_factory=set)
    deleted: bool = False
    conversation_id: Optional[int] = None  # assigned on the write path
    # r5 hydrator-breadth fields (defaults keep old call sites working)
    language: str = "en"
    card_uri: Optional[str] = None
    place_id: Optional[int] = None
    conversation_control: Optional[str] = None  # by_invitation/community/…
    directed_at_user_id: Optional[int] = None
    source_client: str = "web"
    contributor_id: Optional[int] = None
    note_suffix: Optional[str] = None
    retweet_of: Optional[int] = None  # SourceTweetHydrator target


@dataclasses.dataclass
class HydratedTweet:
    """The GetTweetResult analog: only requested groups are populated.

    The r5 breadth groups land in ``extra`` keyed by hydrator name (the
    reference's ValueState per-hydrator slots)."""

    tweet_id: int
    core: Optional[Mapping] = None
    counts: Optional[Mapping] = None
    media: Optional[Sequence[str]] = None
    visibility: Optional[Set[str]] = None
    quoted: Optional[Mapping] = None
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)
    found: bool = True


class TweetStore:
    """Thread-safe CRUD + hydration (cache layer folded into the dict)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tweets: Dict[int, Tweet] = {}

    # -- write path (PostTweet / DeleteTweet handlers) ----------------------

    def create(self, tweet: Tweet) -> None:
        with self._lock:
            if tweet.tweet_id in self._tweets:
                raise ValueError(f"tweet {tweet.tweet_id} exists")
            self._tweets[tweet.tweet_id] = tweet
            if tweet.reply_to is not None:
                parent = self._tweets.get(tweet.reply_to)
                if parent:
                    parent.reply_count += 1
            if tweet.quoted_tweet_id is not None:
                q = self._tweets.get(tweet.quoted_tweet_id)
                if q:
                    q.quote_count += 1

    def delete(self, tweet_id: int) -> bool:
        """Soft delete (the reference tombstones; hydration reports !found)."""
        with self._lock:
            t = self._tweets.get(tweet_id)
            if t is None or t.deleted:
                return False
            t.deleted = True
            return True

    def increment_counts(
        self, tweet_id: int, favs: int = 0, retweets: int = 0
    ) -> None:
        with self._lock:
            t = self._tweets.get(tweet_id)
            if t and not t.deleted:
                t.fav_count += favs
                t.retweet_count += retweets

    # -- read path (GetTweetsHandler + TweetHydration) ----------------------

    def get_tweets(
        self,
        tweet_ids: Sequence[int],
        fields: HydrationField = HydrationField.CORE,
        *,
        viewer: Optional["ViewerContext"] = None,
        takedowns: Optional["TakedownStore"] = None,
        edits: Optional["EditChainStore"] = None,
    ) -> List[HydratedTweet]:
        """Batched hydration; missing/deleted → found=False (same order).

        The r5 breadth groups run through :data:`HYDRATOR_CATALOG` — each
        named hydrator fills one ``extra`` slot when its flag is requested
        (≡ the ``TweetHydration.scala`` pipeline composition).
        """
        out: List[HydratedTweet] = []
        with self._lock:
            for tid in tweet_ids:
                t = self._tweets.get(tid)
                if t is None or t.deleted:
                    out.append(HydratedTweet(tweet_id=tid, found=False))
                    continue
                h = HydratedTweet(tweet_id=tid)
                if fields & HydrationField.CORE:
                    h.core = {
                        "author_id": t.author_id,
                        "text": t.text,
                        "created_ts": t.created_ts,
                        "reply_to": t.reply_to,
                    }
                if fields & HydrationField.COUNTS:
                    h.counts = {
                        "fav_count": t.fav_count,
                        "retweet_count": t.retweet_count,
                        "reply_count": t.reply_count,
                        "quote_count": t.quote_count,
                    }
                if fields & HydrationField.MEDIA:
                    h.media = list(t.media)
                if fields & HydrationField.VISIBILITY:
                    h.visibility = set(t.safety_labels)
                if fields & HydrationField.QUOTED and t.quoted_tweet_id:
                    q = self._tweets.get(t.quoted_tweet_id)
                    if q and not q.deleted:
                        h.quoted = {
                            "tweet_id": q.tweet_id,
                            "author_id": q.author_id,
                            "text": q.text,
                        }
                ctx = HydrationContext(self, viewer, takedowns, edits)
                for name, flag, fn in HYDRATOR_CATALOG:
                    if fields & flag:
                        v = fn(t, ctx)
                        if v is not None:
                            h.extra[name] = v
                out.append(h)
        return out

    def author_map(self) -> Dict[int, int]:
        """tweet→author snapshot (feeds the UUA AuthorHydrator)."""
        with self._lock:
            return {
                tid: t.author_id
                for tid, t in self._tweets.items()
                if not t.deleted
            }


# -- write-path enrichment (entity extraction, conversation resolution) ---------


import re as _re

_URL_RE = _re.compile(r"https?://\S+")
_MENTION_RE = _re.compile(r"@(\w+)")
_HASHTAG_RE = _re.compile(r"#(\w+)")


@dataclasses.dataclass(frozen=True)
class TweetEntities:
    """≡ the write path's entity extraction (urls/mentions/hashtags become
    typed entities on the stored tweet; cards derive from the first url)."""

    urls: Sequence[str] = ()
    mentions: Sequence[str] = ()
    hashtags: Sequence[str] = ()

    @property
    def has_card(self) -> bool:
        return bool(self.urls)


def extract_entities(text: str) -> TweetEntities:
    return TweetEntities(
        urls=tuple(_URL_RE.findall(text)),
        mentions=tuple(_MENTION_RE.findall(text)),
        hashtags=tuple(_HASHTAG_RE.findall(text)),
    )


class ConversationResolver:
    """Reply-chain → conversation id + depth + self-thread detection
    (≡ the conversationId hydrator + selfThread logic on the write path;
    feeds the earlybird doc features conversation_depth / is_self_thread)."""

    def __init__(self, store: "TweetStore"):
        self._store = store

    def resolve(self, tweet: Tweet, max_depth: int = 64):
        """(conversation_root_id, depth, is_self_thread)."""
        root, depth = tweet.tweet_id, 0
        cur = tweet
        self_thread = True
        while cur.reply_to is not None and depth < max_depth:
            parent = self._store._tweets.get(cur.reply_to)
            if parent is None:
                break
            self_thread &= parent.author_id == tweet.author_id
            root, cur = parent.tweet_id, parent
            depth += 1
        return root, depth, self_thread and depth > 0


# -- edit history (editControl analog) -------------------------------------------


class EditChainStore:
    """Tweet edit chains: initial id ↔ ordered versions; latest resolution
    (≡ editControl: initialTweetId/editTweetIds on the stored tweet)."""

    def __init__(self):
        self._versions: Dict[int, List[int]] = {}  # initial -> [v0, v1, ...]
        self._initial_of: Dict[int, int] = {}

    def record_edit(self, initial_id: int, new_version_id: int) -> None:
        chain = self._versions.setdefault(int(initial_id), [int(initial_id)])
        chain.append(int(new_version_id))
        self._initial_of[int(new_version_id)] = int(initial_id)
        self._initial_of.setdefault(int(initial_id), int(initial_id))

    def latest(self, tweet_id: int) -> int:
        init = self._initial_of.get(int(tweet_id), int(tweet_id))
        chain = self._versions.get(init)
        return chain[-1] if chain else int(tweet_id)

    def versions(self, tweet_id: int) -> List[int]:
        init = self._initial_of.get(int(tweet_id), int(tweet_id))
        return list(self._versions.get(init, [int(tweet_id)]))

    def is_stale(self, tweet_id: int) -> bool:
        return self.latest(tweet_id) != int(tweet_id)


# -- the named read-side hydrator catalog --------------------------------------
#
# ≡ ``tweetypie/server/src/main/scala/com/twitter/tweetypie/hydrator/``:
# TweetHydration composes ~40 single-purpose hydrators, each filling one
# optional slot of the result. Same shape here: (name, flag, fn(tweet,
# ctx) -> value | None); ``get_tweets`` runs the requested ones in catalog
# order into ``HydratedTweet.extra``.


@dataclasses.dataclass
class ViewerContext:
    """≡ the per-request viewer fields PerspectiveHydrator et al. read."""

    user_id: Optional[int] = None
    country: Optional[str] = None
    faved_ids: Set[int] = dataclasses.field(default_factory=set)
    retweeted_ids: Set[int] = dataclasses.field(default_factory=set)
    muted_conversations: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class HydrationContext:
    store: "TweetStore"
    viewer: Optional[ViewerContext]
    takedowns: Optional["TakedownStore"]
    edits: Optional["EditChainStore"]


def _h_language(t, ctx):
    return {"language": t.language}


def _h_entities(t, ctx):
    e = extract_entities(t.text)
    return {"mentions": list(e.mentions), "urls": list(e.urls),
            "hashtags": list(e.hashtags)}


def _h_card(t, ctx):
    e = extract_entities(t.text)
    uri = t.card_uri or (e.urls[0] if e.urls else None)
    return {"card_uri": uri, "has_card": uri is not None}


def _h_place(t, ctx):
    return {"place_id": t.place_id} if t.place_id is not None else None


def _h_conversation(t, ctx):
    out = {"conversation_id": t.conversation_id or t.tweet_id,
           "conversation_control": t.conversation_control}
    v = ctx.viewer
    if v is not None:
        out["conversation_muted"] = (
            (t.conversation_id or t.tweet_id) in v.muted_conversations)
    return out


def _h_directed(t, ctx):
    if t.directed_at_user_id is None and t.reply_to is None:
        return None
    reply_author = None
    if t.reply_to is not None:
        parent = ctx.store._tweets.get(t.reply_to)
        if parent is not None:
            reply_author = parent.author_id
    return {"directed_at_user_id": t.directed_at_user_id,
            "in_reply_to_author_id": reply_author}


def _h_edit(t, ctx):
    if ctx.edits is None:
        return {"is_edit": False, "latest_version": t.tweet_id}
    latest = ctx.edits.latest(t.tweet_id)
    return {"is_edit": latest != t.tweet_id or bool(
                ctx.edits.versions(t.tweet_id)[:-1]),
            "latest_version": latest,
            "is_stale": ctx.edits.is_stale(t.tweet_id)}


def _h_perspective(t, ctx):
    v = ctx.viewer
    if v is None:
        return None
    return {"favorited": t.tweet_id in v.faved_ids,
            "retweeted": t.tweet_id in v.retweeted_ids}


def _h_source(t, ctx):
    out = {"source_client": t.source_client}
    if t.retweet_of is not None:
        src = ctx.store._tweets.get(t.retweet_of)
        if src is not None and not src.deleted:
            out["source_tweet"] = {"tweet_id": src.tweet_id,
                                   "author_id": src.author_id}
    return out


def _h_contributor(t, ctx):
    if t.contributor_id is None:
        return None
    return {"contributor_id": t.contributor_id}


def _h_takedown(t, ctx):
    if ctx.takedowns is None:
        return None
    countries = ctx.takedowns.countries(t.tweet_id)
    v = ctx.viewer
    return {"withheld_countries": sorted(countries),
            "withheld_for_viewer": (
                v is not None
                and ctx.takedowns.is_withheld(t.tweet_id, v.country))}


def _h_self_thread(t, ctx):
    if t.reply_to is None:
        return None
    parent = ctx.store._tweets.get(t.reply_to)
    is_self = parent is not None and parent.author_id == t.author_id
    return {"is_self_thread": is_self}


def _h_note(t, ctx):
    if t.note_suffix is None:
        return None
    return {"note_suffix": t.note_suffix,
            "expanded_text": t.text + t.note_suffix}


def _h_previous_counts(t, ctx):
    if ctx.edits is None:
        return None
    versions = ctx.edits.versions(t.tweet_id)
    prev = [v for v in versions if v != t.tweet_id]
    if not prev:
        return None
    agg = {"fav_count": 0, "retweet_count": 0, "reply_count": 0}
    for pid in prev:
        p = ctx.store._tweets.get(pid)
        if p is not None:
            agg["fav_count"] += p.fav_count
            agg["retweet_count"] += p.retweet_count
            agg["reply_count"] += p.reply_count
    return agg


def _h_media_refs(t, ctx):
    if not t.media:
        return None
    return {"media_keys": [f"key:{m}" for m in t.media],
            "media_count": len(t.media),
            "has_video": any("video" in m for m in t.media),
            "has_image": any("video" not in m for m in t.media)}


F = HydrationField
HYDRATOR_CATALOG = (
    ("LanguageHydrator", F.LANGUAGE, _h_language),
    ("MentionEntitiesHydrator", F.ENTITIES, _h_entities),
    ("CardHydrator", F.CARD, _h_card),
    ("PlaceHydrator", F.PLACE, _h_place),
    ("ConversationIdHydrator", F.CONVERSATION, _h_conversation),
    ("DirectedAtHydrator", F.DIRECTED, _h_directed),
    ("EditControlHydrator", F.EDIT, _h_edit),
    ("PerspectiveHydrator", F.PERSPECTIVE, _h_perspective),
    ("DeviceSourceHydrator", F.SOURCE, _h_source),
    ("ContributorHydrator", F.CONTRIBUTOR, _h_contributor),
    ("TakedownHydrator", F.TAKEDOWN, _h_takedown),
    ("SelfThreadHydrator", F.SELF_THREAD, _h_self_thread),
    ("NoteTweetSuffixHydrator", F.NOTE, _h_note),
    ("PreviousTweetCountsHydrator", F.PREVIOUS_COUNTS, _h_previous_counts),
    ("MediaRefsHydrator", F.MEDIA_REFS, _h_media_refs),
)
del F


# -- takedowns (country-withheld content) ----------------------------------------


class TakedownStore:
    """Per-country content takedowns (≡ the takedown write path +
    ``visibility`` country-withheld rules)."""

    def __init__(self):
        self._withheld: Dict[int, Set[str]] = {}

    def withhold(self, tweet_id: int, countries: Sequence[str]) -> None:
        self._withheld.setdefault(int(tweet_id), set()).update(
            c.upper() for c in countries
        )

    def is_withheld(self, tweet_id: int, country: Optional[str]) -> bool:
        if country is None:
            return False
        return country.upper() in self._withheld.get(int(tweet_id), ())

    def countries(self, tweet_id: int) -> Set[str]:
        return set(self._withheld.get(int(tweet_id), ()))


# -- read-through cache (the memcache layer) --------------------------------------


class CachingTweetStore:
    """Read-through LRU in front of :class:`TweetStore` with write
    invalidation and negative caching (≡ the memcached tweet cache the read
    path consults before Manhattan; ``repository/CachingTweetRepository``).
    """

    def __init__(self, store: TweetStore, capacity: int = 4096):
        from collections import OrderedDict

        self._store = store
        self._cap = capacity
        self._cache: "OrderedDict[tuple, HydratedTweet]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _key(self, tid: int, fields: HydrationField):
        return (int(tid), int(fields.value))

    def get_tweets(
        self, tweet_ids: Sequence[int],
        fields: HydrationField = HydrationField.CORE,
    ) -> List[HydratedTweet]:
        out: List[Optional[HydratedTweet]] = [None] * len(tweet_ids)
        missing: List[int] = []
        pos: List[int] = []
        for i, tid in enumerate(tweet_ids):
            k = self._key(tid, fields)
            hit = self._cache.get(k)
            if hit is not None:
                self._cache.move_to_end(k)
                out[i] = hit
                self.hits += 1
            else:
                missing.append(tid)
                pos.append(i)
                self.misses += 1
        if missing:
            fetched = self._store.get_tweets(missing, fields)
            for i, h in zip(pos, fetched):
                out[i] = h
                k = self._key(h.tweet_id, fields)
                self._cache[k] = h  # negative results cached too (!found)
                if len(self._cache) > self._cap:
                    self._cache.popitem(last=False)
        return out  # type: ignore[return-value]

    def invalidate(self, tweet_id: int) -> None:
        """Write-path invalidation (create/delete/count bump)."""
        for k in [k for k in self._cache if k[0] == int(tweet_id)]:
            del self._cache[k]


# -- earlybird ingester bridge ----------------------------------------------------


def to_raw_tweet(store: TweetStore, tweet: Tweet, *, now: int = 0,
                 language: str = "en", user_rep: float = 0.0):
    """Tweet → earlybird ``RawTweet`` with conversation metadata resolved —
    the tweetypie→ingester event bridge (the reference's ingester consumes
    tweetypie create events; ``src/java/com/twitter/search/ingester/``)."""
    from the_algorithm_tpu_torch.search.earlybird import RawTweet

    ents = extract_entities(tweet.text)
    root, depth, self_thread = ConversationResolver(store).resolve(tweet)
    root_t = store._tweets.get(root)
    return RawTweet(
        tweet_id=tweet.tweet_id,
        author_id=tweet.author_id,
        created_ts=tweet.created_ts,
        text=tweet.text,
        language=language,
        fav_count=tweet.fav_count,
        reply_count=tweet.reply_count,
        retweet_count=tweet.retweet_count,
        quote_count=tweet.quote_count,
        has_image=any(m.endswith((".jpg", ".png")) for m in tweet.media),
        has_video=any(m.endswith((".mp4", ".m3u8")) for m in tweet.media),
        has_card=ents.has_card,
        is_reply=tweet.reply_to is not None,
        is_quote=tweet.quoted_tweet_id is not None,
        user_rep=user_rep,
        num_likes_root=root_t.fav_count if root_t else 0,
        num_replies_root=root_t.reply_count if root_t else 0,
        conversation_depth=depth,
        is_self_thread=self_thread,
    )


# -- the write path (PostTweet / DeleteTweet / UndeleteTweet / EditTweet) --------


class WriteError(ValueError):
    """≡ the write path's TweetCreateFailure states."""


@dataclasses.dataclass(frozen=True)
class WriteEvent:
    """One async-fanout event (≡ tweetypie's async_insert/async_delete
    events consumed by the ingester, timelines, and cache layers)."""

    kind: str  # "create" | "delete" | "undelete" | "edit"
    tweet: "Tweet"
    edit_of: Optional[int] = None


class TweetWriteService:
    """The full write pipeline ≡ ``tweetypie/server/.../handler/
    {PostTweet,DeleteTweet,UndeleteTweet,EditTweet}Handler.scala`` +
    ``hydrator/TweetHydration.scala``'s write-side enrichment:

    id assignment (snowflake-style time-ordered), validation, entity
    extraction, conversation-id resolution, edit-chain maintenance with
    CHAIN-scoped delete/undelete/takedown semantics (every version of an
    edited tweet shares lifetime and withholding), and async fanout hooks
    (the event bus the search ingester / timelines / caches consume).
    """

    MAX_TEXT_LEN = 4000
    EDIT_WINDOW_S = 3600  # the reference's edit window
    MAX_EDITS = 5
    HOOK_ERRORS_KEPT = 64  # each exception's traceback holds its event's frames

    def __init__(
        self,
        store: Optional[TweetStore] = None,
        edits: Optional[EditChainStore] = None,
        takedowns: Optional[TakedownStore] = None,
        cache: Optional[CachingTweetStore] = None,
    ):
        self.store = store if store is not None else TweetStore()
        self.edits = edits if edits is not None else EditChainStore()
        self.takedowns = takedowns if takedowns is not None else TakedownStore()
        self.cache = cache
        self.resolver = ConversationResolver(self.store)
        self._hooks: Dict[str, List] = {
            "create": [], "delete": [], "undelete": [], "edit": []}
        self._seq = 0
        self._last_ts = -1
        self._lock = threading.Lock()
        # how many fanout hooks raised, and the last (event, exception)
        # pairs in order: a hook never fails the write, and its failure
        # stays visible here
        self.hook_failures = 0
        self.hook_errors: Deque[tuple] = collections.deque(maxlen=self.HOOK_ERRORS_KEPT)

    # -- id assignment (snowflake analog: time-ordered, unique) -------------

    def next_id(self, now: int) -> int:
        with self._lock:
            if now == self._last_ts:
                self._seq += 1
            else:
                self._last_ts, self._seq = now, 0
            return (int(now) << 12) | self._seq

    # -- fanout hooks --------------------------------------------------------

    def on(self, kind: str, hook) -> None:
        """Register an async-fanout consumer: hook(WriteEvent)."""
        self._hooks[kind].append(hook)

    def _fanout(self, event: WriteEvent) -> None:
        if self.cache is not None:
            self.cache.invalidate(event.tweet.tweet_id)
        for hook in self._hooks[event.kind]:
            try:
                hook(event)  # fire-and-forget (errors never fail the write)
            except Exception as e:
                with self._lock:
                    self.hook_failures += 1
                    self.hook_errors.append((event, e))

    # -- create --------------------------------------------------------------

    def post_tweet(
        self,
        author_id: int,
        text: str,
        *,
        now: int,
        reply_to: Optional[int] = None,
        quoted_tweet_id: Optional[int] = None,
        media: Sequence[str] = (),
    ) -> Tweet:
        if not text.strip():
            raise WriteError("empty text")
        if len(text) > self.MAX_TEXT_LEN:
            raise WriteError("text too long")
        for ref, name in ((reply_to, "reply_to"),
                          (quoted_tweet_id, "quoted_tweet_id")):
            if ref is not None:
                parent = self.store._tweets.get(ref)
                if parent is None or parent.deleted:
                    raise WriteError(f"{name} {ref} not found")
        t = Tweet(
            tweet_id=self.next_id(now), author_id=int(author_id),
            text=text, created_ts=int(now), reply_to=reply_to,
            quoted_tweet_id=quoted_tweet_id, media=tuple(media),
        )
        # write-side enrichment: conversation id (the root of the reply
        # chain — a root tweet starts its own conversation)
        self.store.create(t)
        root, _, _ = self.resolver.resolve(t)
        t.conversation_id = root
        self._fanout(WriteEvent("create", t))
        return t

    # -- delete / undelete (CHAIN-scoped) ------------------------------------

    def _chain_ids(self, tweet_id: int) -> List[int]:
        return self.edits.versions(tweet_id)

    def delete_tweet(self, tweet_id: int) -> List[int]:
        """Soft-delete the tweet AND every version of its edit chain
        (versions share lifetime). Returns the deleted ids."""
        deleted = []
        for vid in self._chain_ids(tweet_id):
            if self.store.delete(vid):
                deleted.append(vid)
                t = self.store._tweets[vid]
                self._fanout(WriteEvent("delete", t))
        if not deleted:
            raise WriteError(f"tweet {tweet_id} not found")
        return deleted

    def undelete_tweet(self, tweet_id: int) -> List[int]:
        """Restore the full edit chain (the UndeleteTweet handler)."""
        restored = []
        for vid in self._chain_ids(tweet_id):
            t = self.store._tweets.get(vid)
            if t is not None and t.deleted:
                t.deleted = False
                restored.append(vid)
                self._fanout(WriteEvent("undelete", t))
        if not restored:
            raise WriteError(f"tweet {tweet_id} not deleted")
        return restored

    # -- edit -----------------------------------------------------------------

    def edit_tweet(self, tweet_id: int, new_text: str, *, now: int) -> Tweet:
        """A NEW version tweet joins the edit chain; the old version
        becomes stale (editControl semantics)."""
        orig = self.store._tweets.get(self.edits.latest(tweet_id))
        if orig is None or orig.deleted:
            raise WriteError(f"tweet {tweet_id} not editable (missing)")
        initial_id = self.edits.versions(tweet_id)[0]
        initial = self.store._tweets.get(initial_id)
        if initial is None:
            raise WriteError("edit chain root missing")
        if now - initial.created_ts > self.EDIT_WINDOW_S:
            raise WriteError("edit window elapsed")
        if len(self.edits.versions(tweet_id)) > self.MAX_EDITS:
            raise WriteError("edit limit reached")
        if not new_text.strip():
            raise WriteError("empty text")
        v = Tweet(
            tweet_id=self.next_id(now), author_id=orig.author_id,
            text=new_text, created_ts=orig.created_ts,
            reply_to=orig.reply_to, quoted_tweet_id=orig.quoted_tweet_id,
            media=tuple(orig.media),
            conversation_id=orig.conversation_id,
        )
        self.store.create(v)
        self.edits.record_edit(initial_id, v.tweet_id)
        # takedowns are chain-scoped: a new version inherits withholdings
        for c in self.takedowns.countries(initial_id):
            self.takedowns.withhold(v.tweet_id, [c])
        self._fanout(WriteEvent("edit", v, edit_of=orig.tweet_id))
        return v

    # -- takedowns (chain-scoped) --------------------------------------------

    def takedown(self, tweet_id: int, countries: Sequence[str]) -> None:
        """Withhold EVERY version of the edit chain in the countries —
        editing a tweet must never escape a takedown."""
        for vid in self._chain_ids(tweet_id):
            self.takedowns.withhold(vid, countries)


def ingester_fanout(write_service: "TweetWriteService", ingester) -> None:
    """Wire the write path's async events into the earlybird ingester —
    the tweetypie→search event bridge (create/edit index; delete
    tombstones; undelete re-ingests)."""

    def on_create(ev: WriteEvent):
        ingester.ingest_tweets(
            [to_raw_tweet(write_service.store, ev.tweet,
                          now=ev.tweet.created_ts)],
            now=ev.tweet.created_ts)

    def on_delete(ev: WriteEvent):
        ingester.delete_tweets([ev.tweet.tweet_id])

    write_service.on("create", on_create)
    write_service.on("edit", on_create)
    write_service.on("undelete", on_create)
    write_service.on("delete", on_delete)
