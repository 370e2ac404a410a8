"""Unified User Actions: one normalized action stream from many sources.

A host copy of ``the_algorithm_tpu/actions/uua.py`` (pure Python; the JAX
package's modules cannot be imported without JAX), ≡
``unified_user_actions/``: per-source adapters normalize heterogeneous event
payloads into ``UnifiedUserAction`` records; the enricher runs a per-event
plan of repartition + hydration stages against pluggable hydrators (with a
``NoopHydrator`` null object). ``training/labels.py`` joins these records
to served candidates.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence


class ActionType(enum.Enum):
    """≡ uua thrift ActionType (the serving-relevant subset)."""

    CLIENT_TWEET_FAV = "client_tweet_fav"
    CLIENT_TWEET_UNFAV = "client_tweet_unfav"
    CLIENT_TWEET_RETWEET = "client_tweet_retweet"
    CLIENT_TWEET_REPLY = "client_tweet_reply"
    CLIENT_TWEET_QUOTE = "client_tweet_quote"
    CLIENT_TWEET_CLICK = "client_tweet_click"
    CLIENT_TWEET_VIDEO_PLAYBACK_50 = "client_tweet_video_playback_50"
    CLIENT_TWEET_IMPRESSION = "client_tweet_impression"
    CLIENT_PROFILE_VISIT = "client_profile_visit"
    CLIENT_FOLLOW = "client_follow"
    CLIENT_UNFOLLOW = "client_unfollow"
    CLIENT_BLOCK = "client_block"
    CLIENT_MUTE = "client_mute"
    CLIENT_TWEET_REPORT = "client_tweet_report"
    CLIENT_TWEET_NOT_INTERESTED = "client_tweet_not_interested"
    SERVER_TWEET_FAV = "server_tweet_fav"
    SERVER_TWEET_UNFAV = "server_tweet_unfav"
    SERVER_TWEET_CREATE = "server_tweet_create"
    SERVER_TWEET_DELETE = "server_tweet_delete"
    SERVER_FOLLOW = "server_follow"
    # tweetypie create/delete kinds (TweetypieEventAdapter)
    SERVER_TWEET_REPLY = "server_tweet_reply"
    SERVER_TWEET_RETWEET = "server_tweet_retweet"
    SERVER_TWEET_QUOTE = "server_tweet_quote"
    SERVER_TWEET_EDIT = "server_tweet_edit"
    SERVER_TWEET_UNREPLY = "server_tweet_unreply"
    SERVER_TWEET_UNRETWEET = "server_tweet_unretweet"
    SERVER_TWEET_UNQUOTE = "server_tweet_unquote"
    # social-graph server ops (SocialGraphAdapter)
    SERVER_UNFOLLOW = "server_unfollow"
    SERVER_BLOCK = "server_block"
    SERVER_UNBLOCK = "server_unblock"
    SERVER_MUTE = "server_mute"
    SERVER_UNMUTE = "server_unmute"
    SERVER_USER_REPORT = "server_user_report"
    # ads spend-server callbacks (AdsCallbackEngagementsAdapter)
    SERVER_PROMOTED_TWEET_FAV = "server_promoted_tweet_fav"
    SERVER_PROMOTED_TWEET_UNFAV = "server_promoted_tweet_unfav"
    SERVER_PROMOTED_TWEET_REPLY = "server_promoted_tweet_reply"
    SERVER_PROMOTED_TWEET_RETWEET = "server_promoted_tweet_retweet"
    SERVER_PROMOTED_TWEET_CLICK = "server_promoted_tweet_click"
    SERVER_PROMOTED_TWEET_REPORT = "server_promoted_tweet_report"
    SERVER_PROMOTED_TWEET_BLOCK_AUTHOR = "server_promoted_tweet_block_author"
    SERVER_PROMOTED_TWEET_MUTE_AUTHOR = "server_promoted_tweet_mute_author"
    SERVER_PROMOTED_TWEET_CLICK_PROFILE = "server_promoted_tweet_click_profile"
    SERVER_PROMOTED_TWEET_VIDEO_PLAYBACK_50 = (
        "server_promoted_tweet_video_playback_50"
    )
    SERVER_PROMOTED_PROFILE_FOLLOW = "server_promoted_profile_follow"
    SERVER_PROMOTED_PROFILE_UNFOLLOW = "server_promoted_profile_unfollow"
    # email notifications (EmailNotificationEventAdapter)
    CLIENT_TWEET_EMAIL_CLICK = "client_tweet_email_click"
    # archival streams (Favorite/RetweetArchivalEventsAdapter)
    SERVER_TWEET_ARCHIVE_FAVORITE = "server_tweet_archive_favorite"
    SERVER_TWEET_UNARCHIVE_FAVORITE = "server_tweet_unarchive_favorite"
    SERVER_TWEET_ARCHIVE_RETWEET = "server_tweet_archive_retweet"
    SERVER_TWEET_UNARCHIVE_RETWEET = "server_tweet_unarchive_retweet"
    # user modifications (UserModificationAdapter)
    SERVER_USER_CREATE = "server_user_create"
    SERVER_USER_UPDATE = "server_user_update"
    # video client events (VideoClientEventUtils)
    CLIENT_TWEET_VIDEO_PLAYBACK_25 = "client_tweet_video_playback_25"
    CLIENT_TWEET_VIDEO_PLAYBACK_75 = "client_tweet_video_playback_75"
    CLIENT_TWEET_VIDEO_PLAYBACK_95 = "client_tweet_video_playback_95"
    CLIENT_TWEET_VIDEO_QUALITY_VIEW = "client_tweet_video_quality_view"
    # behavioral client events the heavy-ranker heads train on
    # (BehavioralClientEventAdapter: bookmark/share/linger/open-link/screenshot)
    CLIENT_TWEET_BOOKMARK = "client_tweet_bookmark"
    CLIENT_TWEET_SHARE = "client_tweet_share"
    CLIENT_TWEET_LINGER = "client_tweet_linger"
    CLIENT_TWEET_OPEN_LINK = "client_tweet_open_link"
    CLIENT_TWEET_SCREENSHOT = "client_tweet_screenshot"


NEGATIVE_ACTIONS = {
    ActionType.CLIENT_BLOCK,
    ActionType.CLIENT_MUTE,
    ActionType.CLIENT_TWEET_REPORT,
    ActionType.CLIENT_TWEET_NOT_INTERESTED,
}


@dataclasses.dataclass(frozen=True)
class UnifiedUserAction:
    """≡ thrift ``UnifiedUserAction`` (userIdentifier, item, actionType,
    eventMetadata, productSurface)."""

    user_id: int
    action_type: ActionType
    item_id: int  # tweet id or target user id
    timestamp_ms: int
    author_id: Optional[int] = None
    product_surface: Optional[str] = None  # e.g. "home", "search"
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)


# -- adapters ----------------------------------------------------------------

_CLIENT_EVENT_MAP = {
    ("tweet", "favorite"): ActionType.CLIENT_TWEET_FAV,
    ("tweet", "unfavorite"): ActionType.CLIENT_TWEET_UNFAV,
    ("tweet", "retweet"): ActionType.CLIENT_TWEET_RETWEET,
    ("tweet", "reply"): ActionType.CLIENT_TWEET_REPLY,
    ("tweet", "quote"): ActionType.CLIENT_TWEET_QUOTE,
    ("tweet", "click"): ActionType.CLIENT_TWEET_CLICK,
    ("tweet", "impression"): ActionType.CLIENT_TWEET_IMPRESSION,
    ("tweet", "report"): ActionType.CLIENT_TWEET_REPORT,
    ("tweet", "not_interested"): ActionType.CLIENT_TWEET_NOT_INTERESTED,
    ("video", "playback_50"): ActionType.CLIENT_TWEET_VIDEO_PLAYBACK_50,
    ("profile", "visit"): ActionType.CLIENT_PROFILE_VISIT,
    ("user", "follow"): ActionType.CLIENT_FOLLOW,
    ("user", "unfollow"): ActionType.CLIENT_UNFOLLOW,
    ("user", "block"): ActionType.CLIENT_BLOCK,
    ("user", "mute"): ActionType.CLIENT_MUTE,
    # behavioral client events (BehavioralClientEventAdapter) — these feed
    # the bookmark/share/dwell/open_link/screenshot label heads
    ("tweet", "bookmark"): ActionType.CLIENT_TWEET_BOOKMARK,
    ("tweet", "share"): ActionType.CLIENT_TWEET_SHARE,
    ("tweet", "linger"): ActionType.CLIENT_TWEET_LINGER,
    ("tweet", "open_link"): ActionType.CLIENT_TWEET_OPEN_LINK,
    ("tweet", "screenshot"): ActionType.CLIENT_TWEET_SCREENSHOT,
    ("video", "quality_view"): ActionType.CLIENT_TWEET_VIDEO_QUALITY_VIEW,
}


def client_event_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``ClientEventAdapter``: one raw LogEvent → 0..n UUAs.

    Expected raw shape: {user_id, item_type, action, item_id, ts_ms,
    author_id?, surface?}. Unknown (item_type, action) pairs drop (the
    adapter's job is exactly this normalization + filtering).
    """
    key = (event.get("item_type"), event.get("action"))
    action = _CLIENT_EVENT_MAP.get(key)
    if action is None:
        return []
    if event.get("user_id") is None or event.get("item_id") is None:
        return []
    return [
        UnifiedUserAction(
            user_id=int(event["user_id"]),
            action_type=action,
            item_id=int(event["item_id"]),
            timestamp_ms=int(event.get("ts_ms", 0)),
            author_id=event.get("author_id"),
            product_surface=event.get("surface"),
            metadata={
                k: v
                for k, v in event.items()
                if k not in {
                    "user_id", "item_type", "action", "item_id", "ts_ms",
                    "author_id", "surface",
                }
            },
        )
    ]


def tls_favs_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``TlsFavsAdapter``: server-side fav/unfav (timeline service)."""
    kind = event.get("fav_type")
    mapping = {
        "fav": ActionType.SERVER_TWEET_FAV,
        "unfav": ActionType.SERVER_TWEET_UNFAV,
    }
    if kind not in mapping:
        return []
    return [
        UnifiedUserAction(
            user_id=int(event["user_id"]),
            action_type=mapping[kind],
            item_id=int(event["tweet_id"]),
            timestamp_ms=int(event.get("ts_ms", 0)),
            author_id=event.get("author_id"),
        )
    ]


_SOCIAL_GRAPH_OPS = {
    "follow": ActionType.SERVER_FOLLOW,
    "unfollow": ActionType.SERVER_UNFOLLOW,
    "block": ActionType.SERVER_BLOCK,
    "unblock": ActionType.SERVER_UNBLOCK,
    "mute": ActionType.SERVER_MUTE,
    "unmute": ActionType.SERVER_UNMUTE,
    "report": ActionType.SERVER_USER_REPORT,
}


def social_graph_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``SocialGraphAdapter``: server-side graph write events
    (follow/unfollow/block/unblock/mute/unmute/report)."""
    action = _SOCIAL_GRAPH_OPS.get(event.get("op"))
    if action is None:
        return []
    if event.get("source_id") is None or event.get("target_id") is None:
        return []
    return [
        UnifiedUserAction(
            user_id=int(event["source_id"]),
            action_type=action,
            item_id=int(event["target_id"]),
            timestamp_ms=int(event.get("ts_ms", 0)),
        )
    ]


# -- enricher ---------------------------------------------------------------


class Hydrator:
    """Enrichment stage: annotate a UUA (e.g. author lookup)."""

    def hydrate(self, action: UnifiedUserAction) -> UnifiedUserAction:
        raise NotImplementedError


class NoopHydrator(Hydrator):
    """≡ the reference's NoopHydrator null object."""

    def hydrate(self, action: UnifiedUserAction) -> UnifiedUserAction:
        return action


class AuthorHydrator(Hydrator):
    """Fill author_id from a tweet→author store (the repartition+hydrate
    stage in ``enricher/``)."""

    def __init__(self, tweet_author: Mapping[int, int]):
        self.tweet_author = tweet_author

    def hydrate(self, action: UnifiedUserAction) -> UnifiedUserAction:
        if action.author_id is not None:
            return action
        author = self.tweet_author.get(action.item_id)
        if author is None:
            return action
        return dataclasses.replace(action, author_id=author)


@dataclasses.dataclass(frozen=True)
class EnrichmentStage:
    """≡ ``EnrichmentStage``: partition key + hydrator."""

    key_fn: Callable[[UnifiedUserAction], Any]  # the repartition key
    hydrator: Hydrator


@dataclasses.dataclass(frozen=True)
class EnrichmentPlan:
    stages: Sequence[EnrichmentStage]


def enrich(
    actions: Sequence[UnifiedUserAction], plan: EnrichmentPlan
) -> List[UnifiedUserAction]:
    """≡ enricher driver: run each stage over the (re-keyed) stream."""
    out = list(actions)
    for stage in plan.stages:
        # repartition = stable sort by key (locality for the hydrator)
        out.sort(key=lambda a: (str(stage.key_fn(a)),))
        out = [stage.hydrator.hydrate(a) for a in out]
    return out
