"""UUA adapter catalog: one normalizer per upstream source stream.

Counterpart of ``the_algorithm_tpu/actions/uua_adapters.py``, copied over
the port's ``actions/uua``.

≡ ``unified_user_actions/adapter/src/main/scala/.../adapter/`` — the
reference ships an adapter package per Kafka source (client_event,
tls_favs_event, social_graph_event, tweetypie_event,
ads_callback_engagements, email_notification_event,
favorite_archival_events, retweet_archival_events, user_modification_event,
uua_aggregates rekey adapters) with table-driven specs
(``adapter/src/test/scala/...``, 16 spec files). Each adapter is a pure
function ``raw event dict → [UnifiedUserAction]`` — unknown shapes drop,
matching the reference's normalize-and-filter contract.

The three original adapters (client_event, tls_favs, social_graph) live in
:mod:`the_algorithm_tpu_torch.actions.uua`; this module completes the catalog and
registers everything in :data:`ADAPTERS`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional

from the_algorithm_tpu_torch.actions.uua import (
    ActionType,
    UnifiedUserAction,
    client_event_adapter,
    social_graph_adapter,
    tls_favs_adapter,
)

Adapter = Callable[[Mapping[str, Any]], List[UnifiedUserAction]]


def _uua(user, action, item, ts, author=None, surface=None, **meta):
    return UnifiedUserAction(
        user_id=int(user), action_type=action, item_id=int(item),
        timestamp_ms=int(ts), author_id=author, product_surface=surface,
        metadata=meta,
    )


# -- tweetypie_event ----------------------------------------------------------

def tweet_kind(tweet: Mapping[str, Any]) -> Optional[str]:
    """≡ ``TweetypieEventUtils.tweetTypeFromTweet``: classify by which of
    reply/share/quote/edit fields are present; contradictory shapes drop."""
    reply = tweet.get("in_reply_to_status_id") is not None
    share = tweet.get("share_source_tweet_id") is not None  # any retweet
    quote = tweet.get("quoted_tweet_id") is not None
    edit = tweet.get("initial_tweet_id") is not None
    if reply and not share and not edit:
        return "reply"
    if share and not reply and not edit:
        return "retweet"
    if quote and not (reply or share or edit):
        return "quote"
    if edit and not (reply or share):
        return "edit"
    if not (reply or share or quote or edit):
        return "default"
    return None  # contradictory (reply+retweet etc.)


_TWEETYPIE_CREATE = {
    "default": ActionType.SERVER_TWEET_CREATE,
    "reply": ActionType.SERVER_TWEET_REPLY,
    "retweet": ActionType.SERVER_TWEET_RETWEET,
    "quote": ActionType.SERVER_TWEET_QUOTE,
    "edit": ActionType.SERVER_TWEET_EDIT,
}
_TWEETYPIE_DELETE = {
    "default": ActionType.SERVER_TWEET_DELETE,
    "reply": ActionType.SERVER_TWEET_UNREPLY,
    "retweet": ActionType.SERVER_TWEET_UNRETWEET,
    "quote": ActionType.SERVER_TWEET_UNQUOTE,
    "edit": ActionType.SERVER_TWEET_DELETE,
}


def tweetypie_event_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``TweetypieEventAdapter``: tweet create/delete events classified by
    kind (create/reply/retweet/quote/edit) into distinct server actions.

    Create events act on the related tweet for replies/quotes/retweets (the
    replied-to / quoted / source tweet is the engaged item); deletes act on
    the deleted tweet itself.
    """
    kind_field = event.get("event")
    tweet = event.get("tweet") or {}
    user = tweet.get("user_id")
    tid = tweet.get("tweet_id")
    if kind_field not in ("create", "delete") or user is None or tid is None:
        return []
    k = tweet_kind(tweet)
    if k is None:
        return []
    if kind_field == "create":
        action = _TWEETYPIE_CREATE[k]
        item = {
            "default": tid,
            "edit": tid,
            "reply": tweet.get("in_reply_to_status_id"),
            "retweet": tweet.get("share_source_tweet_id"),
            "quote": tweet.get("quoted_tweet_id"),
        }[k]
    else:
        action = _TWEETYPIE_DELETE[k]
        item = tid
    return [
        _uua(
            user, action, item, event.get("ts_ms", 0),
            author=tweet.get("in_reply_to_user_id")
            or tweet.get("share_source_user_id"),
            created_tweet_id=tid,
        )
    ]


# -- ads_callback_engagements -------------------------------------------------

_ADS_ENGAGEMENT_MAP = {
    # ≡ EngagementTypeMappings / AdsCallbackEngagement objects
    "fav": ActionType.SERVER_PROMOTED_TWEET_FAV,
    "unfav": ActionType.SERVER_PROMOTED_TWEET_UNFAV,
    "reply": ActionType.SERVER_PROMOTED_TWEET_REPLY,
    "retweet": ActionType.SERVER_PROMOTED_TWEET_RETWEET,
    "click": ActionType.SERVER_PROMOTED_TWEET_CLICK,
    "report": ActionType.SERVER_PROMOTED_TWEET_REPORT,
    "block_author": ActionType.SERVER_PROMOTED_TWEET_BLOCK_AUTHOR,
    "mute_author": ActionType.SERVER_PROMOTED_TWEET_MUTE_AUTHOR,
    "click_profile": ActionType.SERVER_PROMOTED_TWEET_CLICK_PROFILE,
    "video_playback_50": ActionType.SERVER_PROMOTED_TWEET_VIDEO_PLAYBACK_50,
}
_ADS_PROFILE_MAP = {
    "follow": ActionType.SERVER_PROMOTED_PROFILE_FOLLOW,
    "unfollow": ActionType.SERVER_PROMOTED_PROFILE_UNFOLLOW,
}


def ads_callback_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``AdsCallbackEngagementsAdapter``: spend-server engagement callbacks
    on promoted tweets/profiles → server promoted-* actions."""
    eng = event.get("engagement_type")
    user = event.get("user_id")
    ts = event.get("ts_ms", 0)
    if user is None:
        return []
    if eng in _ADS_PROFILE_MAP and event.get("profile_id") is not None:
        return [
            _uua(user, _ADS_PROFILE_MAP[eng], event["profile_id"], ts,
                 promoted=True)
        ]
    if eng in _ADS_ENGAGEMENT_MAP and event.get("tweet_id") is not None:
        return [
            _uua(user, _ADS_ENGAGEMENT_MAP[eng], event["tweet_id"], ts,
                 author=event.get("author_id"), promoted=True)
        ]
    return []


# -- email_notification_event -------------------------------------------------

def extract_tweet_id_from_path(path: Optional[str]) -> Optional[int]:
    """≡ ``EmailNotificationEventUtils.extractTweetId``: the tweet id is the
    trailing numeric segment of the notification's landing URL path."""
    if not path:
        return None
    seg = path.rstrip("/").rsplit("/", 1)[-1]
    # strip query fragments the scribe sometimes keeps
    seg = seg.split("?", 1)[0]
    return int(seg) if seg.isdigit() else None


def email_notification_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``EmailNotificationEventAdapter``: only Click scribes with a
    parseable tweet id AND an impression id produce a UUA."""
    if event.get("type") != "click":
        return []
    tweet_id = extract_tweet_id_from_path(event.get("path"))
    if tweet_id is None or event.get("impression_id") is None:
        return []
    if event.get("user_id") is None:
        return []
    return [
        _uua(
            event["user_id"], ActionType.CLIENT_TWEET_EMAIL_CLICK, tweet_id,
            event.get("ts_ms", 0), surface="email_notification",
            impression_id=event["impression_id"],
        )
    ]


# -- favorite / retweet archival ----------------------------------------------

def favorite_archival_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``FavoriteArchivalEventsAdapter``: archive defaults to True when the
    flag is absent; the acted-on tweet is ALWAYS tweet_id (not source)."""
    if event.get("favoriter_id") is None or event.get("tweet_id") is None:
        return []
    archiving = event.get("is_archiving_action")
    action = (
        ActionType.SERVER_TWEET_ARCHIVE_FAVORITE
        if (archiving is None or archiving)
        else ActionType.SERVER_TWEET_UNARCHIVE_FAVORITE
    )
    return [
        _uua(
            event["favoriter_id"], action, event["tweet_id"],
            event.get("ts_ms", 0), author=event.get("tweet_user_id"),
            retweeted_tweet_id=event.get("source_tweet_id"),
        )
    ]


def retweet_archival_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``RetweetArchivalEventsAdapter``: acts on the SOURCE tweet; the
    retweeting tweet id rides in metadata."""
    if event.get("retweet_user_id") is None or event.get("src_tweet_id") is None:
        return []
    archiving = event.get("is_archiving_action")
    action = (
        ActionType.SERVER_TWEET_ARCHIVE_RETWEET
        if (archiving is None or archiving)
        else ActionType.SERVER_TWEET_UNARCHIVE_RETWEET
    )
    return [
        _uua(
            event["retweet_user_id"], action, event["src_tweet_id"],
            event.get("ts_ms", 0), author=event.get("src_tweet_user_id"),
            retweeting_tweet_id=event.get("retweet_id"),
        )
    ]


# -- user_modification_event ----------------------------------------------------

def user_modification_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``UserModificationAdapter``: create/update produce profile actions;
    destroy/erase intentionally produce nothing."""
    user = event.get("user_id")
    if user is None:
        return []
    if event.get("create") is not None:
        return [
            _uua(user, ActionType.SERVER_USER_CREATE, user,
                 event.get("ts_ms", 0))
        ]
    if event.get("update") is not None:
        return [
            _uua(user, ActionType.SERVER_USER_UPDATE, user,
                 event.get("ts_ms", 0),
                 updated_fields=tuple(event.get("update") or ()))
        ]
    return []  # destroy / erase → no UUA


# -- uua_aggregates rekey adapters ---------------------------------------------

def rekey_uua_adapter(action: UnifiedUserAction):
    """≡ ``RekeyUuaAdapter``: UUA stream → (user_id-keyed, UUA) pairs for
    downstream keyed aggregation (the USS/RealGraph consumers)."""
    return [(action.user_id, action)]


def rekey_from_interaction_events_adapter(
    event: Mapping[str, Any],
) -> List[UnifiedUserAction]:
    """≡ ``RekeyUuaFromInteractionEventsAdapter``: behavioral-client tweet
    impression events → ClientTweetImpression keyed by user."""
    if event.get("interaction_type") != "impression":
        return []
    if event.get("user_id") is None or event.get("tweet_id") is None:
        return []
    return [
        _uua(
            event["user_id"], ActionType.CLIENT_TWEET_IMPRESSION,
            event["tweet_id"], event.get("ts_ms", 0),
            author=event.get("author_id"), surface=event.get("surface"),
        )
    ]


# -- topic-id + search-info extraction utils ----------------------------------

# client-event namespaces that carry topic context (≡ TopicsIdUtils:
# suggestionDetails topic ids, timelines-topic controller data, onboarding)
_TOPIC_ID_KEYS = ("topic_id", "suggestion_topic_id", "controller_topic_id")


def topic_ids_from_event(event: Mapping[str, Any]) -> List[int]:
    """≡ ``TopicsIdUtils.getTopicIds``: every topic id the raw client event
    carries, across the suggestion/controller-data/onboarding channels."""
    out = []
    for k in _TOPIC_ID_KEYS:
        v = event.get(k)
        if v is not None:
            out.append(int(v))
    for v in event.get("topic_ids", ()) or ():
        out.append(int(v))
    return sorted(set(out))


def search_info(event: Mapping[str, Any]) -> Optional[Mapping[str, Any]]:
    """≡ ``SearchInfoUtils``: query + result metadata from a search-surface
    client event (``searchDetails``): the query string and the 1-based rank
    of the engaged result, used to build TweetSearchResult UUA metadata."""
    if event.get("surface") != "search":
        return None
    details = event.get("search_details") or {}
    q = details.get("query") or event.get("query")
    if q is None:
        return None
    info = {"query": str(q)}
    if details.get("rank") is not None:
        info["rank"] = int(details["rank"])
    if details.get("query_filter_type") is not None:
        info["query_filter_type"] = str(details["query_filter_type"])
    return info


def enriched_client_event_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """Client-event adaptation + topic/search metadata enrichment — the full
    ``ClientEventAdapter`` surface (its spec exercises topic-id and
    search-info extraction alongside the action mapping)."""
    from the_algorithm_tpu_torch.actions.uua import client_event_adapter

    actions = client_event_adapter(event)
    topics = topic_ids_from_event(event)
    sinfo = search_info(event)
    for a in actions:
        if topics:
            a.metadata["topic_ids"] = topics
        if sinfo is not None:
            a.metadata["search_info"] = sinfo
    return actions


# -- video client-event util -----------------------------------------------------

_VIDEO_PLAYBACK_MAP = {
    25: ActionType.CLIENT_TWEET_VIDEO_PLAYBACK_25,
    50: ActionType.CLIENT_TWEET_VIDEO_PLAYBACK_50,
    75: ActionType.CLIENT_TWEET_VIDEO_PLAYBACK_75,
    95: ActionType.CLIENT_TWEET_VIDEO_PLAYBACK_95,
}


def video_client_event_adapter(event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """≡ ``VideoClientEventUtils`` + the video client-event paths: playback
    percentage milestones and quality views on the tweet's video."""
    user, tid = event.get("user_id"), event.get("tweet_id")
    if user is None or tid is None:
        return []
    ts = event.get("ts_ms", 0)
    if event.get("quality_view"):
        return [
            _uua(user, ActionType.CLIENT_TWEET_VIDEO_QUALITY_VIEW, tid, ts,
                 video_id=event.get("video_id"))
        ]
    pct = event.get("playback_percentage")
    action = _VIDEO_PLAYBACK_MAP.get(pct)
    if action is None:
        return []
    return [_uua(user, action, tid, ts, video_id=event.get("video_id"))]


# -- the registry --------------------------------------------------------------

ADAPTERS: Mapping[str, Adapter] = {
    "client_event": enriched_client_event_adapter,
    "tls_favs": tls_favs_adapter,
    "social_graph": social_graph_adapter,
    "tweetypie_event": tweetypie_event_adapter,
    "ads_callback": ads_callback_adapter,
    "email_notification": email_notification_adapter,
    "favorite_archival": favorite_archival_adapter,
    "retweet_archival": retweet_archival_adapter,
    "user_modification": user_modification_adapter,
    "interaction_events": rekey_from_interaction_events_adapter,
    "video_client_event": video_client_event_adapter,
    "behavioral_client_event": enriched_client_event_adapter,
}


def adapt(source: str, event: Mapping[str, Any]) -> List[UnifiedUserAction]:
    """Route one raw event from ``source`` through its adapter."""
    adapter = ADAPTERS.get(source)
    if adapter is None:
        raise KeyError(f"no UUA adapter for source '{source}'")
    return adapter(event)
