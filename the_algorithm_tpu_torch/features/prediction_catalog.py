"""Prediction feature catalog — the typed feature-definition registry for
ranking models.

A host copy of ``the_algorithm_tpu/features/prediction_catalog.py``: the
family registrations run at import in the same order.

≡ ``src/scala/com/twitter/timelines/prediction/features/*`` (SURVEY.md §2
"Prediction feature catalog"): every DataRecord feature a ranking model can
consume is declared once, with type, family, and personal-data tags — the
catalog is the contract between hydrators, training data, and model configs.
Families mirror the reference packages:

- ``recap``          — engagement labels + client/content features
  (``recap/RecapFeatures.scala``, 329 defs)
- ``real_graph``     — per-interaction-type edge statistics
  (``real_graph/RealGraphDataRecordFeatures.scala``: NUM_<type>_<stat>
  cross product, 164 defs)
- ``engagement``     — public engagement counts + log transforms
  (``engagement_features/EngagementFeatures.scala``)
- ``time``           — request/tweet time deltas
  (``time_features/TimeDataRecordFeatures.scala``)
- ``two_hop``        — graph two-hop path features (``two_hop_features/``)
- ``simcluster``     — SimClusters embedding features (``simcluster/``)
- ``request_context``— client/device/time-of-day context
- ``user_health``    — author/user health scores (``user_health/``)
- ``socialproof``, ``list``, ``itl``, ``followsource``, ``ppmi``,
  ``escherbird``, ``client_log_event``, ``p_home_latest`` — per-surface
  families.

The PREDICTED heads (``PredictedScoreFeature.scala``) bind a subset of recap
engagement labels to model output heads; their serving weights live in
:mod:`the_algorithm_tpu_torch.models.masknet`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence

from the_algorithm_tpu_torch.mixers.feature_schema import FeatureSpec


class FeatureKind(enum.Enum):
    BINARY = "binary"
    CONTINUOUS = "continuous"
    DISCRETE = "discrete"  # categorical id
    SPARSE_BINARY = "sparse_binary"
    SPARSE_CONTINUOUS = "sparse_continuous"
    TENSOR = "tensor"  # fixed-width dense vector


@dataclasses.dataclass(frozen=True)
class Feature:
    """One catalog entry (≡ ml-api ``Feature.{Binary,Continuous,…}``)."""

    name: str  # e.g. "recap.engagement.is_favorited"
    kind: FeatureKind
    family: str
    tags: frozenset = frozenset()  # personal-data tags (PII lineage)
    width: int = 1  # >1 only for TENSOR

    def spec(self) -> FeatureSpec:
        return FeatureSpec(self.name.replace(".", "_"), self.width)


class FeatureCatalog:
    """Name → Feature registry with family views."""

    def __init__(self):
        self._by_name: Dict[str, Feature] = {}

    def add(self, f: Feature) -> Feature:
        if f.name in self._by_name:
            raise ValueError(f"duplicate feature {f.name}")
        self._by_name[f.name] = f
        return f

    def define(self, name: str, kind: FeatureKind, family: str,
               tags: Iterable[str] = (), width: int = 1) -> Feature:
        return self.add(Feature(name, kind, family, frozenset(tags), width))

    def get(self, name: str) -> Feature:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._by_name)

    def all(self) -> List[Feature]:
        return sorted(self._by_name.values(), key=lambda f: f.name)

    def family(self, family: str) -> List[Feature]:
        return [f for f in self.all() if f.family == family]

    def families(self) -> List[str]:
        return sorted({f.family for f in self._by_name.values()})

    def binary_labels(self) -> List[Feature]:
        return [f for f in self.family("recap")
                if f.kind == FeatureKind.BINARY
                and ".engagement." in f.name]

    def schema(self, families: Sequence[str],
               kinds: Optional[Sequence[FeatureKind]] = None) -> List[FeatureSpec]:
        """Dense model input schema from catalog families (the
        feature-config role, ``twml/twml/feature_config.py``)."""
        keep = set(kinds) if kinds else {
            FeatureKind.BINARY, FeatureKind.CONTINUOUS, FeatureKind.TENSOR}
        out = []
        for fam in families:
            out.extend(f.spec() for f in self.family(fam) if f.kind in keep)
        return out


CATALOG = FeatureCatalog()
_B, _C, _D = FeatureKind.BINARY, FeatureKind.CONTINUOUS, FeatureKind.DISCRETE


def _recap() -> None:
    """≡ recap/RecapFeatures.scala."""
    eng = "recap.engagement"
    pd = ("EngagementsPrivate",)
    # core label set (the 15 serving heads bind to these; see
    # masknet.DEFAULT_HEAD_NAMES)
    for n in ("is_favorited", "is_retweeted", "is_replied", "is_quoted",
              "is_clicked", "is_profile_clicked", "is_open_linked",
              "is_photo_expanded", "is_video_playback_50",
              "is_video_quality_viewed", "is_bookmarked", "is_shared",
              "is_share_menu_clicked", "is_dont_like",
              "is_block_clicked", "is_mute_clicked", "is_report_tweet_clicked",
              "is_negative_feedback_v2", "is_replied_reply_engaged_by_author",
              "is_good_clicked_convo_desc_favorited",
              "is_good_clicked_convo_desc_v1",
              "is_good_clicked_convo_desc_v2",
              "is_retweeted_without_quote", "is_followed_from_tweet",
              "is_screenshotted"):
        CATALOG.define(f"{eng}.{n}", _B, "recap", pd)
    # dwell ladders (IS_DWELLED_1S..10S, detail/profile/video/link dwell)
    for s in range(1, 11):
        CATALOG.define(f"{eng}.is_dwelled_{s}s", _B, "recap", pd)
        CATALOG.define(f"{eng}.is_skipped_{s}s", _B, "recap", pd)
    for n, secs in (("tweet_detail_dwelled", (8, 15, 25, 30)),
                    ("profile_dwelled", (10, 20, 30)),
                    ("fullscreen_video_dwelled", (5, 10, 20, 30)),
                    ("link_dwelled", (15, 30, 60))):
        CATALOG.define(f"{eng}.is_{n}", _B, "recap", pd)
        for s in secs:
            CATALOG.define(f"{eng}.is_{n}_{s}_sec", _B, "recap", pd)
    # client context
    for c in ("ipad", "web", "iphone", "android", "android_tablet"):
        CATALOG.define(f"recap.client.is_{c}", _B, "recap", ("ClientType",))
    # content
    for n in ("has_image", "has_video", "has_card", "has_quote", "has_link",
              "has_hashtag", "has_mention", "has_native_image",
              "is_reply", "is_retweet", "is_extended_reply",
              "match_ui_lang", "match_searcher_langs"):
        CATALOG.define(f"recap.tweetfeature.{n}", _B, "recap")
    for n in ("text_score", "bidirectional_reply_count",
              "unidirectional_reply_count", "bidirectional_fav_count",
              "unidirectional_fav_count", "bidirectional_retweet_count",
              "unidirectional_retweet_count", "embeds_impression_count",
              "embeds_url_count", "video_view_count", "tweet_age"):
        CATALOG.define(f"recap.tweetfeature.{n}", _C, "recap")


def _real_graph() -> None:
    """≡ real_graph/RealGraphDataRecordFeatures.scala — the
    interaction-type × statistic cross product."""
    CATALOG.define("realgraph.src_id", _D, "real_graph", ("UserId",))
    CATALOG.define("realgraph.dst_id", _D, "real_graph", ("UserId",))
    CATALOG.define("realgraph.weight", _C, "real_graph",
                   ("UsersRealGraphScore",))
    kinds = ("retweets", "favorites", "mentions", "direct_messages",
             "tweet_clicks", "link_clicks", "profile_views", "follow",
             "inspected_tweets", "photo_tags", "mutual_follow",
             "sms_follow", "blocks", "mutes", "reports_as_abuses",
             "reports_as_spams",
             "address_book_email", "address_book_phone",
             "address_book_in_both", "address_book_mutual_edge_email",
             "address_book_mutual_edge_phone",
             "address_book_mutual_edge_in_both")
    stats = ("mean", "ewma", "variance", "non_zero_days", "elapsed_days",
             "days_since_last")
    for k in kinds:
        for s in stats:
            CATALOG.define(f"realgraph.num_{k}.{s}", _C, "real_graph",
                           ("CountOfPrivateTweetEntitiesAndMetadata",))
        CATALOG.define(f"realgraph.num_{k}.is_missing", _B, "real_graph")


def _engagement() -> None:
    """≡ engagement_features/EngagementFeatures.scala."""
    for n in ("favorite_count", "retweet_count", "reply_count",
              "quote_count", "embeds_impression_count", "video_view_count"):
        CATALOG.define(f"engagement_features.in_network.{n}", _C, "engagement",
                       ("CountOfPrivateLikes",))
        CATALOG.define(f"engagement_features.in_network.{n}_log", _C,
                       "engagement")
        CATALOG.define(f"engagement_features.real_count.{n}", _C, "engagement",
                       ("CountOfPublicLikes",))


def _time() -> None:
    """≡ time_features/TimeDataRecordFeatures.scala."""
    for n in ("time_since_tweet_creation", "time_since_source_tweet_creation",
              "time_since_last_favorite", "time_since_last_retweet",
              "time_since_last_reply", "time_since_viewer_account_creation",
              "time_between_non_polling_requests_avg",
              "time_since_last_non_polling_request",
              "last_favorite_since_creation_hrs",
              "last_retweet_since_creation_hrs"):
        CATALOG.define(f"time_features.{n}", _C, "time")
    for n in ("is_tweet_recycled", "is_night_in_viewer_tz",
              "account_age_interval"):
        CATALOG.define(f"time_features.{n}", _B, "time")


def _two_hop() -> None:
    """≡ two_hop_features/TwoHopFeatures.scala — (edge₁, edge₂) path
    counts + normalized variants between viewer and author."""
    paths = ("follow.follow", "follow.favorite", "follow.retweet",
             "favorite.follow", "favorite.favorite", "favorite.retweet",
             "retweet.follow", "mention.follow", "mutual_follow.follow")
    for p in paths:
        CATALOG.define(f"two_hop.{p}.count", _C, "two_hop",
                       ("CountOfPrivateFollows",))
        CATALOG.define(f"two_hop.{p}.normalized", _C, "two_hop")


def _simcluster() -> None:
    """≡ simcluster/SimclustersFeatures.scala — sparse embedding features
    + engagement-similarity aggregates (the RSX feature block)."""
    CATALOG.define("simcluster.user_interested_in", FeatureKind.SPARSE_CONTINUOUS,
                   "simcluster", ("InferredInterests",))
    CATALOG.define("simcluster.tweet_embedding", FeatureKind.SPARSE_CONTINUOUS,
                   "simcluster", ())
    for sig in ("fav", "retweet", "reply", "share", "click", "video_view"):
        for agg in ("min", "avg", "max"):
            CATALOG.define(
                f"simcluster.engagement_similarity.{sig}_7d_{agg}", _C,
                "simcluster")


def _request_context() -> None:
    for n in ("hour_of_day", "day_of_week", "client_app_id",
              "country_code", "language_code"):
        CATALOG.define(f"request_context.{n}", _D, "request_context",
                       ("ClientType",))
    CATALOG.define("request_context.is_polling", _B, "request_context")


def _user_health() -> None:
    """≡ user_health/UserHealthFeatures.scala + author health."""
    for n in ("user_state", "is_light_plus_user"):
        CATALOG.define(f"user_health.{n}", _D, "user_health",
                       ("UserState",))
    for n in ("author_state", "toxicity_score", "pblock_score",
              "pspammy_tweet_score", "preport_tweet_score"):
        CATALOG.define(f"user_health.author.{n}", _C, "user_health",
                       ("UserSafetyLabels",))


def _surfaces() -> None:
    # socialproof (socialproof/SocialProofFeatures.scala)
    for n in ("num_favoriting_follows", "num_retweeting_follows",
              "num_replying_follows", "has_social_proof"):
        kind = _B if n.startswith("has") else _C
        CATALOG.define(f"socialproof.{n}", kind, "socialproof",
                       ("CountOfPrivateFollows",))
    # list features (list_features/ListFeatures.scala)
    for n in ("viewer_is_list_owner", "viewer_is_list_subscriber",
              "is_pinned_list"):
        CATALOG.define(f"list.{n}", _B, "list")
    CATALOG.define("list.list_id", _D, "list")
    # ITL (itl/ITLFeatures.scala — "in this lifetime" aggregates)
    for n in ("itl_fav_count", "itl_retweet_count", "itl_reply_count"):
        CATALOG.define(f"itl.{n}", _C, "itl")
    # followsource
    for n in ("is_profile_follow", "is_wtf_follow", "is_search_follow"):
        CATALOG.define(f"followsource.{n}", _B, "followsource")
    # ppmi (ppmi/PpmiDataRecordFeatures.scala)
    CATALOG.define("ppmi.engagement_score", _C, "ppmi")
    # escherbird (entity annotations)
    CATALOG.define("escherbird.tweet_entity_ids",
                   FeatureKind.SPARSE_BINARY, "escherbird",
                   ("SemanticCoreClassification",))
    # client_log_event
    for n in ("last_50_fav_authors", "last_50_click_authors"):
        CATALOG.define(f"client_log_event.{n}", FeatureKind.SPARSE_BINARY,
                       "client_log_event", ("EngagementsPrivate",))
    # p_home_latest (p_home_latest/HomeLatestFeatures.scala)
    for n in ("p_home_latest", "last_login_timestamp"):
        CATALOG.define(f"p_home_latest.{n}", _C, "p_home_latest")


for _builder in (_recap, _real_graph, _engagement, _time, _two_hop,
                 _simcluster, _request_context, _user_health, _surfaces):
    _builder()


# -- PREDICTED heads ----------------------------------------------------------

# serving head name → catalog label it predicts
# (≡ product/scored_tweets/scorer/PredictedScoreFeature.scala)
PREDICTED_HEAD_LABELS: Dict[str, str] = {
    "fav": "recap.engagement.is_favorited",
    "retweet": "recap.engagement.is_retweeted",
    "reply": "recap.engagement.is_replied",
    "good_click_convo": "recap.engagement.is_good_clicked_convo_desc_v1",
    "good_click_profile": "recap.engagement.is_good_clicked_convo_desc_v2",
    "video_quality_view": "recap.engagement.is_video_quality_viewed",
    "reply_engaged_by_author": "recap.engagement.is_replied_reply_engaged_by_author",
    "good_profile_click": "recap.engagement.is_profile_clicked",
    "share": "recap.engagement.is_shared",
    "dwell": "recap.engagement.is_dwelled_10s",
    "bookmark": "recap.engagement.is_bookmarked",
    "open_link": "recap.engagement.is_open_linked",
    "screenshot": "recap.engagement.is_screenshotted",
    "negative_feedback_v2": "recap.engagement.is_negative_feedback_v2",
    "report": "recap.engagement.is_report_tweet_clicked",
}


def validate_heads(head_names: Sequence[str]) -> List[str]:
    """Every serving head must bind to a declared catalog label."""
    missing = []
    for h in head_names:
        label = PREDICTED_HEAD_LABELS.get(h)
        if label is None or label not in CATALOG:
            missing.append(h)
    return missing
