"""Visibility rule engine: SafetyLevel × content features → Action.

A host copy of ``the_algorithm_tpu/pipeline/visibility.py`` (that module's
package imports JAX); the rule tables and the evaluation order are the same.

≡ ``visibilitylib/`` (SURVEY.md §2.1): ``VisibilityLibrary`` +
``DeciderableVisibilityRuleEngine.scala:12-21`` evaluate condition-gated
rules per SafetyLevel surface; actions are Allow / Drop / Interstitial /
Downrank (``rules/{Action,Condition,DownrankingRules}.scala``); rules can
fail closed (``FailClosedException``), and the engine short-circuits at the
first terminal action. Metrics per rule
(``VisibilityResultsMetricRecorder.scala:21-167``).

In-process: content/viewer state is a plain FeatureMap; rules are predicates
with an action and an optional decider gate; the engine evaluates the
safety-level's rule sequence in order.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from the_algorithm_tpu_torch.core.metrics import NullStats, StatsReceiver


class Action(enum.IntEnum):
    """≡ rules/Action.scala terminal actions (severity-ordered)."""

    ALLOW = 0
    AVOID = 1  # keep, but exclude from ad adjacency (the Avoid action)
    DOWNRANK = 2
    LIMITED_ENGAGEMENTS = 3  # render with engagement actions disabled
    INTERSTITIAL = 4
    TOMBSTONE = 5  # replace with "unavailable" placeholder (threads/DMs)
    DROP = 6


class SafetyLevel(enum.Enum):
    """Per-surface rule sets — the COMPLETE reference SafetyLevel space
    (one member per ``case object`` in
    ``visibilitylib/src/main/scala/com/twitter/visibility/models/SafetyLevel.scala``,
    198 surfaces), each bound to its own policy in the catalog's
    level→policy map (≡ ``rules/RuleBase.scala``). Values are the
    reference's CamelCase level names."""

    ADS_BUSINESS_SETTINGS = "AdsBusinessSettings"
    ADS_CAMPAIGN = "AdsCampaign"
    ADS_MANAGER = "AdsManager"
    ADS_REPORTING_DASHBOARD = "AdsReportingDashboard"
    ALL_SUBSCRIBED_LISTS = "AllSubscribedLists"
    APPEALS = "Appeals"
    ARTICLE_TWEET_TIMELINE = "ArticleTweetTimeline"
    BASE_QIG = "BaseQig"
    BIRDWATCH_NOTE_AUTHOR = "BirdwatchNoteAuthor"
    BIRDWATCH_NOTE_TWEETS_TIMELINE = "BirdwatchNoteTweetsTimeline"
    BIRDWATCH_NEEDS_YOUR_HELP_NOTIFICATIONS = "BirdwatchNeedsYourHelpNotifications"
    BLOCK_MUTE_USERS_TIMELINE = "BlockMuteUsersTimeline"
    BRAND_SAFETY = "BrandSafety"
    CARD_POLL_VOTING = "CardPollVoting"
    CARDS_SERVICE = "CardsService"
    COMMUNITIES = "Communities"
    CONTENT_CONTROL_TOOL_INSTALL = "ContentControlToolInstall"
    CONVERSATION_FOCAL_PREHYDRATION = "ConversationFocalPrehydration"
    CONVERSATION_FOCAL_TWEET = "ConversationFocalTweet"
    CONVERSATION_INJECTED_TWEET = "ConversationInjectedTweet"
    CONVERSATION_REPLY = "ConversationReply"
    ACCESS_INTERNAL_PROMOTED_CONTENT = "AccessInternalPromotedContent"
    CURATED_TRENDS_REPRESENTATIVE_TWEET = "CuratedTrendsRepresentativeTweet"
    CURATION_POLICY_VIOLATIONS = "CurationPolicyViolations"
    DEV_PLATFORM_GET_LIST_TWEETS = "DevPlatformGetListTweets"
    DES_FOLLOWING_AND_FOLLOWERS_USER_LIST = "DesFollowingAndFollowersUserList"
    DES_HOME_TIMELINE = "DesHomeTimeline"
    DES_QUOTE_TWEET_TIMELINE = "DesQuoteTweetTimeline"
    DES_REALTIME = "DesRealtime"
    DES_REALTIME_SPAM_ENRICHMENT = "DesRealtimeSpamEnrichment"
    DES_REALTIME_TWEET_FILTER = "DesRealtimeTweetFilter"
    DES_RETWEETING_USERS = "DesRetweetingUsers"
    DES_TWEET_DETAIL = "DesTweetDetail"
    DES_TWEET_LIKING_USERS = "DesTweetLikingUsers"
    DES_USER_BOOKMARKS = "DesUserBookmarks"
    DES_USER_LIKED_TWEETS = "DesUserLikedTweets"
    DES_USER_MENTIONS = "DesUserMentions"
    DES_USER_TWEETS = "DesUserTweets"
    DEV_PLATFORM_COMPLIANCE_STREAM = "DevPlatformComplianceStream"
    DIRECT_MESSAGES = "DirectMessages"
    DIRECT_MESSAGES_CONVERSATION_LIST = "DirectMessagesConversationList"
    DIRECT_MESSAGES_CONVERSATION_TIMELINE = "DirectMessagesConversationTimeline"
    DIRECT_MESSAGES_INBOX = "DirectMessagesInbox"
    DIRECT_MESSAGES_MUTED_USERS = "DirectMessagesMutedUsers"
    DIRECT_MESSAGES_PINNED = "DirectMessagesPinned"
    DIRECT_MESSAGES_SEARCH = "DirectMessagesSearch"
    EDIT_HISTORY_TIMELINE = "EditHistoryTimeline"
    ELEVATED_QUOTE_TWEET_TIMELINE = "ElevatedQuoteTweetTimeline"
    EMBEDDED_TWEET = "EmbeddedTweet"
    EMBEDS_PUBLIC_INTEREST_NOTICE = "EmbedsPublicInterestNotice"
    EMBED_TWEET_MARKUP = "EmbedTweetMarkup"
    WRITE_PATH_LIMITED_ACTIONS_ENFORCEMENT = "WritePathLimitedActionsEnforcement"
    FILTER_NONE = "FilterNone"
    FILTER_ALL = "FilterAll"
    FILTER_ALL_PLACEHOLDER = "FilterAllPlaceholder"
    FILTER_DEFAULT = "FilterDefault"
    FOLLOWED_TOPICS_TIMELINE = "FollowedTopicsTimeline"
    FOLLOWER_CONNECTIONS = "FollowerConnections"
    FOLLOWING_AND_FOLLOWERS_USER_LIST = "FollowingAndFollowersUserList"
    FOR_DEVELOPMENT_ONLY = "ForDevelopmentOnly"
    FRIENDS_FOLLOWING_LIST = "FriendsFollowingList"
    GRAPHQL_DEFAULT = "GraphqlDefault"
    GRYPHON_DECKS_AND_COLUMNS = "GryphonDecksAndColumns"
    HUMANIZATION_NUDGE = "HumanizationNudge"
    KITCHEN_SINK_DEVELOPMENT = "KitchenSinkDevelopment"
    LIST_HEADER = "ListHeader"
    LIST_MEMBERSHIPS = "ListMemberships"
    LIST_OWNERSHIPS = "ListOwnerships"
    LIST_RECOMMENDATIONS = "ListRecommendations"
    LIST_SEARCH = "ListSearch"
    LIST_SUBSCRIPTIONS = "ListSubscriptions"
    LIVE_PIPELINE_ENGAGEMENT_COUNTS = "LivePipelineEngagementCounts"
    LIVE_VIDEO_TIMELINE = "LiveVideoTimeline"
    MAGIC_RECS = "MagicRecs"
    MAGIC_RECS_AGGRESSIVE = "MagicRecsAggressive"
    MAGIC_RECS_AGGRESSIVE_V2 = "MagicRecsAggressiveV2"
    MAGIC_RECS_V2 = "MagicRecsV2"
    MINIMAL = "Minimal"
    MODERATED_TWEETS_TIMELINE = "ModeratedTweetsTimeline"
    MOMENTS = "Moments"
    NEARBY_TIMELINE = "NearbyTimeline"
    NEW_USER_EXPERIENCE = "NewUserExperience"
    NOTIFICATIONS_IBIS = "NotificationsIbis"
    NOTIFICATIONS_PLATFORM = "NotificationsPlatform"
    NOTIFICATIONS_PLATFORM_PUSH = "NotificationsPlatformPush"
    NOTIFICATIONS_QIG = "NotificationsQig"
    NOTIFICATIONS_READ = "NotificationsRead"
    NOTIFICATIONS_TIMELINE_DEVICE_FOLLOW = "NotificationsTimelineDeviceFollow"
    NOTIFICATIONS_WRITE = "NotificationsWrite"
    NOTIFICATIONS_WRITER_V2 = "NotificationsWriterV2"
    NOTIFICATIONS_WRITER_TWEET_HYDRATOR = "NotificationsWriterTweetHydrator"
    PROFILE_MIXER_MEDIA = "ProfileMixerMedia"
    PROFILE_MIXER_FAVORITES = "ProfileMixerFavorites"
    QUICK_PROMOTE_TWEET_ELIGIBILITY = "QuickPromoteTweetEligibility"
    QUOTE_TWEET_TIMELINE = "QuoteTweetTimeline"
    QUOTED_TWEET_RULES = "QuotedTweetRules"
    RECOMMENDATIONS = "Recommendations"
    RECOS_VIDEO = "RecosVideo"
    RECOS_WRITE_PATH = "RecosWritePath"
    REPLIES_GROUPING = "RepliesGrouping"
    REPORT_CENTER = "ReportCenter"
    RETURNING_USER_EXPERIENCE = "ReturningUserExperience"
    RETURNING_USER_EXPERIENCE_FOCAL_TWEET = "ReturningUserExperienceFocalTweet"
    REVENUE = "Revenue"
    RITO_ACTIONED_TWEET_TIMELINE = "RitoActionedTweetTimeline"
    SAFE_SEARCH_MINIMAL = "SafeSearchMinimal"
    SAFE_SEARCH_STRICT = "SafeSearchStrict"
    SEARCH_HYDRATION = "SearchHydration"
    SEARCH_LATEST = "SearchLatest"
    SEARCH_MIXER_SRP_MINIMAL = "SearchMixerSrpMinimal"
    SEARCH_MIXER_SRP_STRICT = "SearchMixerSrpStrict"
    SEARCH_PEOPLE_SRP = "SearchPeopleSrp"
    SEARCH_PEOPLE_TYPEAHEAD = "SearchPeopleTypeahead"
    SEARCH_PHOTO = "SearchPhoto"
    SHOPPING_MANAGER_SPY_MODE = "ShoppingManagerSpyMode"
    STRATO_EXT_LIMITED_ENGAGEMENTS = "StratoExtLimitedEngagements"
    SEARCH_TOP = "SearchTop"
    SEARCH_TOP_QIG = "SearchTopQig"
    SEARCH_TREND_TAKEOVER_PROMOTED_TWEET = "SearchTrendTakeoverPromotedTweet"
    SEARCH_VIDEO = "SearchVideo"
    SEARCH_BLENDER_USER_RULES = "SearchBlenderUserRules"
    SEARCH_LATEST_USER_RULES = "SearchLatestUserRules"
    SIGNALS_REACTIONS = "SignalsReactions"
    SIGNALS_TWEET_REACTING_USERS = "SignalsTweetReactingUsers"
    SOCIAL_PROOF = "SocialProof"
    SOFT_INTERVENTION_PIVOT = "SoftInterventionPivot"
    SPACE_FLEETLINE = "SpaceFleetline"
    SPACE_HOME_TIMELINE_UPRANKING = "SpaceHomeTimelineUpranking"
    SPACE_JOIN_SCREEN = "SpaceJoinScreen"
    SPACE_NOTIFICATIONS = "SpaceNotifications"
    SPACES = "Spaces"
    SPACES_PARTICIPANTS = "SpacesParticipants"
    SPACES_SELLER_APPLICATION_STATUS = "SpacesSellerApplicationStatus"
    SPACES_SHARING = "SpacesSharing"
    SPACE_TWEET_AVATAR_HOME_TIMELINE = "SpaceTweetAvatarHomeTimeline"
    STICKERS_TIMELINE = "StickersTimeline"
    STREAM_SERVICES = "StreamServices"
    SUPER_FOLLOWER_CONNECTIONS = "SuperFollowerConnections"
    SUPER_LIKE = "SuperLike"
    TEST = "Test"
    TIMELINE_CONVERSATIONS = "TimelineConversations"
    TIMELINE_CONVERSATIONS_DOWNRANKING = "TimelineConversationsDownranking"
    TIMELINE_CONVERSATIONS_DOWNRANKING_MINIMAL = "TimelineConversationsDownrankingMinimal"
    TIMELINE_FOLLOWING_ACTIVITY = "TimelineFollowingActivity"
    TIMELINE_HOME = "TimelineHome"
    TIMELINE_HOME_COMMUNITIES = "TimelineHomeCommunities"
    TIMELINE_HOME_HYDRATION = "TimelineHomeHydration"
    TIMELINE_HOME_PROMOTED_HYDRATION = "TimelineHomePromotedHydration"
    TIMELINE_HOME_RECOMMENDATIONS = "TimelineHomeRecommendations"
    TIMELINE_HOME_TOPIC_FOLLOW_RECOMMENDATIONS = "TimelineHomeTopicFollowRecommendations"
    TIMELINE_SCORER = "TimelineScorer"
    TOPICS_LANDING_PAGE_TOPIC_RECOMMENDATIONS = "TopicsLandingPageTopicRecommendations"
    EXPLORE_RECOMMENDATIONS = "ExploreRecommendations"
    TIMELINE_MODERATED_TWEETS_HYDRATION = "TimelineModeratedTweetsHydration"
    TIMELINE_INJECTION = "TimelineInjection"
    TIMELINE_MENTIONS = "TimelineMentions"
    TIMELINE_HOME_LATEST = "TimelineHomeLatest"
    TIMELINE_LIKED_BY = "TimelineLikedBy"
    TIMELINE_RETWEETED_BY = "TimelineRetweetedBy"
    TIMELINE_SUPER_LIKED_BY = "TimelineSuperLikedBy"
    TIMELINE_BOOKMARK = "TimelineBookmark"
    TIMELINE_CONTENT_CONTROLS = "TimelineContentControls"
    TIMELINE_MEDIA = "TimelineMedia"
    TIMELINE_REACTIVE_BLENDING = "TimelineReactiveBlending"
    TIMELINE_FAVORITES = "TimelineFavorites"
    TIMELINE_FAVORITES_SELF_VIEW = "TimelineFavoritesSelfView"
    TIMELINE_LISTS = "TimelineLists"
    TIMELINE_PROFILE = "TimelineProfile"
    TIMELINE_PROFILE_ALL = "TimelineProfileAll"
    TIMELINE_PROFILE_SPACES = "TimelineProfileSpaces"
    TIMELINE_PROFILE_SUPER_FOLLOWS = "TimelineProfileSuperFollows"
    TIMELINE_FOCAL_TWEET = "TimelineFocalTweet"
    TOMBSTONING = "Tombstoning"
    TOPIC_RECOMMENDATIONS = "TopicRecommendations"
    TRENDS_REPRESENTATIVE_TWEET = "TrendsRepresentativeTweet"
    TRUSTED_FRIENDS_USER_LIST = "TrustedFriendsUserList"
    TWITTER_DELEGATE_USER_LIST = "TwitterDelegateUserList"
    TWEET_DETAIL = "TweetDetail"
    TWEET_DETAIL_NON_TOO = "TweetDetailNonToo"
    TWEET_DETAIL_WITH_INJECTIONS_HYDRATION = "TweetDetailWithInjectionsHydration"
    TWEET_ENGAGERS = "TweetEngagers"
    TWEET_REPLY_NUDGE = "TweetReplyNudge"
    TWEET_SCOPED_TIMELINE = "TweetScopedTimeline"
    TWEET_WRITES_API = "TweetWritesApi"
    TWITTER_ARTICLE_COMPOSE = "TwitterArticleCompose"
    TWITTER_ARTICLE_PROFILE_TAB = "TwitterArticleProfileTab"
    TWITTER_ARTICLE_READ = "TwitterArticleRead"
    USER_PROFILE_HEADER = "UserProfileHeader"
    USER_MILESTONE_RECOMMENDATION = "UserMilestoneRecommendation"
    USER_SCOPED_TIMELINE = "UserScopedTimeline"
    USER_SEARCH_SRP = "UserSearchSrp"
    USER_SEARCH_TYPEAHEAD = "UserSearchTypeahead"
    USER_SELF_VIEW_ONLY = "UserSelfViewOnly"
    USER_SETTINGS = "UserSettings"
    VIDEO_ADS = "VideoAds"
    ZIPBIRD_CONSUMER_ARCHIVES = "ZipbirdConsumerArchives"
    TWEET_AWARD = "TweetAward"
    DEPRECATED_SAFETY_LEVEL = "DeprecatedSafetyLevel"

    # legacy member aliases from the pre-r4 enum (same value ⇒ enum alias,
    # not a new member — the canonical space stays exactly 198 levels)
    SEARCH = "SearchTop"
    SEARCH_MEDIA = "SearchPhoto"
    SEARCH_PEOPLE = "SearchPeopleSrp"
    RECOMMENDATIONS_VIDEO = "RecosVideo"
    NOTIFICATIONS = "NotificationsPlatform"
    NOTIFICATIONS_PUSH = "NotificationsPlatformPush"
    CONVERSATION = "ConversationReply"
    QUOTED_TWEET = "QuotedTweetRules"
    ADS = "BrandSafety"


@dataclasses.dataclass(frozen=True)
class Rule:
    """Condition → action, optionally decider-gated and fail-closed."""

    name: str
    condition: Callable[[Mapping], bool]  # features → applies?
    action: Action
    reason: str = ""
    enabled: Callable[[], bool] = lambda: True  # the Decider gate
    fail_closed: bool = False  # condition error ⇒ DROP (vs skip)


@dataclasses.dataclass
class VisibilityResult:
    action: Action
    triggered_rules: List[str]
    reason: str = ""


class VisibilityResultsMetricRecorder:
    """Per-(SafetyLevel, Rule, Action) evaluation matrix
    (≡ ``VisibilityResultsMetricRecorder.scala:21-167``: the reference
    records evaluated/triggered/failed counts per rule scoped under the
    safety level, plus the final verdict distribution per level)."""

    def __init__(self):
        # (level.value, rule_name, outcome) -> count; outcome is
        # "evaluated" | "triggered" | "failed" | "disabled"
        self.rule_counts: Dict[tuple, int] = {}
        # (level.value, action.name) -> count of final verdicts
        self.verdict_counts: Dict[tuple, int] = {}

    def record_rule(self, level: SafetyLevel, rule: str, outcome: str) -> None:
        k = (level.value, rule, outcome)
        self.rule_counts[k] = self.rule_counts.get(k, 0) + 1

    def record_verdict(self, level: SafetyLevel, action: Action) -> None:
        k = (level.value, action.name)
        self.verdict_counts[k] = self.verdict_counts.get(k, 0) + 1

    def matrix(self) -> Dict[tuple, int]:
        """The full (level, rule, outcome) count matrix."""
        return dict(self.rule_counts)

    def triggered(self, level: SafetyLevel, rule: str) -> int:
        return self.rule_counts.get((level.value, rule, "triggered"), 0)


class VisibilityRuleEngine:
    def __init__(
        self,
        rules_by_level: Mapping[SafetyLevel, Sequence[Rule]],
        stats: Optional[StatsReceiver] = None,
        short_circuit: bool = True,
        recorder: Optional[VisibilityResultsMetricRecorder] = None,
    ):
        self.rules_by_level = dict(rules_by_level)
        self.stats = stats or NullStats()
        self.short_circuit = short_circuit
        self.recorder = recorder

    def evaluate(
        self, level: SafetyLevel, features: Mapping
    ) -> VisibilityResult:
        """Most-severe action among triggered rules (short-circuit on DROP)."""
        rec = self.recorder
        result = VisibilityResult(Action.ALLOW, [])
        for rule in self.rules_by_level.get(level, ()):  # ordered
            if not rule.enabled():
                self.stats.counter(f"visibility/{rule.name}/disabled")
                if rec:
                    rec.record_rule(level, rule.name, "disabled")
                continue
            if rec:
                rec.record_rule(level, rule.name, "evaluated")
            try:
                applies = rule.condition(features)
            except Exception:
                self.stats.counter(f"visibility/{rule.name}/errors")
                if rec:
                    rec.record_rule(level, rule.name, "failed")
                # fail-closed rules drop on evaluation failure
                applies = rule.fail_closed
            if applies:
                self.stats.counter(f"visibility/{rule.name}/triggered")
                if rec:
                    rec.record_rule(level, rule.name, "triggered")
                result.triggered_rules.append(rule.name)
                if rule.action > result.action:
                    result.action = rule.action
                    result.reason = rule.reason or rule.name
                if self.short_circuit and result.action == Action.DROP:
                    break
        if rec:
            rec.record_verdict(level, result.action)
        return result


# -- standard rules (DownrankingRules / safety rules analog) -----------------


def _f(name, default=False):
    return lambda feats: bool(feats.get(name, default))


STANDARD_RULES: Dict[SafetyLevel, List[Rule]] = {
    SafetyLevel.TIMELINE_HOME: [
        Rule("DropDeletedTweet", _f("is_deleted"), Action.DROP, "deleted"),
        Rule(
            "DropAuthorBlockedViewer",
            _f("author_blocks_viewer"),
            Action.DROP,
            "blocked",
        ),
        Rule(
            "DropViewerBlockedAuthor",
            _f("viewer_blocks_author"),
            Action.DROP,
            "blocked_by_viewer",
        ),
        Rule(
            "DropViewerMutedAuthor", _f("viewer_mutes_author"), Action.DROP,
            "muted",
        ),
        Rule(
            "NsfwMediaInterstitial", _f("is_nsfw_media"), Action.INTERSTITIAL,
            "nsfw_media",
        ),
        Rule(
            "DownrankHighToxicity",
            lambda f: f.get("toxicity_score", 0.0) > 0.9,
            Action.DOWNRANK,
            "toxicity",
        ),
        Rule(
            "DownrankSpamReported",
            lambda f: f.get("spam_score", 0.0) > 0.95,
            Action.DOWNRANK,
            "spam",
            fail_closed=False,
        ),
    ],
    SafetyLevel.RECOMMENDATIONS: [
        Rule("DropDeletedTweet", _f("is_deleted"), Action.DROP, "deleted"),
        Rule(
            "DropNsfwFromRecs", _f("is_nsfw_media"), Action.DROP, "nsfw_recs"
        ),
        Rule(
            "DropHighToxicityFromRecs",
            lambda f: f.get("toxicity_score", 0.0) > 0.8,
            Action.DROP,
            "toxicity_recs",
        ),
    ],
}


def standard_engine(stats=None) -> VisibilityRuleEngine:
    return VisibilityRuleEngine(STANDARD_RULES, stats=stats)


# -- pipeline integration ----------------------------------------------------


from the_algorithm_tpu_torch.pipeline.component import Filter, FilterResult  # noqa: E402


class VisibilityFilter(Filter):
    """Global pipeline filter applying the rule engine per candidate.

    DROP removes; DOWNRANK multiplies the score by ``downrank_factor``;
    INTERSTITIAL keeps but flags (the marshaller renders the cover).
    """

    def __init__(
        self,
        engine: VisibilityRuleEngine,
        level: SafetyLevel,
        downrank_factor: float = 0.25,
    ):
        self.engine = engine
        self.level = level
        self.downrank_factor = downrank_factor

    def apply(self, query, candidates, params):
        kept, removed = [], []
        for c in candidates:
            res = self.engine.evaluate(self.level, c.features)
            if res.action in (Action.DROP, Action.TOMBSTONE):
                # ranked surfaces have no placeholder slot: a tombstone is
                # a removal here; thread/DM renderers consume the reason to
                # draw the "unavailable" card
                c.features["visibility_reason"] = res.reason
                removed.append(c)
                continue
            if res.action == Action.DOWNRANK and c.score is not None:
                c.score *= self.downrank_factor
                c.features["visibility_downranked"] = True
            if res.action == Action.INTERSTITIAL:
                c.features["visibility_interstitial"] = res.reason
            if res.action == Action.AVOID:
                # keep in ranking but exclude from ad adjacency slots
                c.features["visibility_avoid"] = res.reason
            if res.action == Action.LIMITED_ENGAGEMENTS:
                c.features["visibility_limited_engagements"] = res.reason
            kept.append(c)
        return FilterResult(kept, removed)
