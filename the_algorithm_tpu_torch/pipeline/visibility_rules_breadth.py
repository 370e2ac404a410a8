"""Visibility rule breadth: the reference catalog's remaining families.

A host copy of ``the_algorithm_tpu/pipeline/visibility_rules_breadth.py``:
the lists keep their order, since ``visibility_rules`` slices them.

≡ the concrete rule objects of ``visibilitylib/src/main/scala/com/twitter/
visibility/rules/`` that round 3's catalog (``visibility_rules.py``) did not
yet enumerate — each Rule below carries its reference object's NAME and a
condition built from the same combinator vocabulary (non-author /
non-follower / viewer-setting gates × tweet/author labels × model scores).
Families in file order: NSFW/media, gore & violence, bounce (tombstoned
takedowns), community tweets, exclusive/trusted-friends content, spam,
safety-crisis levels, muted keywords per surface, viewer↔author relations,
unavailable states, UQF (viewer quality-filter) variants, sensitive-media
settings, search, do-not-amplify, ad avoidance, copypasta, DM
conversations/events, spaces.

Reference files: ``TweetLabelRules.scala``, ``Rules.scala``,
``SensitiveMediaSettingsRules.scala``, ``DmConversationRules.scala``,
``DmEventRules.scala``, ``DmVisibilityPolicies.scala``, ``SpaceRules.scala``,
``SafeSearchRules.scala``, ``SearchBlenderRules.scala``,
``ToxicityReplyFilterRules.scala``,
``UserUnavailableStateTombstoneRules.scala``, ``CardRules.scala``,
``AdvancedFilteringRules.scala``, ``FreedomOfSpeechNotReach.scala``.
"""

from __future__ import annotations

from typing import List

from the_algorithm_tpu_torch.pipeline.visibility import Action, Rule
from the_algorithm_tpu_torch.pipeline.visibility_conditions import (
    all_of,
    any_of,
    author_label,
    flag,
    muted_keyword,
    non_author,
    non_follower,
    not_,
    score_above,
    tweet_label,
)


def uqf(c):
    """Viewer quality-filter gate (≡ the *WithUqf* combinator: the rule
    only applies when the viewer keeps the quality filter on)."""
    return lambda f: bool(f.get("viewer_quality_filter_on", True)) and c(f)


def opt_in_filtering(c):
    """≡ ViewerOptInFilteringOnSearch… — viewer opted into search filtering."""
    return lambda f: bool(f.get("viewer_opt_in_filtering", True)) and c(f)


def opt_in_blocking(c):
    return lambda f: bool(f.get("viewer_opt_in_blocking", True)) and c(f)


def media_category(cat: str):
    return lambda f: cat in f.get("media_categories", ())


def media_setting(cat: str, wanted: str):
    return lambda f: (
        cat in f.get("media_categories", ())
        and f.get(f"media_setting_{cat}", "interstitial") == wanted
    )


_nsfw_admin = flag("tweet_nsfw_admin")
_nsfw_user = flag("tweet_nsfw_user")
_no_opt_in = not_(flag("nsfw_opt_in"))

# -- NSFW / media label breadth (TweetLabelRules.scala) ------------------------

NSFW_BREADTH_RULES: List[Rule] = [
    Rule("NsfwHighPrecisionAllUsersTweetLabelDropRule",
         tweet_label("nsfw_high_precision"), Action.DROP, "nsfw_hp_all"),
    Rule("NsfwHighPrecisionInterstitialAllUsersTweetLabelRule",
         tweet_label("nsfw_high_precision"), Action.INTERSTITIAL,
         "nsfw_hp_all_interstitial"),
    Rule("NsfwHighPrecisionInnerQuotedTweetLabelRule",
         non_author(all_of(tweet_label("nsfw_high_precision"), _no_opt_in)),
         Action.INTERSTITIAL, "nsfw_hp_inner_quoted"),
    Rule("NsfwHighPrecisionTombstoneInnerQuotedTweetLabelRule",
         non_author(all_of(tweet_label("nsfw_high_precision"), _no_opt_in)),
         Action.TOMBSTONE, "nsfw_hp_inner_quoted_tombstone"),
    Rule("NsfwHighPrecisionTweetLabelAvoidRule",
         tweet_label("nsfw_high_precision"), Action.AVOID, "nsfw_hp_avoid"),
    Rule("NsfwHighPrecisionUserLabelAvoidTweetRule",
         author_label("nsfw_high_precision"), Action.AVOID,
         "nsfw_hp_author_avoid"),
    Rule("NsfwHighRecallAllUsersTweetLabelDropRule",
         tweet_label("nsfw_high_recall"), Action.DROP, "nsfw_hr_all"),
    Rule("NsfwHighRecallTweetLabelRule",
         non_author(all_of(tweet_label("nsfw_high_recall"), _no_opt_in)),
         Action.INTERSTITIAL, "nsfw_hr"),
    Rule("NsfwHighRecallTweetLabelAvoidRule",
         tweet_label("nsfw_high_recall"), Action.AVOID, "nsfw_hr_avoid"),
    Rule("NsfwReportedHeuristicsAllUsersTweetLabelDropRule",
         tweet_label("nsfw_reported_heuristics"), Action.DROP,
         "nsfw_reported_all"),
    Rule("NsfwReportedHeuristicsAllUsersTweetLabelRule",
         tweet_label("nsfw_reported_heuristics"), Action.INTERSTITIAL,
         "nsfw_reported_interstitial"),
    Rule("NsfwReportedHeuristicsAvoidAllUsersTweetLabelRule",
         tweet_label("nsfw_reported_heuristics"), Action.AVOID,
         "nsfw_reported_avoid"),
    Rule("NsfwReportedHeuristicsAvoidAdPlacementAllUsersTweetLabelRule",
         tweet_label("nsfw_reported_heuristics"), Action.AVOID,
         "nsfw_reported_avoid_ads"),
    Rule("NsfwCardImageAllUsersTweetLabelDropRule",
         tweet_label("nsfw_card_image"), Action.DROP, "nsfw_card_all"),
    Rule("NsfwCardImageAllUsersTweetLabelRule",
         tweet_label("nsfw_card_image"), Action.INTERSTITIAL,
         "nsfw_card_interstitial"),
    Rule("NsfwCardImageAvoidAllUsersTweetLabelRule",
         tweet_label("nsfw_card_image"), Action.AVOID, "nsfw_card_avoid"),
    Rule("NsfwCardImageAvoidAdPlacementAllUsersTweetLabelRule",
         tweet_label("nsfw_card_image"), Action.AVOID,
         "nsfw_card_avoid_ads"),
    Rule("NsfwTextAllUsersTweetLabelDropRule",
         tweet_label("nsfw_text"), Action.DROP, "nsfw_text_all"),
    Rule("NsfwTextHighPrecisionTweetLabelDropRule",
         tweet_label("nsfw_text_high_precision"), Action.DROP,
         "nsfw_text_hp"),
    Rule("NsfwTextNonAuthorDropRule",
         non_author(tweet_label("nsfw_text")), Action.DROP,
         "nsfw_text_non_author"),
    Rule("NsfwTextTweetLabelAvoidRule",
         tweet_label("nsfw_text"), Action.AVOID, "nsfw_text_avoid"),
    Rule("NsfwVideoAllUsersTweetLabelDropRule",
         tweet_label("nsfw_video"), Action.DROP, "nsfw_video_all"),
    Rule("NsfwAvatarImageRule",
         non_follower(author_label("nsfw_avatar_image")),
         Action.DROP, "nsfw_avatar"),
    Rule("NsfwBannerImageRule",
         non_follower(author_label("nsfw_banner_image")),
         Action.DROP, "nsfw_banner"),
    Rule("DropNsfwAdminAuthorRule",
         all_of(author_label("nsfw_admin"), _no_opt_in),
         Action.DROP, "nsfw_admin_author"),
    Rule("DropNsfwUserAuthorRule",
         all_of(author_label("nsfw_user"), _no_opt_in),
         Action.DROP, "nsfw_user_author"),
    Rule("DropNsfwAdminAuthorViewerOptInFilteringOnSearchRule",
         opt_in_filtering(author_label("nsfw_admin")),
         Action.DROP, "nsfw_admin_author_search"),
    Rule("DropNsfwUserAuthorViewerOptInFilteringOnSearchRule",
         opt_in_filtering(author_label("nsfw_user")),
         Action.DROP, "nsfw_user_author_search"),
    Rule("InterstitialNsfwAdminAuthorRule",
         non_author(all_of(author_label("nsfw_admin"), _no_opt_in)),
         Action.INTERSTITIAL, "nsfw_admin_interstitial"),
    Rule("InterstitialNsfwUserAuthorRule",
         non_author(all_of(author_label("nsfw_user"), _no_opt_in)),
         Action.INTERSTITIAL, "nsfw_user_interstitial"),
    Rule("TweetNsfwAdminDropRule", all_of(_nsfw_admin, _no_opt_in),
         Action.DROP, "tweet_nsfw_admin"),
    Rule("TweetNsfwUserDropRule", all_of(_nsfw_user, _no_opt_in),
         Action.DROP, "tweet_nsfw_user"),
    Rule("TweetNsfwUserAdminAvoidRule", any_of(_nsfw_admin, _nsfw_user),
         Action.AVOID, "tweet_nsfw_avoid"),
    Rule("NsfwSensitiveRule",
         non_author(all_of(flag("is_nsfw_media"), _no_opt_in)),
         Action.INTERSTITIAL, "nsfw_sensitive"),
    Rule("NsfwNearPerfectAuthorRule",
         all_of(author_label("nsfw_near_perfect"), _no_opt_in),
         Action.DROP, "nsfw_near_perfect_author"),
    Rule("NsfaHighPrecisionTweetLabelAvoidRule",
         tweet_label("nsfa_high_precision"), Action.AVOID, "nsfa_hp_avoid"),
    Rule("NsfaHighRecallTweetLabelInterstitialRule",
         non_author(tweet_label("nsfa_high_recall")),
         Action.INTERSTITIAL, "nsfa_hr_interstitial"),
    Rule("NsfaHighRecallTweetLabelRule",
         non_follower(tweet_label("nsfa_high_recall")),
         Action.DOWNRANK, "nsfa_hr"),
]

# -- gore & violence breadth ---------------------------------------------------

GORE_VIOLENCE_RULES: List[Rule] = [
    Rule("GoreAndViolenceHighPrecisionAllUsersTweetLabelDropRule",
         tweet_label("gore_and_violence_high_precision"), Action.DROP,
         "gore_hp_all_drop"),
    Rule("GoreAndViolenceHighPrecisionAllUsersTweetLabelRule",
         tweet_label("gore_and_violence_high_precision"),
         Action.INTERSTITIAL, "gore_hp_all"),
    Rule("GoreAndViolenceHighPrecisionAvoidAllUsersTweetLabelRule",
         tweet_label("gore_and_violence_high_precision"), Action.AVOID,
         "gore_hp_avoid"),
    Rule("GoreAndViolenceHighPrecisionTweetLabelRule",
         non_author(all_of(tweet_label("gore_and_violence_high_precision"),
                           _no_opt_in)),
         Action.INTERSTITIAL, "gore_hp"),
    Rule("GoreAndViolenceReportedHeuristicsAllUsersTweetLabelDropRule",
         tweet_label("gore_reported_heuristics"), Action.DROP,
         "gore_reported_all_drop"),
    Rule("GoreAndViolenceReportedHeuristicsAllUsersTweetLabelRule",
         tweet_label("gore_reported_heuristics"), Action.INTERSTITIAL,
         "gore_reported_all"),
    Rule("GoreAndViolenceReportedHeuristicsAvoidAllUsersTweetLabelRule",
         tweet_label("gore_reported_heuristics"), Action.AVOID,
         "gore_reported_avoid"),
    Rule("GoreAndViolenceReportedHeuristicsAvoidAdPlacementAllUsersTweetLabelRule",
         tweet_label("gore_reported_heuristics"), Action.AVOID,
         "gore_reported_avoid_ads"),
    Rule("GoreAndViolenceTopicHighRecallTweetLabelRule",
         non_follower(tweet_label("gore_topic_high_recall")),
         Action.DOWNRANK, "gore_topic_hr"),
]

# -- bounce / takedown tombstones (Rules.scala Bounce* + TombstoneBounce*) -----

BOUNCE_RULES: List[Rule] = [
    Rule("BounceTweetLabelRule", tweet_label("bounce"), Action.DROP,
         "bounce", fail_closed=True),
    Rule("BounceTweetLabelTombstoneRule", tweet_label("bounce"),
         Action.TOMBSTONE, "bounce_tombstone", fail_closed=True),
    Rule("BounceAllUsersTweetLabelRule", tweet_label("bounce"),
         Action.DROP, "bounce_all", fail_closed=True),
    Rule("BounceOuterTweetLabelRule",
         all_of(flag("is_quote"), tweet_label("bounce")),
         Action.DROP, "bounce_outer"),
    Rule("BounceOuterTweetTombstoneRule",
         all_of(flag("is_quote"), tweet_label("bounce")),
         Action.TOMBSTONE, "bounce_outer_tombstone"),
    Rule("BounceQuotedTweetTombstoneRule",
         all_of(flag("is_inner_quoted"), tweet_label("bounce")),
         Action.TOMBSTONE, "bounce_quoted_tombstone"),
    Rule("TombstoneBounceDeletedTweetRule",
         all_of(flag("is_deleted"), tweet_label("bounce")),
         Action.TOMBSTONE, "bounce_deleted"),
    Rule("TombstoneBounceDeletedOuterTweetRule",
         all_of(flag("is_quote"), flag("is_deleted"), tweet_label("bounce")),
         Action.TOMBSTONE, "bounce_deleted_outer"),
    Rule("TombstoneBounceDeletedQuotedTweetRule",
         all_of(flag("is_inner_quoted"), flag("is_deleted"),
                tweet_label("bounce")),
         Action.TOMBSTONE, "bounce_deleted_quoted"),
    Rule("TombstoneDeletedTweetRule", flag("is_deleted"),
         Action.TOMBSTONE, "deleted_tombstone"),
    Rule("TombstoneDeletedOuterTweetRule",
         all_of(flag("is_quote"), flag("is_deleted")),
         Action.TOMBSTONE, "deleted_outer"),
    Rule("TombstoneDeletedQuotedTweetRule",
         all_of(flag("is_inner_quoted"), flag("is_deleted")),
         Action.TOMBSTONE, "deleted_quoted"),
]

# -- community tweets (Rules.scala community families) -------------------------

_community = flag("is_community_tweet")
_community_hidden = all_of(_community, flag("community_tweet_hidden"))
_community_protected = all_of(_community, flag("community_is_protected"))
_community_removed = all_of(_community, flag("community_author_removed"))
_community_not_visible = all_of(_community,
                                flag("community_not_visible"))
_non_member = all_of(_community, not_(flag("viewer_is_community_member")))

COMMUNITY_RULES: List[Rule] = [
    Rule("DropAllCommunityTweetsRule", _community, Action.DROP,
         "community_all"),
    Rule("FilterAllCommunityTweetsRule", _community, Action.DROP,
         "community_filter_all"),
    Rule("TombstoneAllCommunityTweetsRule", _community, Action.TOMBSTONE,
         "community_tombstone_all"),
    Rule("DropCommunityTweetsRule", _non_member, Action.DROP,
         "community_non_member"),
    Rule("FilterCommunityTweetsRule", _non_member, Action.DROP,
         "community_filter"),
    Rule("TombstoneCommunityTweetsRule", _non_member, Action.TOMBSTONE,
         "community_tombstone"),
    Rule("DropHiddenCommunityTweetsRule", _community_hidden, Action.DROP,
         "community_hidden"),
    Rule("FilterHiddenCommunityTweetsRule", _community_hidden, Action.DROP,
         "community_hidden_filter"),
    Rule("TombstoneHiddenCommunityTweetsRule", _community_hidden,
         Action.TOMBSTONE, "community_hidden_tombstone"),
    Rule("DropAllHiddenCommunityTweetsRule", _community_hidden, Action.DROP,
         "community_hidden_all"),
    Rule("DropProtectedCommunityTweetsRule",
         all_of(_community_protected,
                not_(flag("viewer_is_community_member"))),
         Action.DROP, "community_protected"),
    Rule("FilterProtectedCommunityTweetsRule",
         all_of(_community_protected,
                not_(flag("viewer_is_community_member"))),
         Action.DROP, "community_protected_filter"),
    Rule("TombstoneProtectedCommunityTweetsRule",
         all_of(_community_protected,
                not_(flag("viewer_is_community_member"))),
         Action.TOMBSTONE, "community_protected_tombstone"),
    Rule("DropAuthorRemovedCommunityTweetsRule", _community_removed,
         Action.DROP, "community_author_removed"),
    Rule("DropAllAuthorRemovedCommunityTweetsRule", _community_removed,
         Action.DROP, "community_author_removed_all"),
    Rule("FilterAuthorRemovedCommunityTweetsRule", _community_removed,
         Action.DROP, "community_author_removed_filter"),
    Rule("TombstoneAuthorRemovedCommunityTweetsRule", _community_removed,
         Action.TOMBSTONE, "community_author_removed_tombstone"),
    Rule("DropCommunityTweetCommunityNotVisibleRule", _community_not_visible,
         Action.DROP, "community_not_visible"),
    Rule("FilterCommunityTweetCommunityNotVisibleRule",
         _community_not_visible, Action.DROP,
         "community_not_visible_filter"),
    Rule("TombstoneCommunityTweetCommunityNotVisibleRule",
         _community_not_visible, Action.TOMBSTONE,
         "community_not_visible_tombstone"),
    Rule("DropOuterCommunityTweetsRule",
         all_of(flag("is_quote"), _community), Action.DROP,
         "community_outer"),
    Rule("DropCommunityNonMemberPollCardRule",
         all_of(_non_member, flag("has_poll_card")), Action.DROP,
         "community_poll_non_member"),
    Rule("CommunityTweetHiddenLimitedActionsRule", _community_hidden,
         Action.LIMITED_ENGAGEMENTS, "community_hidden_limited"),
    Rule("CommunityTweetMemberRemovedLimitedActionsRule", _community_removed,
         Action.LIMITED_ENGAGEMENTS, "community_removed_limited"),
    Rule("CommunityTweetCommunitySuspendedLimitedActionsRule",
         all_of(_community, flag("community_suspended")),
         Action.LIMITED_ENGAGEMENTS, "community_suspended_limited"),
    Rule("CommunityTweetCommunityDeletedLimitedActionsRule",
         all_of(_community, flag("community_deleted")),
         Action.LIMITED_ENGAGEMENTS, "community_deleted_limited"),
    Rule("CommunityTweetCommunityNotFoundLimitedActionsRule",
         all_of(_community, flag("community_not_found")),
         Action.LIMITED_ENGAGEMENTS, "community_not_found_limited"),
    Rule("CommunityTweetCommunityUnavailableLimitedActionsRule",
         all_of(_community, flag("community_unavailable")),
         Action.LIMITED_ENGAGEMENTS, "community_unavailable_limited"),
    Rule("CommunityTweetModeratedLimitedActionsRule",
         all_of(_community, flag("community_tweet_moderated")),
         Action.LIMITED_ENGAGEMENTS, "community_moderated_limited"),
    Rule("CommunityTweetNonMemberLimitedActionsRule", _non_member,
         Action.LIMITED_ENGAGEMENTS, "community_non_member_limited"),
    Rule("CommunityTweetMemberLimitedActionsRule",
         all_of(_community, flag("viewer_is_community_member")),
         Action.LIMITED_ENGAGEMENTS, "community_member_limited"),
]

# -- exclusive (super-follows) + trusted-friends content -----------------------

_exclusive = flag("is_exclusive_tweet")
_not_subscribed = all_of(_exclusive, not_(flag("viewer_is_subscribed")))
_trusted = flag("is_trusted_friends_tweet")
_not_trusted = all_of(_trusted, not_(flag("viewer_is_trusted_friend")))

EXCLUSIVE_TRUSTED_RULES: List[Rule] = [
    Rule("DropAllExclusiveTweetsRule", _exclusive, Action.DROP,
         "exclusive_all"),
    Rule("DropExclusiveTweetContentRule", _not_subscribed, Action.DROP,
         "exclusive_not_subscribed"),
    Rule("FilterExclusiveTweetContentRule", _not_subscribed, Action.DROP,
         "exclusive_filter"),
    Rule("TombstoneExclusiveTweetContentRule", _not_subscribed,
         Action.TOMBSTONE, "exclusive_tombstone"),
    Rule("TombstoneExclusiveQuotedTweetContentRule",
         all_of(flag("is_inner_quoted"), _not_subscribed),
         Action.TOMBSTONE, "exclusive_quoted_tombstone"),
    Rule("DropAllTrustedFriendsTweetsRule", _trusted, Action.DROP,
         "trusted_friends_all"),
    Rule("DropTrustedFriendsTweetContentRule", _not_trusted, Action.DROP,
         "trusted_friends_not_member"),
    Rule("FilterTrustedFriendsTweetContentRule", _not_trusted, Action.DROP,
         "trusted_friends_filter"),
    Rule("TombstoneTrustedFriendsTweetContentRule", _not_trusted,
         Action.TOMBSTONE, "trusted_friends_tombstone"),
    Rule("TrustedFriendsTweetLimitedEngagementsRule", _trusted,
         Action.LIMITED_ENGAGEMENTS, "trusted_friends_limited"),
    Rule("DropAllCollabInvitationTweetsRule",
         flag("is_collab_invitation"), Action.DROP, "collab_invitation"),
]

# -- spam breadth --------------------------------------------------------------

SPAM_BREADTH_RULES: List[Rule] = [
    Rule("SmyteSpamTweetLabelDropRule", tweet_label("smyte_spam"),
         Action.DROP, "smyte_spam"),
    Rule("SmyteSpamTweetLabelDropSearchRule", tweet_label("smyte_spam"),
         Action.DROP, "smyte_spam_search"),
    Rule("SmyteSpamTweetLabelRule", non_follower(tweet_label("smyte_spam")),
         Action.DOWNRANK, "smyte_spam_downrank"),
    Rule("SmyteSpamTweetLabelTombstoneRule", tweet_label("smyte_spam"),
         Action.TOMBSTONE, "smyte_spam_tombstone"),
    Rule("SpamHighRecallTweetLabelDropRule",
         tweet_label("spam_high_recall"), Action.DROP, "spam_hr_drop"),
    Rule("SpamHighRecallTweetLabelRule",
         non_follower(tweet_label("spam_high_recall")), Action.DOWNRANK,
         "spam_hr_downrank"),
    Rule("SpamHighRecallTweetLabelTombstoneRule",
         tweet_label("spam_high_recall"), Action.TOMBSTONE,
         "spam_hr_tombstone"),
    Rule("SpamAllUsersTweetLabelRule", tweet_label("spam"), Action.DROP,
         "spam_all"),
    Rule("SpamTweetLabelTombstoneRule", tweet_label("spam"),
         Action.TOMBSTONE, "spam_tombstone"),
    Rule("SpamQuotedTweetLabelTombstoneRule",
         all_of(flag("is_inner_quoted"), tweet_label("spam")),
         Action.TOMBSTONE, "spam_quoted_tombstone"),
    Rule("DeciderableSpamHighRecallAuthorLabelDropRule",
         author_label("spam_high_recall"), Action.DROP, "spam_hr_author"),
    Rule("DeciderableSpamHighRecallAuthorLabelTombstoneRule",
         author_label("spam_high_recall"), Action.TOMBSTONE,
         "spam_hr_author_tombstone"),
    Rule("SpammyUserModelHighPrecisionDropTweetRule",
         author_label("spammy_user_model_high_precision"), Action.DROP,
         "spammy_user_model"),
    Rule("SpammyFollowerRule", non_follower(author_label("spammy_follower")),
         Action.DOWNRANK, "spammy_follower"),
    Rule("FirstPageSearchResultAgathaSpamDropRule",
         all_of(flag("is_first_page_result"),
                score_above("agatha_spam_score", 0.9)),
         Action.DROP, "first_page_agatha_spam"),
    Rule("CopypastaSpamAllViewersTweetLabelRule",
         tweet_label("copypasta_spam"), Action.DOWNRANK, "copypasta_all"),
    Rule("CopypastaSpamAllViewersSearchTweetLabelRule",
         tweet_label("copypasta_spam"), Action.DROP, "copypasta_search"),
    Rule("CopypastaSpamNonFollowerSearchTweetLabelRule",
         non_follower(tweet_label("copypasta_spam")), Action.DROP,
         "copypasta_nf_search"),
    Rule("CopypastaSpamAbusiveQualityTweetLabelRule",
         non_author(tweet_label("copypasta_spam")), Action.DOWNRANK,
         "copypasta_abusive_quality"),
]

# -- safety-crisis levels ------------------------------------------------------

SAFETY_CRISIS_RULES: List[Rule] = [
    Rule("SafetyCrisisAnyLevelDropRule",
         lambda f: int(f.get("safety_crisis_level", 0)) >= 1,
         Action.DROP, "crisis_any"),
    Rule("SafetyCrisisLevel2DropRule",
         lambda f: int(f.get("safety_crisis_level", 0)) >= 2,
         Action.DROP, "crisis_l2"),
    Rule("SafetyCrisisLevel3DropRule",
         lambda f: int(f.get("safety_crisis_level", 0)) >= 3,
         Action.DROP, "crisis_l3"),
    Rule("SafetyCrisisLevel4DropRule",
         lambda f: int(f.get("safety_crisis_level", 0)) >= 4,
         Action.DROP, "crisis_l4"),
    Rule("SafetyCrisisLevel3SectionRule",
         lambda f: int(f.get("safety_crisis_level", 0)) >= 3,
         Action.DOWNRANK, "crisis_l3_section"),
    Rule("SafetyCrisisLevel4SectionRule",
         lambda f: int(f.get("safety_crisis_level", 0)) >= 4,
         Action.DOWNRANK, "crisis_l4_section"),
]

# -- muted keywords per surface ------------------------------------------------

MUTED_KEYWORD_BREADTH_RULES: List[Rule] = [
    Rule("ViewerHasMatchingMutedKeywordForHomeTimelineRule",
         non_author(muted_keyword), Action.DROP, "muted_kw_home"),
    Rule("ViewerHasMatchingMutedKeywordForNotificationsRule",
         non_author(muted_keyword), Action.DROP, "muted_kw_notifications"),
    Rule("ViewerHasMatchingMutedKeywordForTweetRepliesRule",
         non_author(muted_keyword), Action.INTERSTITIAL, "muted_kw_replies"),
    Rule("ViewerHasMatchingMutedKeywordForHomeTimelinePromotedTweetRule",
         all_of(flag("is_promoted"), muted_keyword), Action.DROP,
         "muted_kw_promoted"),
    Rule("MutedKeywordForTweetRepliesInterstitialRule",
         non_author(muted_keyword), Action.INTERSTITIAL,
         "muted_kw_replies_interstitial"),
    Rule("MutedKeywordForQuotedTweetTweetDetailInterstitialRule",
         all_of(flag("is_inner_quoted"), muted_keyword),
         Action.INTERSTITIAL, "muted_kw_quoted"),
]

# -- viewer↔author relation breadth -------------------------------------------

VIEWER_RELATION_RULES: List[Rule] = [
    Rule("AuthorBlocksViewerDropRule", flag("author_blocks_viewer"),
         Action.DROP, "author_blocks_drop"),
    Rule("AuthorBlocksViewerTombstoneRule", flag("author_blocks_viewer"),
         Action.TOMBSTONE, "author_blocks_tombstone"),
    Rule("AuthorBlocksViewerUnspecifiedRule", flag("author_blocks_viewer"),
         Action.TOMBSTONE, "author_blocks_unspecified"),
    Rule("AuthorBlocksOuterAuthorRule",
         all_of(flag("is_inner_quoted"), flag("author_blocks_outer_author")),
         Action.TOMBSTONE, "author_blocks_outer"),
    Rule("ViewerBlocksAuthorRule", flag("viewer_blocks_author"),
         Action.DROP, "viewer_blocks"),
    Rule("ViewerBlocksAuthorInterstitialRule", flag("viewer_blocks_author"),
         Action.INTERSTITIAL, "viewer_blocks_interstitial"),
    Rule("ViewerBlocksAuthorInnerQuotedTweetInterstitialRule",
         all_of(flag("is_inner_quoted"), flag("viewer_blocks_author")),
         Action.INTERSTITIAL, "viewer_blocks_quoted"),
    Rule("ViewerBlocksAuthorHomeTimelinePromotedTweetRule",
         all_of(flag("is_promoted"), flag("viewer_blocks_author")),
         Action.DROP, "viewer_blocks_promoted"),
    Rule("ViewerBlocksAuthorViewerOptInBlockingOnSearchRule",
         opt_in_blocking(flag("viewer_blocks_author")), Action.DROP,
         "viewer_blocks_search"),
    Rule("ViewerMutesAuthorRule",
         all_of(flag("viewer_mutes_author"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "viewer_mutes"),
    Rule("ViewerMutesAuthorInterstitialRule", flag("viewer_mutes_author"),
         Action.INTERSTITIAL, "viewer_mutes_interstitial"),
    Rule("ViewerMutesAuthorInnerQuotedTweetInterstitialRule",
         all_of(flag("is_inner_quoted"), flag("viewer_mutes_author")),
         Action.INTERSTITIAL, "viewer_mutes_quoted"),
    Rule("ViewerMutesAuthorHomeTimelinePromotedTweetRule",
         all_of(flag("is_promoted"), flag("viewer_mutes_author")),
         Action.DROP, "viewer_mutes_promoted"),
    Rule("ViewerMutesAuthorViewerOptInBlockingOnSearchRule",
         opt_in_blocking(flag("viewer_mutes_author")), Action.DROP,
         "viewer_mutes_search"),
    Rule("ViewerMutesAndDoesNotFollowAuthorRule",
         all_of(flag("viewer_mutes_author"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "viewer_mutes_not_follows"),
    Rule("ViewerReportsAuthorInterstitialRule",
         flag("viewer_reported_author"), Action.INTERSTITIAL,
         "viewer_reported_author"),
    Rule("MutedRetweetsRule",
         all_of(flag("is_retweet"), flag("viewer_mutes_retweets_of_author")),
         Action.DROP, "muted_retweets"),
    Rule("ViewerIsAuthorDropRule", flag("viewer_is_author"), Action.DROP,
         "viewer_is_author"),
    Rule("ViewerIsNotAuthorDropRule", not_(flag("viewer_is_author")),
         Action.DROP, "viewer_is_not_author"),
    Rule("ViewerIsUnmentionedRule", flag("viewer_unmentioned"),
         Action.DROP, "viewer_unmentioned"),
    Rule("ViewerIsSoftUserDropRule", flag("viewer_is_soft_user"),
         Action.DROP, "viewer_soft_user"),
    Rule("OnlyPeopleIFollowRule",
         all_of(flag("viewer_filters_to_follows"),
                not_(flag("viewer_follows_author")),
                not_(flag("viewer_is_author"))),
         Action.DROP, "only_people_i_follow"),
    Rule("RetweetDropRule", flag("is_retweet"), Action.DROP, "retweets"),
    Rule("NullcastedTweetRule", flag("is_nullcasted"), Action.DROP,
         "nullcasted"),
]

# -- unavailable author / viewer states ----------------------------------------

UNAVAILABLE_STATE_RULES: List[Rule] = [
    Rule("ErasedAuthorRule", author_label("erased"), Action.TOMBSTONE,
         "author_erased", fail_closed=True),
    Rule("OffboardedAuthorRule", author_label("offboarded"),
         Action.TOMBSTONE, "author_offboarded"),
    Rule("SuspendedViewerRule", flag("viewer_is_suspended"), Action.DROP,
         "viewer_suspended", fail_closed=True),
    Rule("DeactivatedViewerRule", flag("viewer_is_deactivated"),
         Action.DROP, "viewer_deactivated", fail_closed=True),
    Rule("ProtectedAuthorDropRule",
         non_follower(flag("author_is_protected")), Action.DROP,
         "protected_author_drop", fail_closed=True),
    Rule("ProtectedAuthorTombstoneRule",
         non_follower(flag("author_is_protected")), Action.TOMBSTONE,
         "protected_author_tombstone", fail_closed=True),
    Rule("ProtectedQuoteTweetAuthorRule",
         all_of(flag("is_inner_quoted"),
                non_follower(flag("author_is_protected"))),
         Action.TOMBSTONE, "protected_quoted"),
    Rule("DropAllProtectedAuthorRule", flag("author_is_protected"),
         Action.DROP, "protected_all", fail_closed=True),
    Rule("DropProtectedViewerIfPresentRule", flag("viewer_is_protected"),
         Action.DROP, "protected_viewer"),
]

# -- UQF (viewer quality-filter) variants --------------------------------------

UQF_RULES: List[Rule] = [
    Rule("AbusiveUqfNonFollowerTweetLabelRule",
         uqf(non_follower(tweet_label("abusive"))), Action.DROP,
         "abusive_uqf_nf"),
    Rule("NonFollowerWithUqfTweetLabelRule",
         uqf(non_follower(tweet_label("low_quality"))), Action.DROP,
         "low_quality_uqf_nf"),
    Rule("NonFollowerWithUqfUserLabelDropRule",
         uqf(non_follower(author_label("low_quality"))), Action.DROP,
         "low_quality_author_uqf"),
    Rule("ViewerWithUqfTweetLabelRule",
         uqf(non_author(tweet_label("low_quality"))), Action.DOWNRANK,
         "low_quality_uqf"),
    Rule("DuplicateMentionUqfTweetLabelRule",
         uqf(non_follower(tweet_label("duplicate_mention"))), Action.DROP,
         "duplicate_mention_uqf"),
    Rule("UntrustedUrlUqfNonFollowerTweetLabelRule",
         uqf(non_follower(tweet_label("untrusted_url"))), Action.DROP,
         "untrusted_url_uqf"),
    Rule("LowQualityNonFollowerWithUqfRule",
         uqf(non_follower(author_label("low_quality"))), Action.DOWNRANK,
         "low_quality_nf_uqf"),
    Rule("CompromisedNonFollowerWithUqfRule",
         uqf(non_follower(author_label("compromised"))), Action.DROP,
         "compromised_uqf"),
    Rule("EngagementSpammerNonFollowerWithUqfRule",
         uqf(non_follower(author_label("engagement_spammer"))),
         Action.DROP, "engagement_spammer_uqf"),
    Rule("EngagementSpammerHighRecallNonFollowerWithUqfRule",
         uqf(non_follower(author_label("engagement_spammer_high_recall"))),
         Action.DROP, "engagement_spammer_hr_uqf"),
    Rule("SpamHighRecallNonFollowerWithUqfRule",
         uqf(non_follower(author_label("spam_high_recall"))), Action.DROP,
         "spam_hr_uqf"),
    Rule("DownrankSpamReplyNonFollowerWithUqfRule",
         uqf(non_follower(all_of(flag("is_reply"),
                                 tweet_label("spam_reply")))),
         Action.DOWNRANK, "spam_reply_uqf"),
    Rule("DownrankSpamReplyUqfNonFollowerTweetLabelRule",
         uqf(non_follower(tweet_label("spam_reply"))), Action.DOWNRANK,
         "spam_reply_uqf_nf"),
    Rule("ReadOnlyNonFollowerWithUqfRule",
         uqf(non_follower(author_label("read_only"))), Action.DOWNRANK,
         "read_only_uqf"),
    Rule("ReadOnlyRule", author_label("read_only"), Action.DOWNRANK,
         "read_only"),
    Rule("NotGraduatedNonFollowerRule",
         non_follower(author_label("not_graduated")), Action.DROP,
         "not_graduated_nf"),
    Rule("NotGraduatedRule", author_label("not_graduated"),
         Action.DOWNRANK, "not_graduated_plain"),
    Rule("LikelyIvsLabelNonFollowerDropUserRule",
         non_follower(author_label("likely_ivs")), Action.DROP,
         "likely_ivs_user"),
    Rule("LikelyIvsLabelNonFollowerDropRule",
         non_follower(tweet_label("likely_ivs")), Action.DROP,
         "likely_ivs"),
]

# -- sensitive-media per-setting variants --------------------------------------

SENSITIVE_MEDIA_SETTING_RULES: List[Rule] = []
for _cat, _label in (("adult_content", "Adult"),
                     ("graphic_violence", "Violent"),
                     ("other_sensitive", "OtherSensitive")):
    SENSITIVE_MEDIA_SETTING_RULES += [
        Rule(f"{_label}MediaTweetLabelDropRule",
             non_author(media_setting(_cat, "drop")), Action.DROP,
             f"media_{_cat}_drop"),
        Rule(f"{_label}MediaTweetLabelInterstitialRule",
             non_author(media_setting(_cat, "interstitial")),
             Action.INTERSTITIAL, f"media_{_cat}_interstitial"),
        Rule(f"{_label}MediaTweetLabelDropSettingLevelTombstoneRule",
             non_author(media_setting(_cat, "drop")), Action.TOMBSTONE,
             f"media_{_cat}_tombstone"),
    ]

# -- search breadth ------------------------------------------------------------

SEARCH_BREADTH_RULES: List[Rule] = [
    Rule("SearchBlacklistRule", tweet_label("search_blacklist"),
         Action.DROP, "search_blacklist_plain"),
    Rule("SearchBlacklistHighRecallTweetLabelDropRule",
         tweet_label("search_blacklist_high_recall"), Action.DROP,
         "search_blacklist_hr"),
    Rule("SearchNsfwTextRule",
         all_of(tweet_label("nsfw_text"), _no_opt_in), Action.DROP,
         "search_nsfw_text"),
    Rule("SearchEdiSafeSearchWithoutUserInQueryDropRule",
         all_of(flag("safe_search_on"), not_(flag("user_in_query")),
                any_of(tweet_label("nsfw_high_recall"),
                       flag("is_nsfw_media"))),
         Action.DROP, "search_edi_safe"),
    Rule("FirstPageSearchResultWithTweetLabelRule",
         all_of(flag("is_first_page_result"),
                any_of(tweet_label("spam_high_recall"),
                       tweet_label("low_quality"))),
         Action.DROP, "first_page_labeled"),
    Rule("FirstPageSearchResultSmartOutOfNetworkWithTweetLabelRule",
         all_of(flag("is_first_page_result"),
                not_(flag("viewer_follows_author")),
                tweet_label("low_quality")),
         Action.DROP, "first_page_oon_labeled"),
    Rule("ReportedTweetInterstitialRule", flag("viewer_reported_tweet"),
         Action.INTERSTITIAL, "reported_tweet"),
    Rule("ReportedTweetInterstitialSearchRule",
         flag("viewer_reported_tweet"), Action.INTERSTITIAL,
         "reported_tweet_search"),
    Rule("HighSpammyTweetContentScoreSearchTopTweetLabelDropRule",
         score_above("spammy_content_score", 0.9), Action.DROP,
         "spammy_content_search_top"),
    Rule("HighSpammyTweetContentScoreSearchLatestTweetLabelDropRule",
         score_above("spammy_content_score", 0.85), Action.DROP,
         "spammy_content_search_latest"),
    Rule("HighSpammyTweetContentScoreTrendsTopTweetLabelDropRule",
         score_above("spammy_content_score", 0.9), Action.DROP,
         "spammy_content_trends_top"),
    Rule("HighSpammyTweetContentScoreTrendsLatestTweetLabelDropRule",
         score_above("spammy_content_score", 0.85), Action.DROP,
         "spammy_content_trends_latest"),
    Rule("HighSpammyTweetContentScoreConvoDownrankAbusiveQualityRule",
         score_above("spammy_content_score", 0.95), Action.DOWNRANK,
         "spammy_content_convo"),
    Rule("HighPSpammyTweetScoreSearchTweetLabelDropRule",
         score_above("pspammy_score", 0.9), Action.DROP, "pspammy_search"),
    Rule("HighPSpammyScoreAllViewerDropRule",
         score_above("pspammy_score", 0.98), Action.DROP, "pspammy_all"),
    Rule("HighProactiveTosScoreTweetLabelDropRule",
         score_above("proactive_tos_score", 0.95), Action.DROP,
         "proactive_tos_drop"),
    Rule("HighProactiveTosScoreTweetLabelDropSearchRule",
         score_above("proactive_tos_score", 0.93), Action.DROP,
         "proactive_tos_search"),
    Rule("SearchAvoidTweetNsfwAdminRule", _nsfw_admin, Action.AVOID,
         "search_avoid_nsfw_admin"),
    Rule("SearchAvoidTweetNsfwUserRule", _nsfw_user, Action.AVOID,
         "search_avoid_nsfw_user"),
    Rule("SearchLikelyIvsLabelNonFollowerDropUserRule",
         non_follower(author_label("likely_ivs")), Action.DROP,
         "search_likely_ivs"),
    Rule("DropStaleTweetsRule", flag("is_stale"), Action.DROP, "stale"),
    Rule("StaleTweetLimitedActionsRule", flag("is_stale"),
         Action.LIMITED_ENGAGEMENTS, "stale_limited"),
]

# -- advanced filtering (reference rule names) ---------------------------------

ADV_FILTER_REFNAME_RULES: List[Rule] = [
    Rule("NoConfirmedEmailRule",
         all_of(flag("viewer_filters_no_confirmed_email"),
                flag("author_has_no_confirmed_email"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "no_confirmed_email"),
    Rule("NoConfirmedPhoneRule",
         all_of(flag("viewer_filters_no_confirmed_phone"),
                flag("author_has_no_confirmed_phone"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "no_confirmed_phone"),
    Rule("NoDefaultProfileImageRule",
         all_of(flag("viewer_filters_default_profile_image"),
                flag("author_has_default_profile_image"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "no_default_profile_image"),
    Rule("NoNewUsersRule",
         all_of(flag("viewer_filters_new_accounts"),
                flag("author_is_new_account"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "no_new_users"),
    Rule("NoNotFollowedByRule",
         all_of(flag("viewer_filters_not_followed_by"),
                not_(flag("author_follows_viewer")),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "no_not_followed_by"),
]

# -- do-not-amplify ------------------------------------------------------------

DO_NOT_AMPLIFY_RULES: List[Rule] = [
    Rule("DoNotAmplifyDropRule", tweet_label("do_not_amplify"),
         Action.DROP, "dna_drop"),
    Rule("DoNotAmplifyAllViewersDropRule", tweet_label("do_not_amplify"),
         Action.DROP, "dna_all_drop"),
    Rule("DoNotAmplifyNonFollowerRule",
         non_follower(tweet_label("do_not_amplify")), Action.DROP,
         "dna_nf"),
    Rule("DoNotAmplifySectionRule", tweet_label("do_not_amplify"),
         Action.DOWNRANK, "dna_section"),
    Rule("DoNotAmplifySectionUserRule", author_label("do_not_amplify"),
         Action.DOWNRANK, "dna_user_section"),
    Rule("DoNotAmplifyTweetLabelAvoidRule", tweet_label("do_not_amplify"),
         Action.AVOID, "dna_avoid"),
    Rule("DoNotAmplifyUserRule",
         non_follower(author_label("do_not_amplify")), Action.DROP,
         "dna_user"),
    Rule("RecommendationsBlacklistRule",
         author_label("recommendations_blacklist"), Action.DROP,
         "recs_blacklist"),
]

# -- ad avoidance / model-score avoid ------------------------------------------

AVOID_RULES: List[Rule] = [
    Rule("AvoidHighToxicityModelScoreRule",
         score_above("toxicity_score", 0.85), Action.AVOID,
         "avoid_toxicity"),
    Rule("AvoidReportedTweetModelScoreRule",
         score_above("reported_tweet_score", 0.8), Action.AVOID,
         "avoid_reported"),
    Rule("DynamicProductAdDropTweetLabelRule",
         all_of(flag("is_dynamic_product_ad"),
                tweet_label("ad_quality_violation")),
         Action.DROP, "dpa_drop"),
    Rule("DynamicProductAdLimitedEngagementTweetLabelRule",
         flag("is_dynamic_product_ad"), Action.LIMITED_ENGAGEMENTS,
         "dpa_limited"),
    Rule("AdsManagerDenyListAllUsersTweetLabelRule",
         tweet_label("ads_manager_denylist"), Action.DROP,
         "ads_manager_denylist"),
    Rule("SkipTweetDetailLimitedEngagementTweetLabelRule",
         tweet_label("limited_engagements"), Action.LIMITED_ENGAGEMENTS,
         "limited_engagements_label"),
]

# -- duplicate / low-quality variants ------------------------------------------

DUP_LOWQ_RULES: List[Rule] = [
    Rule("DuplicateContentTweetLabelTombstoneRule",
         tweet_label("duplicate_content"), Action.TOMBSTONE,
         "duplicate_tombstone"),
    Rule("LowQualityTweetLabelDropRule", tweet_label("low_quality"),
         Action.DROP, "low_quality_drop"),
    Rule("LowQualityTweetLabelTombstoneRule", tweet_label("low_quality"),
         Action.TOMBSTONE, "low_quality_tombstone"),
    Rule("LiveLowQualityRule", non_author(tweet_label("live_low_quality")),
         Action.DOWNRANK, "live_low_quality_plain"),
    Rule("PdnaAllUsersTweetLabelRule", tweet_label("pdna"), Action.DROP,
         "pdna_all", fail_closed=True),
    Rule("PdnaTweetLabelTombstoneRule", tweet_label("pdna"),
         Action.TOMBSTONE, "pdna_tombstone", fail_closed=True),
    Rule("PdnaQuotedTweetLabelTombstoneRule",
         all_of(flag("is_inner_quoted"), tweet_label("pdna")),
         Action.TOMBSTONE, "pdna_quoted", fail_closed=True),
    Rule("UntrustedUrlAllViewersTweetLabelRule",
         tweet_label("untrusted_url"), Action.DROP, "untrusted_url_all"),
    Rule("UntrustedUrlConversationsTweetLabelRule",
         non_author(tweet_label("untrusted_url")), Action.DOWNRANK,
         "untrusted_url_convo"),
    Rule("DownrankSpamReplyAllViewersTweetLabelRule",
         tweet_label("spam_reply"), Action.DOWNRANK, "spam_reply_all"),
    Rule("DownrankSpamReplyConversationsAuthorLabelRule",
         non_author(author_label("spam_reply")), Action.DOWNRANK,
         "spam_reply_author"),
    Rule("DropCardUriRootDomainDenylistRule",
         tweet_label("card_denylisted_domain"), Action.DROP,
         "card_denylist"),
    Rule("DropTweetsWithGeoRestrictedMediaRule",
         flag("has_geo_restricted_media"), Action.DROP,
         "geo_restricted_media"),
    Rule("DropProtectedAuthorPollCardRule",
         all_of(flag("author_is_protected"), flag("has_poll_card"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "protected_poll"),
    Rule("TsViolationRule", tweet_label("ts_violation"), Action.DROP,
         "ts_violation", fail_closed=True),
    Rule("EmergencyDropRule", tweet_label("emergency_drop"), Action.DROP,
         "emergency", fail_closed=True),
    Rule("EmergencyDynamicInterstitialRule",
         tweet_label("emergency_interstitial"), Action.INTERSTITIAL,
         "emergency_interstitial"),
    Rule("ExperimentalNudgeLabelRule", tweet_label("experimental_nudge"),
         Action.INTERSTITIAL, "experimental_nudge"),
    Rule("TweetReplyNudgeRule",
         non_author(all_of(flag("is_reply"),
                           score_above("toxicity_score", 0.75))),
         Action.INTERSTITIAL, "reply_nudge"),
]

# -- DM conversations / events (DmConversationRules / DmEventRules) ------------

DM_BREADTH_RULES: List[Rule] = [
    Rule("DmConversationDropBlockedUserRule", flag("viewer_blocks_author"),
         Action.DROP, "dm_convo_blocked"),
    Rule("DmConversationDropSuspendedUserRule", author_label("suspended"),
         Action.DROP, "dm_convo_suspended", fail_closed=True),
    Rule("DmConversationDropDeactivatedUserRule",
         author_label("deactivated"), Action.DROP, "dm_convo_deactivated"),
    Rule("DmConversationSpamRequestDropRule",
         non_follower(author_label("spam")), Action.DROP,
         "dm_convo_spam_request"),
    Rule("DmConversationNsfwUserInterstitialRule",
         all_of(author_label("nsfw"), _no_opt_in), Action.INTERSTITIAL,
         "dm_convo_nsfw_user"),
    Rule("DmEventDeletedTombstoneRule", flag("is_deleted"),
         Action.TOMBSTONE, "dm_event_deleted"),
    Rule("DmEventSpamDropRule",
         non_follower(tweet_label("spam_high_recall")),
         Action.DROP, "dm_event_spam"),
    Rule("DmEventPerspectivalNsfwInterstitialRule",
         all_of(flag("is_nsfw_media"), _no_opt_in), Action.INTERSTITIAL,
         "dm_event_nsfw"),
    Rule("DmEventMalwareUrlDropRule",
         any_of(tweet_label("malware_url"), tweet_label("phishing_url")),
         Action.DROP, "dm_event_malware", fail_closed=True),
    Rule("DmEventUntrustedUrlInterstitialRule",
         non_follower(tweet_label("untrusted_url")), Action.INTERSTITIAL,
         "dm_event_untrusted_url"),
    Rule("DmEventCsamDropRule", tweet_label("pdna"), Action.DROP,
         "dm_event_csam", fail_closed=True),
    Rule("DmConversationUnavailableTombstoneRule",
         flag("conversation_unavailable"), Action.TOMBSTONE,
         "dm_convo_unavailable"),
]

# -- spaces breadth (SpaceRules.scala) -----------------------------------------

SPACE_BREADTH_RULES: List[Rule] = [
    Rule("SpaceDoNotAmplifyAllUsersRule", author_label("do_not_amplify"),
         Action.DROP, "space_dna"),
    Rule("SpaceCoordHarmfulActivityHighRecallAllUsersRule",
         author_label("coordinated_harmful_high_recall"), Action.DROP,
         "space_chr"),
    Rule("SpaceUkraineCrisisTopicAllUsersRule",
         tweet_label("crisis_topic"), Action.DROP, "space_crisis_topic"),
    Rule("SpaceMisinfoHighRecallAllUsersRule",
         author_label("misinfo_high_recall"), Action.DROP,
         "space_misinfo_hr"),
    Rule("SpaceHatefulHighRecallAllUsersRule",
         author_label("hateful_high_recall"), Action.DROP,
         "space_hateful_hr"),
    Rule("SpaceViolenceHighRecallAllUsersRule",
         author_label("violence_high_recall"), Action.DROP,
         "space_violence_hr"),
    Rule("SpaceDeactivatedHostTombstoneRule", author_label("deactivated"),
         Action.TOMBSTONE, "space_deactivated_host"),
    Rule("SpaceProtectedHostNonFollowerDropRule",
         non_follower(flag("author_is_protected")), Action.DROP,
         "space_protected_host"),
]

# -- trivial terminal rules (Rules.scala) --------------------------------------

TERMINAL_RULES: List[Rule] = [
    Rule("AllowAllRule", lambda f: False, Action.ALLOW, "allow_all"),
    Rule("DropAllRule", lambda f: True, Action.DROP, "drop_all"),
    Rule("AlwaysActRule", lambda f: True, Action.DROP, "always_act"),
    Rule("TestRule", flag("test_condition"), Action.DROP, "test"),
]


# -- sensitive-media per-label triads (SensitiveMediaSettingsRules.scala) ------
#
# The full per-media-label × per-viewer-setting matrix: each media safety
# label crossed with the viewer's category setting yields a Drop /
# Interstitial / DropSettingLevelTombstone triad — ≡ the
# ``AdultMediaNsfw*``/``ViolentMediaGoreAndViolence*``/
# ``OtherSensitiveMediaNsfw*`` rule objects.

_MEDIA_LABEL_FAMILIES = (
    ("AdultMediaNsfwCardImageTweetLabel", "adult_content",
     "nsfw_card_image"),
    ("AdultMediaNsfwHighPrecisionTweetLabel", "adult_content",
     "nsfw_high_precision"),
    ("AdultMediaNsfwHighRecallTweetLabel", "adult_content",
     "nsfw_high_recall"),
    ("AdultMediaNsfwReportedHeuristicsTweetLabel", "adult_content",
     "nsfw_reported_heuristics"),
    ("AdultMediaNsfwTextTweetLabel", "adult_content", "nsfw_text"),
    ("AdultMediaNsfwVideoTweetLabel", "adult_content", "nsfw_video"),
    ("ViolentMediaGoreAndViolenceHighPrecision", "graphic_violence",
     "gore_and_violence_high_precision"),
    ("ViolentMediaGoreAndViolenceReportedHeuristics", "graphic_violence",
     "gore_and_violence_reported_heuristics"),
    ("OtherSensitiveMediaNsfwAdminTweetFlag", "other_sensitive",
     "nsfw_admin_flag"),
    ("OtherSensitiveMediaNsfwUserTweetFlag", "other_sensitive",
     "nsfw_user_flag"),
)

def _setting_is(cat: str, wanted: str):
    """The viewer's per-category sensitive-media setting alone — the
    per-LABEL rules carry their own media evidence (the label), unlike
    :func:`media_setting` whose rules key on the media-category list.
    An opted-in viewer's default is "allow" (SensitiveMediaSettings
    defaults follow the legacy nsfw opt-in until set explicitly)."""

    def cond(f):
        default = "allow" if f.get("nsfw_opt_in") else "interstitial"
        return f.get(f"media_setting_{cat}", default) == wanted

    return cond


SENSITIVE_MEDIA_PER_LABEL_RULES: List[Rule] = []
for _pfx, _cat, _lbl in _MEDIA_LABEL_FAMILIES:
    SENSITIVE_MEDIA_PER_LABEL_RULES += [
        Rule(f"{_pfx}DropRule",
             non_author(all_of(tweet_label(_lbl),
                               _setting_is(_cat, "drop"))),
             Action.DROP, f"{_lbl}_{_cat}_drop"),
        Rule(f"{_pfx}InterstitialRule",
             non_author(all_of(tweet_label(_lbl),
                               _setting_is(_cat, "interstitial"))),
             Action.INTERSTITIAL, f"{_lbl}_{_cat}_interstitial"),
        Rule(f"{_pfx}DropSettingLevelTombstoneRule",
             non_author(all_of(tweet_label(_lbl),
                               _setting_is(_cat, "drop"))),
             Action.TOMBSTONE, f"{_lbl}_{_cat}_tombstone"),
    ]

# -- user-unavailable tombstone matrix (UserUnavailableStateTombstoneRules) ----
#
# author-state × rendering-context (top-level tweet / retweet inner tweet /
# inner quoted tweet) — the thread/conversation placeholder semantics.

_UNAVAILABLE_STATES = (
    ("Deactivated", author_label("deactivated")),
    ("Erased", author_label("erased")),
    ("OffBoarded", author_label("offboarded")),
    ("Protected", non_follower(flag("author_is_protected"))),
    ("Suspended", author_label("suspended")),
    ("AuthorBlocksViewer", flag("author_blocks_viewer")),
)

USER_UNAVAILABLE_TOMBSTONE_RULES: List[Rule] = []
for _state, _cond in _UNAVAILABLE_STATES:
    for _ctx, _ctx_flag in (("Tweet", None), ("Retweet", "is_retweet"),
                            ("InnerQuotedTweet", "is_inner_quoted")):
        _c = _cond if _ctx_flag is None else all_of(flag(_ctx_flag), _cond)
        USER_UNAVAILABLE_TOMBSTONE_RULES.append(Rule(
            f"{_state}UserUnavailable{_ctx}TombstoneRule", _c,
            Action.TOMBSTONE,
            f"unavailable_{_state.lower()}_{_ctx.lower()}"))
USER_UNAVAILABLE_TOMBSTONE_RULES += [
    Rule("UserUnavailableTweetTombstoneRule", flag("author_unavailable"),
         Action.TOMBSTONE, "author_unavailable"),
    Rule("ViewerBlocksAuthorUserUnavailableRetweetTombstoneRule",
         all_of(flag("is_retweet"), flag("viewer_blocks_author")),
         Action.TOMBSTONE, "viewer_blocks_retweet"),
    Rule("ViewerBlocksAuthorUserUnavailableInnerQuotedTweetInterstitialRule",
         all_of(flag("is_inner_quoted"), flag("viewer_blocks_author")),
         Action.INTERSTITIAL, "viewer_blocks_quoted"),
    Rule("ViewerMutesAuthorUserUnavailableRetweetTombstoneRule",
         all_of(flag("is_retweet"), flag("viewer_mutes_author")),
         Action.TOMBSTONE, "viewer_mutes_retweet"),
    Rule("ViewerMutesAuthorUserUnavailableInnerQuotedTweetInterstitialRule",
         all_of(flag("is_inner_quoted"), flag("viewer_mutes_author")),
         Action.INTERSTITIAL, "viewer_mutes_quoted"),
]

# -- DM conversation / event structural drops (DmConversationRules.scala,
# DmEventRules.scala) ----------------------------------------------------------

DM_STRUCTURAL_RULES: List[Rule] = [
    Rule("DropDmConversationWithUndefinedConversationInfoRule",
         flag("dm_conversation_info_undefined"), Action.DROP,
         "dm_no_convo_info", fail_closed=True),
    Rule("DropDmConversationWithUndefinedConversationTimelineRule",
         flag("dm_conversation_timeline_undefined"), Action.DROP,
         "dm_no_convo_timeline", fail_closed=True),
    Rule("DropEmptyDmConversationRule", flag("dm_conversation_empty"),
         Action.DROP, "dm_convo_empty"),
    Rule("DropInaccessibleDmConversationRule",
         flag("dm_conversation_inaccessible"), Action.DROP,
         "dm_convo_inaccessible", fail_closed=True),
    Rule("DropOneToOneDmConversationWithUnavailableParticipantsRule",
         all_of(flag("dm_is_one_to_one"),
                flag("dm_participant_unavailable")),
         Action.DROP, "dm_convo_unavailable_participant"),
    Rule("DmEventInOneToOneConversationWithUnavailableUserDropRule",
         all_of(flag("dm_is_one_to_one"),
                flag("dm_participant_unavailable")),
         Action.DROP, "dm_event_unavailable_user"),
    Rule("GroupEventInOneToOneConversationDropRule",
         all_of(flag("dm_is_one_to_one"), flag("dm_is_group_event")),
         Action.DROP, "dm_group_event_in_121"),
    Rule("HiddenAndDeletedDmEventDropRule",
         any_of(flag("dm_event_hidden"), flag("is_deleted")), Action.DROP,
         "dm_event_hidden_deleted"),
    Rule("InaccessibleDmEventDropRule", flag("dm_event_inaccessible"),
         Action.DROP, "dm_event_inaccessible", fail_closed=True),
    Rule("MessageCreateEventWithUnavailableSenderDropRule",
         all_of(flag("dm_is_message_create"),
                flag("dm_sender_unavailable")),
         Action.DROP, "dm_sender_unavailable"),
    Rule("NonPerspectivalDmEventDropRule",
         flag("dm_event_non_perspectival"), Action.DROP,
         "dm_event_non_perspectival"),
    Rule("WelcomeMessageCreateEventOnlyVisibleToRecipientDropRule",
         all_of(flag("dm_is_welcome_message"),
                not_(flag("viewer_is_recipient"))),
         Action.DROP, "dm_welcome_not_recipient"),
]

# -- remaining Rules.scala tail ------------------------------------------------

MISC_TAIL_RULES: List[Rule] = [
    Rule("AbusePolicyEpisodicTweetLabelDropRule",
         non_follower(tweet_label("abuse_policy_episodic")), Action.DROP,
         "abuse_episodic_drop"),
    Rule("AbusePolicyEpisodicTweetLabelInterstitialRule",
         non_author(tweet_label("abuse_policy_episodic")),
         Action.INTERSTITIAL, "abuse_episodic_interstitial"),
    Rule("AbusePolicyEpisodicTweetLabelComplianceTweetNoticeRule",
         tweet_label("abuse_policy_episodic"),
         Action.LIMITED_ENGAGEMENTS, "abuse_episodic_notice"),
    Rule("TweetHasViolationOfAnyLevelFallbackDropRule",
         any_of(tweet_label("violation_any_level"),
                flag("has_unscoped_violation")),
         Action.DROP, "violation_fallback", fail_closed=True),
    Rule("SearchIpiSafeSearchWithoutUserInQueryDropRule",
         opt_in_filtering(all_of(tweet_label("search_ipi"),
                                 not_(flag("query_names_user")))),
         Action.DROP, "search_ipi_no_user"),
    Rule("ViewerHasMatchingMutedKeywordInSpaceTitleForNotificationsRule",
         non_author(lambda f: bool(
             set(f.get("viewer_muted_keywords", ()))
             & set(f.get("space_title_keywords", ())))),
         Action.DROP, "space_title_muted_keyword"),
    Rule("ToxicityReplyFilterDropNotificationRule",
         all_of(flag("is_reply"), score_above("toxicity_score", 0.91)),
         Action.DROP, "toxic_reply_notification"),
    Rule("SpaceNsfwHighPrecisionSafeSearchNonFollowerDropRule",
         opt_in_filtering(non_follower(author_label("nsfw_high_precision"))),
         Action.DROP, "space_nsfw_hp_safe_search"),
    Rule("SpaceNsfwHighRecallSafeSearchNonFollowerDropRule",
         opt_in_filtering(non_follower(author_label("nsfw_high_recall"))),
         Action.DROP, "space_nsfw_hr_safe_search"),
    Rule("UserBlinkWorstAllUsersDropRule", author_label("blink_worst"),
         Action.DROP, "blink_worst"),
    Rule("NsfwTextAllUsersDropRule", tweet_label("nsfw_text"), Action.DROP,
         "nsfw_text_all"),
    Rule("DeciderableAuthorBlocksViewerDropRule",
         flag("author_blocks_viewer"), Action.DROP,
         "author_blocks_viewer_drop"),
]


ALL_BREADTH_FAMILIES = (
    NSFW_BREADTH_RULES + GORE_VIOLENCE_RULES + BOUNCE_RULES
    + COMMUNITY_RULES + EXCLUSIVE_TRUSTED_RULES + SPAM_BREADTH_RULES
    + SAFETY_CRISIS_RULES + MUTED_KEYWORD_BREADTH_RULES
    + VIEWER_RELATION_RULES + UNAVAILABLE_STATE_RULES + UQF_RULES
    + SENSITIVE_MEDIA_SETTING_RULES + SEARCH_BREADTH_RULES
    + ADV_FILTER_REFNAME_RULES + DO_NOT_AMPLIFY_RULES + AVOID_RULES
    + DUP_LOWQ_RULES + DM_BREADTH_RULES + SPACE_BREADTH_RULES
    + TERMINAL_RULES + SENSITIVE_MEDIA_PER_LABEL_RULES
    + USER_UNAVAILABLE_TOMBSTONE_RULES + DM_STRUCTURAL_RULES
    + MISC_TAIL_RULES
)
