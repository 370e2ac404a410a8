"""Visibility rule catalog: the major reference rule families as concrete rules.

A host copy of ``the_algorithm_tpu/pipeline/visibility_rules.py``.

≡ ``visibilitylib/src/main/scala/com/twitter/visibility/rules/`` — the
reference composes rules from condition combinators (NonAuthor ×
TweetLabel, NonFollower × TweetLabel, score thresholds per conversation
section, viewer-settings gates) into per-SafetyLevel policies
(``TweetLabelRules.scala``, ``DownrankingRules.scala``,
``UserLabelRules.scala``, ``FreedomOfSpeechNotReach.scala``,
``PublicInterestRules.scala``, ``SafeSearchRules.scala``,
``FollowerRelations.scala``). This module ports the *shape*: combinators +
~35 concrete rules assembled into level policies for the engine in
:mod:`the_algorithm_tpu_torch.pipeline.visibility`.

Expected feature keys (a FeatureMap per candidate):
  tweet_labels: set[str]      — safety labels on the tweet
  author_labels: set[str]     — safety labels on the author
  *_score: float              — model scores (toxicity, pspammy, …)
  viewer_is_author / viewer_follows_author / …: bool relationship bits
  viewer settings: nsfw_opt_in, sensitive_media_setting
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping

from the_algorithm_tpu_torch.pipeline.visibility import Action, Rule, SafetyLevel
from the_algorithm_tpu_torch.pipeline.visibility_conditions import (  # noqa: F401
    Condition,
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


# -- relationship rules (FollowerRelations.scala) -----------------------------

RELATIONSHIP_RULES = [
    Rule("DropDeletedTweet", flag("is_deleted"), Action.DROP, "deleted"),
    Rule("DropAuthorBlockedViewer", flag("author_blocks_viewer"),
         Action.DROP, "blocked"),
    Rule("DropViewerBlockedAuthor", flag("viewer_blocks_author"),
         Action.DROP, "blocked_by_viewer"),
    Rule("DropViewerMutedAuthor",
         all_of(flag("viewer_mutes_author"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "muted"),
    Rule("DropProtectedAuthorNonFollower",
         non_follower(flag("author_is_protected")),
         Action.DROP, "protected_author", fail_closed=True),
]

# -- tweet-label rules (TweetLabelRules.scala) --------------------------------

TWEET_LABEL_RULES = [
    Rule("AbusiveTweetLabelRule", non_author(tweet_label("abusive")),
         Action.DROP, "tweet_label_abusive"),
    Rule("AbusiveHighRecallNonFollowerTweetLabelRule",
         non_follower(tweet_label("abusive_high_recall")),
         Action.DROP, "tweet_label_abusive_hr"),
    Rule("BystanderAbusiveTweetLabelRule",
         non_author(tweet_label("bystander_abusive")),
         Action.DROP, "tweet_label_bystander_abusive"),
    Rule("AutomationNonFollowerTweetLabelRule",
         non_follower(tweet_label("automation")),
         Action.DROP, "tweet_label_automation"),
    Rule("DuplicateContentTweetLabelDropRule",
         non_author(tweet_label("duplicate_content")),
         Action.DROP, "tweet_label_duplicate"),
    Rule("DuplicateMentionNonFollowerTweetLabelRule",
         non_follower(tweet_label("duplicate_mention")),
         Action.DROP, "tweet_label_duplicate_mention"),
    Rule("GoreAndViolenceTweetLabelRule",
         non_author(all_of(tweet_label("gore_and_violence"),
                           not_(flag("nsfw_opt_in")))),
         Action.INTERSTITIAL, "gore_and_violence"),
    Rule("NsfwHighPrecisionTweetLabelRule",
         non_author(all_of(tweet_label("nsfw_high_precision"),
                           not_(flag("nsfw_opt_in")))),
         Action.INTERSTITIAL, "nsfw_hp"),
    Rule("NsfwCardImageTweetLabelRule",
         non_author(all_of(tweet_label("nsfw_card_image"),
                           not_(flag("nsfw_opt_in")))),
         Action.INTERSTITIAL, "nsfw_card"),
    Rule("PdnaTweetLabelRule", tweet_label("pdna"), Action.DROP, "pdna",
         fail_closed=True),
    Rule("UntrustedUrlTweetLabelRule",
         non_follower(tweet_label("untrusted_url")),
         Action.DROP, "untrusted_url"),
    Rule("SpamHighRecallNonFollowerTweetLabelRule",
         non_follower(tweet_label("spam_high_recall")),
         Action.DROP, "spam_hr"),
    Rule("LiveLowQualityTweetLabelRule",
         non_author(tweet_label("live_low_quality")),
         Action.DOWNRANK, "live_low_quality"),
    Rule("LowQualityMentionTweetLabelRule",
         non_follower(tweet_label("low_quality_mention")),
         Action.DOWNRANK, "low_quality_mention"),
]

# -- model-score downranking rules (DownrankingRules.scala) -------------------

DOWNRANKING_RULES = [
    Rule("HighToxicityScoreDownrankHighQualitySectionRule",
         score_above("toxicity_score", 0.91), Action.DOWNRANK,
         "toxicity_high_q"),
    Rule("HighToxicityScoreDownrankLowQualitySectionRule",
         score_above("toxicity_score", 0.96), Action.DOWNRANK,
         "toxicity_low_q"),
    Rule("HighToxicityScoreDownrankAbusiveQualitySectionRule",
         score_above("toxicity_score", 0.98), Action.DOWNRANK,
         "toxicity_abusive_q"),
    Rule("HighProactiveTosScoreTweetLabelDownrankingRule",
         score_above("proactive_tos_score", 0.9), Action.DOWNRANK,
         "proactive_tos"),
    Rule("HighPSpammyTweetScoreDownrankLowQualitySectionRule",
         score_above("pspammy_score", 0.95), Action.DOWNRANK, "pspammy"),
    Rule("HighCryptospamScoreConvoDownrankAbusiveQualityRule",
         score_above("cryptospam_score", 0.9), Action.DOWNRANK, "cryptospam"),
    Rule("DownrankSpamReplyConversationsTweetLabelRule",
         non_author(tweet_label("spam_reply")), Action.DOWNRANK,
         "spam_reply"),
    Rule("NotGraduatedConversationsAuthorLabelRule",
         non_follower(author_label("not_graduated")), Action.DOWNRANK,
         "not_graduated"),
    Rule("RitoActionedTweetDownrankLowQualitySectionRule",
         flag("rito_actioned"), Action.DOWNRANK, "rito_actioned"),
]

# -- author/user-label rules (UserLabelRules.scala) ---------------------------

USER_LABEL_RULES = [
    Rule("SuspendedAuthorRule", flag("author_is_suspended"), Action.DROP,
         "suspended_author", fail_closed=True),
    Rule("DeactivatedAuthorRule", flag("author_is_deactivated"), Action.DROP,
         "deactivated_author", fail_closed=True),
    Rule("AbusiveAuthorLabelRule", non_follower(author_label("abusive")),
         Action.DROP, "author_abusive"),
    Rule("CompromisedAuthorLabelRule", author_label("compromised"),
         Action.DROP, "author_compromised"),
    Rule("SpamAuthorLabelRule", non_follower(author_label("spam")),
         Action.DROP, "author_spam"),
    Rule("NsfwAuthorLabelInterstitialRule",
         non_author(all_of(author_label("nsfw"), not_(flag("nsfw_opt_in")))),
         Action.INTERSTITIAL, "author_nsfw"),
]

# -- FOSNR (FreedomOfSpeechNotReachRules.scala) -------------------------------
#
# the full FOSNR policy ladder: restricted tweets stay visible to the
# author and followers but are de-amplified everywhere, interstitialed on
# conversation surfaces, dropped from recommendation/amplification
# surfaces, and engagement-limited (the reference's
# LimitedEngagementsRules + avoid-amplification set)

FOSNR_RULES = [
    Rule("FosnrInterstitialRule",
         non_author(tweet_label("fosnr_restricted")),
         Action.INTERSTITIAL, "fosnr"),
    Rule("FosnrDownrankRule", tweet_label("fosnr_restricted"),
         Action.DOWNRANK, "fosnr_downrank"),
]

FOSNR_AMPLIFICATION_RULES = [
    # recommendation/amplification surfaces drop restricted content outright
    Rule("FosnrDropFromAmplificationRule",
         non_follower(tweet_label("fosnr_restricted")),
         Action.DROP, "fosnr_no_amplification"),
    Rule("FosnrDropAuthorFromAmplificationRule",
         non_follower(author_label("fosnr_restricted_author")),
         Action.DROP, "fosnr_author_no_amplification"),
]

FOSNR_ENGAGEMENT_RULES = [
    # engagement-limited states render as interstitial-grade covers with
    # disabled actions (LimitedEngagementsRules)
    Rule("FosnrLimitedRepliesRule",
         non_author(all_of(tweet_label("fosnr_restricted"),
                           flag("is_reply"))),
         Action.INTERSTITIAL, "fosnr_limited_replies"),
    Rule("FosnrLimitedLikesRule",
         non_author(tweet_label("fosnr_limited_engagements")),
         Action.INTERSTITIAL, "fosnr_limited_engagements"),
    Rule("FosnrSoftInterventionNudgeRule",
         non_author(tweet_label("fosnr_soft_intervention")),
         Action.INTERSTITIAL, "fosnr_soft_intervention"),
    Rule("FosnrQuotedTweetDownrankRule",
         tweet_label("fosnr_quoted_restricted"), Action.DOWNRANK,
         "fosnr_quoted"),
]

# -- public interest (PublicInterestRules.scala) ------------------------------
#
# per-policy-category interstitials + the limited/newsworthy ladder

_PI_POLICIES = (
    "hateful_conduct", "abusive_behavior", "civic_integrity",
    "medical_misinfo", "synthetic_media", "violent_threat",
)

PUBLIC_INTEREST_RULES = [
    Rule("PublicInterestInterstitialRule",
         tweet_label("public_interest"), Action.INTERSTITIAL,
         "public_interest"),
] + [
    Rule(f"PublicInterest{p.title().replace('_', '')}InterstitialRule",
         non_author(tweet_label(f"public_interest_{p}")),
         Action.INTERSTITIAL, f"public_interest_{p}")
    for p in _PI_POLICIES
] + [
    Rule(f"PublicInterest{p.title().replace('_', '')}AmplificationDropRule",
         non_follower(tweet_label(f"public_interest_{p}")),
         Action.DROP, f"public_interest_{p}_no_amp")
    for p in _PI_POLICIES
]

# -- misinformation policy labels (MisinfoPolicyRules) ------------------------

MISINFO_RULES = [
    Rule("MisinfoCivicInterstitialRule",
         non_author(tweet_label("misinfo_civic")),
         Action.INTERSTITIAL, "misinfo_civic"),
    Rule("MisinfoMedicalInterstitialRule",
         non_author(tweet_label("misinfo_medical")),
         Action.INTERSTITIAL, "misinfo_medical"),
    Rule("MisinfoCrisisInterstitialRule",
         non_author(tweet_label("misinfo_crisis")),
         Action.INTERSTITIAL, "misinfo_crisis"),
    Rule("MisinfoGenericDownrankRule",
         tweet_label("misinfo_generic"), Action.DOWNRANK, "misinfo_generic"),
    Rule("MisleadingWithNoteDownrankRule",
         all_of(tweet_label("misleading"), flag("has_community_note")),
         Action.DOWNRANK, "misleading_with_note"),
    Rule("MisinfoCivicDropFromAmplificationRule",
         non_follower(tweet_label("misinfo_civic")),
         Action.DROP, "misinfo_civic_no_amp"),
]

# -- legal / withheld content (LegalPolicyRules) ------------------------------

LEGAL_RULES = [
    Rule("DmcaWithheldTombstoneRule", tweet_label("dmca_withheld"),
         Action.TOMBSTONE, "dmca", fail_closed=True),
    Rule("LegalDemandWithheldTombstoneRule", tweet_label("legal_withheld"),
         Action.TOMBSTONE, "legal_withheld", fail_closed=True),
    Rule("PrivateInformationDropRule", tweet_label("private_info"),
         Action.DROP, "private_info", fail_closed=True),
    Rule("NonConsensualMediaDropRule", tweet_label("non_consensual_media"),
         Action.DROP, "ncm", fail_closed=True),
    Rule("HackedMaterialsInterstitialRule",
         non_author(tweet_label("hacked_materials")),
         Action.INTERSTITIAL, "hacked_materials"),
    Rule("CounterfeitDropRule", tweet_label("counterfeit"), Action.DROP,
         "counterfeit"),
    Rule("ScamFraudDropRule",
         any_of(tweet_label("scam"), tweet_label("fraud")),
         Action.DROP, "scam_fraud"),
]

# -- safe search (SafeSearchRules.scala) --------------------------------------

SAFE_SEARCH_RULES = [
    Rule("SafeSearchNsfwDropRule",
         all_of(any_of(tweet_label("nsfw_high_precision"),
                       tweet_label("nsfw_high_recall"),
                       flag("is_nsfw_media")),
                not_(flag("nsfw_opt_in"))),
         Action.DROP, "safe_search_nsfw"),
    Rule("SafeSearchAbusiveDropRule",
         any_of(tweet_label("abusive"), tweet_label("abusive_high_recall")),
         Action.DROP, "safe_search_abusive"),
    Rule("SafeSearchSpamDropRule",
         any_of(tweet_label("spam_high_recall"), tweet_label("untrusted_url")),
         Action.DROP, "safe_search_spam"),
]

# -- recommendations-only hard drops ------------------------------------------

RECS_ONLY_RULES = [
    Rule("DropNsfwFromRecs",
         any_of(flag("is_nsfw_media"), tweet_label("nsfw_high_recall"),
                author_label("nsfw")),
         Action.DROP, "nsfw_recs"),
    Rule("DropHighToxicityFromRecs", score_above("toxicity_score", 0.8),
         Action.DROP, "toxicity_recs"),
    Rule("DropNotInterestedAuthorFromRecs", flag("viewer_not_interested"),
         Action.DROP, "not_interested"),
]


# -- toxicity reply filter (ToxicityReplyFilterRules.scala) --------------------

TOXICITY_REPLY_RULES = [
    Rule("ToxicityReplySectionRule",
         non_author(all_of(flag("is_reply"),
                           score_above("toxicity_score", 0.91))),
         Action.DOWNRANK, "toxic_reply_abusive_quality"),
    Rule("ToxicityReplyHiddenRule",
         non_author(all_of(flag("is_reply"), flag("hidden_by_author"))),
         Action.TOMBSTONE, "reply_hidden_by_author"),
    Rule("ToxicityReplyHighToxicityTombstone",
         non_author(all_of(flag("is_reply"),
                           score_above("toxicity_score", 0.97))),
         Action.TOMBSTONE, "toxic_reply_hidden"),
]

# -- card / URL rules (CardRules.scala) -----------------------------------------

CARD_RULES = [
    Rule("UnsafeUrlCardRule",
         non_author(all_of(flag("has_card"), tweet_label("unsafe_url"))),
         Action.DROP, "unsafe_url_card"),
    Rule("MalwareUrlCardRule",
         any_of(tweet_label("malware_url"), tweet_label("phishing_url")),
         Action.DROP, "malware_url", fail_closed=True),
    Rule("SpammyUrlCardDownrankRule",
         non_follower(tweet_label("spammy_url")),
         Action.DOWNRANK, "spammy_url"),
]

# -- DM rules (DmConversationRules / DmEventRules.scala) ------------------------

DM_RULES = [
    Rule("DmDropBlockedSender", flag("viewer_blocks_author"),
         Action.DROP, "dm_blocked_sender"),
    Rule("DmDropNonFollowedSpamRequest",
         non_follower(any_of(tweet_label("spam_high_recall"),
                             author_label("spammy"))),
         Action.DROP, "dm_spam_request"),
    Rule("DmTombstoneDeletedMessage", flag("is_deleted"),
         Action.TOMBSTONE, "dm_deleted"),
    Rule("DmInterstitialNsfwMedia",
         all_of(flag("is_nsfw_media"), not_(flag("nsfw_opt_in"))),
         Action.INTERSTITIAL, "dm_nsfw_media"),
]

# -- spaces (SpaceRules.scala) ---------------------------------------------------

SPACE_RULES = [
    Rule("SpaceDropCoordinatedHarm",
         author_label("coordinated_harmful_activity"),
         Action.DROP, "space_coordinated_harm", fail_closed=True),
    Rule("SpaceDropSuspendedHost", author_label("suspended"),
         Action.DROP, "space_suspended_host", fail_closed=True),
    Rule("SpaceInterstitialHatefulTitle",
         non_author(tweet_label("hateful_terms")),
         Action.INTERSTITIAL, "space_hateful_title"),
]

# -- sensitive-media viewer settings (SensitiveMediaSettingsRules.scala) --------
#
# viewer setting per media category: "drop" | "interstitial" | "allow"


def _media_setting(category: str, wanted: str) -> Condition:
    return lambda f: (
        category in f.get("media_categories", ())
        and f.get(f"media_setting_{category}", "interstitial") == wanted
    )


SENSITIVE_MEDIA_RULES = [
    Rule(f"SensitiveMedia{cat.title().replace('_', '')}{act.title()}Rule",
         non_author(_media_setting(cat, act)),
         Action.DROP if act == "drop" else Action.INTERSTITIAL,
         f"sensitive_media_{cat}")
    for cat in ("adult_content", "graphic_violence", "other_sensitive")
    for act in ("drop", "interstitial")
]

# -- advanced viewer-side filtering (AdvancedFilteringRules.scala) ---------------

ADVANCED_FILTERING_RULES = [
    Rule("AdvancedFilterNoConfirmedEmailRule",
         all_of(flag("viewer_filters_no_confirmed_email"),
                flag("author_has_no_confirmed_email"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "filter_no_confirmed_email"),
    Rule("AdvancedFilterDefaultProfileImageRule",
         all_of(flag("viewer_filters_default_profile_image"),
                flag("author_has_default_profile_image"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "filter_default_profile_image"),
    Rule("AdvancedFilterNewAccountsRule",
         all_of(flag("viewer_filters_new_accounts"),
                flag("author_is_new_account"),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "filter_new_accounts"),
    Rule("AdvancedFilterNotFollowedByRule",
         all_of(flag("viewer_filters_not_followed_by"),
                not_(flag("author_follows_viewer")),
                not_(flag("viewer_follows_author"))),
         Action.DROP, "filter_not_followed_by"),
]

# -- user-unavailable tombstones (UserUnavailableStateTombstoneRules.scala) -----

USER_UNAVAILABLE_RULES = [
    Rule("SuspendedUserTombstoneRule", author_label("suspended"),
         Action.TOMBSTONE, "author_suspended_tombstone", fail_closed=True),
    Rule("DeactivatedUserTombstoneRule", author_label("deactivated"),
         Action.TOMBSTONE, "author_deactivated_tombstone", fail_closed=True),
    Rule("OffboardedUserTombstoneRule", author_label("offboarded"),
         Action.TOMBSTONE, "author_offboarded_tombstone"),
]

# -- spam/integrity author labels (UserLabelRules breadth) ----------------------

SPAM_AUTHOR_RULES = [
    Rule("EngagementSpammerAuthorLabelRule",
         non_follower(author_label("engagement_spammer")),
         Action.DROP, "engagement_spammer"),
    Rule("HighFollowChurnAuthorDownrankRule",
         non_follower(author_label("high_follow_churn")),
         Action.DOWNRANK, "high_follow_churn"),
    Rule("DuplicateAccountAuthorDropRule",
         author_label("duplicate_account"), Action.DROP, "duplicate_account"),
    Rule("BanEvasionAuthorDropRule", author_label("ban_evasion"),
         Action.DROP, "ban_evasion", fail_closed=True),
    Rule("FinancialScamAuthorDropRule", author_label("financial_scam"),
         Action.DROP, "financial_scam_author"),
    Rule("LikelyAutomatedAuthorDownrankRule",
         non_follower(author_label("likely_automated")),
         Action.DOWNRANK, "likely_automated"),
    Rule("RecentlySuspendedAuthorDownrankRule",
         non_follower(author_label("recently_suspended")),
         Action.DOWNRANK, "recently_suspended"),
    Rule("NewUserSpamHighRecallDownrankRule",
         non_follower(all_of(author_label("spam_high_recall"),
                             flag("author_is_new_account"))),
         Action.DOWNRANK, "new_user_spam_hr"),
    Rule("CopypastaSpamDownrankRule",
         non_author(tweet_label("copypasta_spam")),
         Action.DOWNRANK, "copypasta_spam"),
    Rule("SearchBlacklistTweetLabelRule",
         non_author(tweet_label("search_blacklist")),
         Action.DROP, "search_blacklist"),
]

# -- violence / hateful conduct (AbusePolicyRules) ------------------------------

VIOLENCE_HATE_RULES = [
    Rule("ViolentThreatDropRule", tweet_label("violent_threat"),
         Action.DROP, "violent_threat", fail_closed=True),
    Rule("GlorificationOfViolenceDropRule",
         non_author(tweet_label("glorification_of_violence")),
         Action.DROP, "glorification_of_violence"),
    Rule("HatefulConductDownrankRule",
         non_author(tweet_label("hateful_terms")),
         Action.DOWNRANK, "hateful_conduct"),
    Rule("TargetedHarassmentDropRule",
         non_author(tweet_label("targeted_harassment")),
         Action.DROP, "targeted_harassment"),
    Rule("SelfHarmInterstitialRule",
         non_author(tweet_label("self_harm")),
         Action.INTERSTITIAL, "self_harm"),
    Rule("ViolentEventDenialDownrankRule",
         tweet_label("violent_event_denial"), Action.DOWNRANK,
         "violent_event_denial"),
    Rule("PerpetratorContentDropRule",
         tweet_label("perpetrator_content"), Action.DROP,
         "perpetrator_content", fail_closed=True),
]

# -- quoted-tweet rules (QuotedTweetRules.scala) --------------------------------
#
# the INNER tweet of a quote: unavailable states tombstone the embed,
# safety labels cover it

QUOTED_TWEET_RULES = [
    Rule("QuotedTweetDeletedTombstoneRule", flag("is_deleted"),
         Action.TOMBSTONE, "quoted_deleted"),
    Rule("QuotedTweetBlockedAuthorTombstoneRule",
         flag("author_blocks_viewer"), Action.TOMBSTONE, "quoted_blocked"),
    Rule("QuotedTweetViewerBlockedTombstoneRule",
         flag("viewer_blocks_author"), Action.TOMBSTONE,
         "quoted_blocked_by_viewer"),
    Rule("QuotedTweetProtectedAuthorTombstoneRule",
         non_follower(flag("author_is_protected")),
         Action.TOMBSTONE, "quoted_protected", fail_closed=True),
    Rule("QuotedTweetNsfwInterstitialRule",
         non_author(all_of(any_of(tweet_label("nsfw_high_precision"),
                                  flag("is_nsfw_media")),
                           not_(flag("nsfw_opt_in")))),
         Action.INTERSTITIAL, "quoted_nsfw"),
    Rule("QuotedTweetMutedAuthorTombstoneRule",
         all_of(flag("viewer_mutes_author"),
                not_(flag("viewer_follows_author"))),
         Action.TOMBSTONE, "quoted_muted"),
]

# -- ads brand safety (AdsRules) ------------------------------------------------

ADS_RULES = [
    Rule("AdsDropNsfwRule",
         any_of(flag("is_nsfw_media"), tweet_label("nsfw_high_recall"),
                author_label("nsfw")),
         Action.DROP, "ads_nsfw", fail_closed=True),
    Rule("AdsDropViolenceRule",
         any_of(tweet_label("gore_and_violence"),
                tweet_label("violent_threat")),
         Action.DROP, "ads_violence", fail_closed=True),
    Rule("AdsDropScamAdvertiserRule", author_label("financial_scam"),
         Action.DROP, "ads_scam_advertiser", fail_closed=True),
    Rule("AdsDropLowQualityRule", score_above("pspammy_score", 0.8),
         Action.DROP, "ads_low_quality"),
    Rule("AdsDropHighToxicityRule", score_above("toxicity_score", 0.7),
         Action.DROP, "ads_toxicity"),
    Rule("AdsDropMisinfoAdjacentRule",
         any_of(tweet_label("misinfo_civic"), tweet_label("misinfo_medical"),
                tweet_label("misinfo_crisis")),
         Action.DROP, "ads_misinfo"),
]

# -- trends representative tweet (TrendsRules) ----------------------------------

TRENDS_RULES = [
    Rule("TrendTweetNsfwDropRule",
         any_of(flag("is_nsfw_media"), tweet_label("nsfw_high_precision"),
                tweet_label("nsfw_high_recall")),
         Action.DROP, "trend_nsfw"),
    Rule("TrendTweetAbusiveDropRule",
         any_of(tweet_label("abusive"), tweet_label("abusive_high_recall")),
         Action.DROP, "trend_abusive"),
    Rule("TrendTweetSpamDropRule",
         any_of(tweet_label("spam_high_recall"), author_label("spam")),
         Action.DROP, "trend_spam"),
    Rule("TrendTweetLowQualityDropRule", score_above("pspammy_score", 0.6),
         Action.DROP, "trend_low_quality"),
    Rule("TrendTweetUnverifiedCrisisDownrankRule",
         all_of(tweet_label("crisis_unverified"),
                not_(flag("from_verified_account"))),
         Action.DOWNRANK, "trend_crisis_unverified"),
]

# -- push-notification strictness (NotificationsRules) --------------------------

PUSH_STRICT_RULES = [
    Rule("PushDropAnyInterstitialGradeRule",
         any_of(tweet_label("nsfw_high_precision"),
                tweet_label("gore_and_violence"),
                tweet_label("public_interest"),
                tweet_label("hacked_materials")),
         Action.DROP, "push_interstitial_grade"),
    Rule("PushDropModerateToxicityRule",
         score_above("toxicity_score", 0.6), Action.DROP, "push_toxicity"),
    Rule("PushDropModerateSpamRule", score_above("pspammy_score", 0.6),
         Action.DROP, "push_spam"),
    Rule("PushDropUnknownSenderDmRule",
         non_follower(flag("is_dm_request")), Action.DROP,
         "push_unknown_sender"),
]

# -- viewer muted keywords (MutedKeywordRules) ----------------------------------


MUTED_KEYWORD_RULES = [
    Rule("MutedKeywordTimelineDropRule", non_author(muted_keyword),
         Action.DROP, "muted_keyword"),
    Rule("MutedKeywordNotificationDropRule", non_author(muted_keyword),
         Action.DROP, "muted_keyword_notification"),
]

# -- embedded / logged-out surfaces (EmbeddedTweetRules) ------------------------

EMBEDDED_RULES = [
    Rule("EmbeddedTweetNsfwDropRule",
         any_of(flag("is_nsfw_media"), tweet_label("nsfw_high_recall"),
                tweet_label("nsfw_high_precision")),
         Action.DROP, "embedded_nsfw", fail_closed=True),
    Rule("EmbeddedTweetProtectedDropRule", flag("author_is_protected"),
         Action.DROP, "embedded_protected", fail_closed=True),
    Rule("EmbeddedTweetWithheldDropRule",
         any_of(tweet_label("dmca_withheld"), tweet_label("legal_withheld")),
         Action.DROP, "embedded_withheld", fail_closed=True),
]

# -- media-vertical rules (MediaSurfaceRules) -----------------------------------

MEDIA_SURFACE_RULES = [
    Rule("MediaTabNsfwInterstitialRule",
         non_author(all_of(flag("is_nsfw_media"), not_(flag("nsfw_opt_in")))),
         Action.INTERSTITIAL, "media_tab_nsfw"),
    Rule("MediaTabGraphicViolenceInterstitialRule",
         non_author(all_of(tweet_label("gore_and_violence"),
                           not_(flag("nsfw_opt_in")))),
         Action.INTERSTITIAL, "media_tab_violence"),
    Rule("VideoRecsNsfwDropRule",
         any_of(flag("is_nsfw_media"), tweet_label("nsfw_high_recall")),
         Action.DROP, "video_recs_nsfw"),
    Rule("VideoRecsViolenceDropRule", tweet_label("gore_and_violence"),
         Action.DROP, "video_recs_violence"),
]

# -- people-search author gates (SearchPeopleRules) -----------------------------

SEARCH_PEOPLE_RULES = [
    Rule("PeopleSearchSuspendedDropRule", author_label("suspended"),
         Action.DROP, "people_suspended", fail_closed=True),
    Rule("PeopleSearchDeactivatedDropRule", author_label("deactivated"),
         Action.DROP, "people_deactivated", fail_closed=True),
    Rule("PeopleSearchNsfwAuthorDropRule",
         all_of(author_label("nsfw"), not_(flag("nsfw_opt_in"))),
         Action.DROP, "people_nsfw_author"),
    Rule("PeopleSearchSpamAuthorDownrankRule", author_label("spam"),
         Action.DOWNRANK, "people_spam_author"),
]


# -- per-level policies (≡ the level→policy map in RuleBase.scala) -------------
#
# The FULL reference SafetyLevel space: every one of the 198 levels gets a
# policy, composed from the family lists above plus the breadth families
# (``visibility_rules_breadth.py``). Surfaces group into archetypes the way
# the reference's VisibilityPolicy subclasses share base rule sets
# (``rules/RuleBase.scala``, ``DmVisibilityPolicies.scala``,
# ``SearchBlenderRules.scala`` …); levels then add surface-specific rules.

from the_algorithm_tpu_torch.pipeline import visibility_rules_breadth as vb  # noqa: E402


def _pick(family, *names):
    """Select rules from a family by NAME (index slices drift)."""
    by = {r.name: r for r in family}
    return [by[n] for n in names]


_BASE = RELATIONSHIP_RULES + USER_LABEL_RULES + LEGAL_RULES
_LABELS_FULL = (TWEET_LABEL_RULES + MISINFO_RULES + SPAM_AUTHOR_RULES
                + VIOLENCE_HATE_RULES)
_COMMON_CONTENT = (
    vb.BOUNCE_RULES[:3] + vb.SAFETY_CRISIS_RULES[:1]
    + vb.EXCLUSIVE_TRUSTED_RULES[1:5] + vb.COMMUNITY_RULES[3:7]
)
_RANKED_HOME = (
    _BASE + _LABELS_FULL + FOSNR_RULES + FOSNR_ENGAGEMENT_RULES
    + PUBLIC_INTEREST_RULES + DOWNRANKING_RULES + CARD_RULES
    + SENSITIVE_MEDIA_RULES + vb.SENSITIVE_MEDIA_PER_LABEL_RULES
    + ADVANCED_FILTERING_RULES + vb.MISC_TAIL_RULES[:4]
    + _pick(vb.NSFW_BREADTH_RULES, "NsfwHighRecallTweetLabelRule",
            "NsfwAvatarImageRule", "NsfwBannerImageRule")
    + _pick(vb.GORE_VIOLENCE_RULES,
            "GoreAndViolenceHighPrecisionTweetLabelRule")
    + vb.UQF_RULES
    + _pick(vb.DO_NOT_AMPLIFY_RULES, "DoNotAmplifyNonFollowerRule",
            "DoNotAmplifySectionRule", "DoNotAmplifySectionUserRule")
    + vb.MUTED_KEYWORD_BREADTH_RULES[:1]
    + _pick(vb.VIEWER_RELATION_RULES, "MutedRetweetsRule",
            "OnlyPeopleIFollowRule", "ViewerMutesAndDoesNotFollowAuthorRule")
    + vb.ADV_FILTER_REFNAME_RULES
    + _COMMON_CONTENT
    + _pick(vb.DUP_LOWQ_RULES, "DropCardUriRootDomainDenylistRule",
            "DropTweetsWithGeoRestrictedMediaRule", "TsViolationRule",
            "EmergencyDropRule")
)
_RECS = (
    _BASE + _LABELS_FULL + RECS_ONLY_RULES + FOSNR_RULES
    + FOSNR_AMPLIFICATION_RULES + PUBLIC_INTEREST_RULES + DOWNRANKING_RULES
    + CARD_RULES + vb.DO_NOT_AMPLIFY_RULES + vb.NSFW_BREADTH_RULES[:2]
    + vb.GORE_VIOLENCE_RULES[:1] + vb.SPAM_BREADTH_RULES[:2]
    + vb.SAFETY_CRISIS_RULES[:1]
    + _pick(vb.UQF_RULES, "LikelyIvsLabelNonFollowerDropRule",
            "LikelyIvsLabelNonFollowerDropUserRule")
    + _COMMON_CONTENT
)
_SEARCH_TOP = (
    _BASE + SAFE_SEARCH_RULES + _LABELS_FULL + DOWNRANKING_RULES
    + CARD_RULES + SENSITIVE_MEDIA_RULES + vb.SEARCH_BREADTH_RULES
    + _pick(vb.MISC_TAIL_RULES, 'SearchIpiSafeSearchWithoutUserInQueryDropRule',
            'NsfwTextAllUsersDropRule', 'UserBlinkWorstAllUsersDropRule')
    + _pick(vb.SPAM_BREADTH_RULES, "FirstPageSearchResultAgathaSpamDropRule",
            "CopypastaSpamAllViewersSearchTweetLabelRule",
            "CopypastaSpamNonFollowerSearchTweetLabelRule",
            "SmyteSpamTweetLabelDropSearchRule")
    + _pick(vb.NSFW_BREADTH_RULES,
            "DropNsfwAdminAuthorViewerOptInFilteringOnSearchRule",
            "DropNsfwUserAuthorViewerOptInFilteringOnSearchRule")
    + vb.UQF_RULES[:6] + _COMMON_CONTENT
)
_SEARCH_LATEST = (
    _BASE + SAFE_SEARCH_RULES + _LABELS_FULL + CARD_RULES
    + SENSITIVE_MEDIA_RULES + vb.SEARCH_BREADTH_RULES + _COMMON_CONTENT
)
_SEARCH_STRICT = (
    _SEARCH_TOP + vb.NSFW_BREADTH_RULES[:2] + vb.GORE_VIOLENCE_RULES[:2]
)
_SAFE_SEARCH = (
    _BASE + SAFE_SEARCH_RULES + _LABELS_FULL
    + vb.NSFW_BREADTH_RULES[:2] + vb.GORE_VIOLENCE_RULES[:1]
    + vb.SEARCH_BREADTH_RULES[2:4] + _COMMON_CONTENT
)
_SEARCH_USER = RELATIONSHIP_RULES + SEARCH_PEOPLE_RULES + SPAM_AUTHOR_RULES + [
    r for r in vb.NSFW_BREADTH_RULES
    if r.name in ("NsfwAvatarImageRule", "NsfwBannerImageRule",
                  "DropNsfwAdminAuthorViewerOptInFilteringOnSearchRule",
                  "DropNsfwUserAuthorViewerOptInFilteringOnSearchRule")
] + vb.UQF_RULES[2:3]
_NOTIFICATIONS = (
    _BASE + _LABELS_FULL + DOWNRANKING_RULES
    + _pick(vb.MISC_TAIL_RULES,
            'ViewerHasMatchingMutedKeywordInSpaceTitleForNotificationsRule',
            'ToxicityReplyFilterDropNotificationRule',
            'DeciderableAuthorBlocksViewerDropRule')
    + vb.MUTED_KEYWORD_BREADTH_RULES[1:2] + vb.UQF_RULES[:4]
    + _COMMON_CONTENT
)
_PUSH = (
    _BASE + PUSH_STRICT_RULES + _LABELS_FULL
    + vb.MUTED_KEYWORD_BREADTH_RULES[1:2] + vb.SAFETY_CRISIS_RULES[:2]
    + _COMMON_CONTENT
)
_CONVERSATION = (
    RELATIONSHIP_RULES + USER_UNAVAILABLE_RULES + LEGAL_RULES
    + TOXICITY_REPLY_RULES + TWEET_LABEL_RULES + CARD_RULES
    + SENSITIVE_MEDIA_RULES + vb.SENSITIVE_MEDIA_PER_LABEL_RULES
    + vb.USER_UNAVAILABLE_TOMBSTONE_RULES + ADVANCED_FILTERING_RULES
    + vb.MUTED_KEYWORD_BREADTH_RULES[2:3]
    + _pick(vb.BOUNCE_RULES, "TombstoneBounceDeletedTweetRule",
            "TombstoneDeletedTweetRule", "BounceTweetLabelTombstoneRule")
    + vb.VIEWER_RELATION_RULES[:4]
    + _pick(vb.UNAVAILABLE_STATE_RULES, "ErasedAuthorRule",
            "OffboardedAuthorRule")
    + _pick(vb.DUP_LOWQ_RULES, "UntrustedUrlConversationsTweetLabelRule",
            "DownrankSpamReplyAllViewersTweetLabelRule",
            "DownrankSpamReplyConversationsAuthorLabelRule")
    + vb.COMMUNITY_RULES[22:30]
    + _pick(vb.EXCLUSIVE_TRUSTED_RULES,
            "TrustedFriendsTweetLimitedEngagementsRule")
)
_TWEET_DETAIL = _CONVERSATION + _pick(
    vb.SEARCH_BREADTH_RULES, "ReportedTweetInterstitialRule") + [
    r for r in vb.AVOID_RULES
    if r.name == "SkipTweetDetailLimitedEngagementTweetLabelRule"]
_QUOTED = (
    QUOTED_TWEET_RULES + LEGAL_RULES
    + [r for r in TWEET_LABEL_RULES if r.name == "PdnaTweetLabelRule"]
    + vb.BOUNCE_RULES[5:6] + vb.BOUNCE_RULES[8:9]
    + [r for r in vb.DUP_LOWQ_RULES
       if r.name == "PdnaQuotedTweetLabelTombstoneRule"]
    + [r for r in vb.NSFW_BREADTH_RULES
       if r.name in ("NsfwHighPrecisionInnerQuotedTweetLabelRule",
                     "NsfwHighPrecisionTombstoneInnerQuotedTweetLabelRule")]
    + [r for r in vb.VIEWER_RELATION_RULES
       if "InnerQuoted" in r.name or r.name == "AuthorBlocksOuterAuthorRule"]
    + [r for r in vb.UNAVAILABLE_STATE_RULES
       if r.name == "ProtectedQuoteTweetAuthorRule"]
    + [r for r in vb.SPAM_BREADTH_RULES
       if r.name == "SpamQuotedTweetLabelTombstoneRule"]
    + [r for r in vb.EXCLUSIVE_TRUSTED_RULES
       if r.name == "TombstoneExclusiveQuotedTweetContentRule"]
    + vb.MUTED_KEYWORD_BREADTH_RULES[5:6]
)
_DM = (RELATIONSHIP_RULES + DM_RULES + LEGAL_RULES + vb.DM_BREADTH_RULES
       + vb.DM_STRUCTURAL_RULES + vb.UNAVAILABLE_STATE_RULES[2:4])
_DM_INBOX = _DM + [
    r for r in SPAM_AUTHOR_RULES
    if r.name in ("EngagementSpammerAuthorLabelRule",
                  "BanEvasionAuthorDropRule")]
_SPACES = (RELATIONSHIP_RULES + SPACE_RULES + vb.SPACE_BREADTH_RULES
           + _pick(vb.MISC_TAIL_RULES,
                   'SpaceNsfwHighPrecisionSafeSearchNonFollowerDropRule',
                   'SpaceNsfwHighRecallSafeSearchNonFollowerDropRule')
           + vb.UNAVAILABLE_STATE_RULES[:2])
_ADS = (ADS_RULES + LEGAL_RULES + vb.AVOID_RULES + vb.NSFW_BREADTH_RULES[32:33]
        + [r for r in vb.NSFW_BREADTH_RULES + vb.GORE_VIOLENCE_RULES
           if "AvoidAdPlacement" in r.name]
        + vb.MUTED_KEYWORD_BREADTH_RULES[3:4]
        + vb.VIEWER_RELATION_RULES[7:8] + vb.VIEWER_RELATION_RULES[12:13])
_PROFILE = (
    RELATIONSHIP_RULES + LEGAL_RULES
    + [r for r in USER_LABEL_RULES
       if r.name in ("SuspendedAuthorRule", "DeactivatedAuthorRule")]
    + [r for r in TWEET_LABEL_RULES if r.name == "PdnaTweetLabelRule"]
    + vb.BOUNCE_RULES[:1] + vb.SENSITIVE_MEDIA_SETTING_RULES
)
_VIEWER_OWNED = (
    RELATIONSHIP_RULES + LEGAL_RULES
    + [r for r in USER_LABEL_RULES
       if r.name in ("SuspendedAuthorRule", "DeactivatedAuthorRule")]
    + [r for r in TWEET_LABEL_RULES if r.name in (
        "PdnaTweetLabelRule", "NsfwHighPrecisionTweetLabelRule",
        "GoreAndViolenceTweetLabelRule")]
)
_LISTS = (
    _BASE + TWEET_LABEL_RULES + CARD_RULES + SENSITIVE_MEDIA_RULES
    + vb.MUTED_KEYWORD_BREADTH_RULES[:1] + _COMMON_CONTENT
)
_MEDIA = (
    _BASE + TWEET_LABEL_RULES + MEDIA_SURFACE_RULES + SENSITIVE_MEDIA_RULES
    + vb.NSFW_BREADTH_RULES[13:17] + vb.GORE_VIOLENCE_RULES[1:2]
)
_ENGAGERS = (
    RELATIONSHIP_RULES
    + [r for r in USER_LABEL_RULES
       if r.name in ("SuspendedAuthorRule", "DeactivatedAuthorRule")]
    + SPAM_AUTHOR_RULES[:2] + vb.UNAVAILABLE_STATE_RULES[2:4]
)
_COMMUNITIES = (
    _BASE + TWEET_LABEL_RULES + vb.COMMUNITY_RULES[6:20]
    + vb.COMMUNITY_RULES[22:31] + _COMMON_CONTENT
)
_MINIMAL = (
    LEGAL_RULES
    + [r for r in USER_LABEL_RULES
       if r.name in ("SuspendedAuthorRule", "DeactivatedAuthorRule")]
    + [r for r in TWEET_LABEL_RULES if r.name == "PdnaTweetLabelRule"]
    + vb.BOUNCE_RULES[:1]
    + [r for r in vb.DUP_LOWQ_RULES if r.name == "TsViolationRule"]
)
_DATA_API = _MINIMAL
_WRITE_PATH = _MINIMAL + [
    r for r in vb.DUP_LOWQ_RULES
    if r.name in ("EmergencyDropRule",)] + vb.TERMINAL_RULES[3:4]
_CHRON_HOME = (
    _BASE + TWEET_LABEL_RULES + LEGAL_RULES + CARD_RULES
    + SENSITIVE_MEDIA_RULES + vb.MUTED_KEYWORD_BREADTH_RULES[:1]
    + _COMMON_CONTENT + vb.VIEWER_RELATION_RULES[16:17]
)
_TRENDS = (_BASE + TRENDS_RULES + _LABELS_FULL + FOSNR_AMPLIFICATION_RULES
           + vb.SEARCH_BREADTH_RULES[10:12] + vb.SAFETY_CRISIS_RULES[:1])
_EMBEDS = (EMBEDDED_RULES + LEGAL_RULES + vb.NSFW_BREADTH_RULES[:1]
           + vb.BOUNCE_RULES[:1])


def _classify(name: str):
    """level-name → policy (the explicit level→archetype assignment)."""
    N = name
    exact = {
        "FILTER_NONE": [],
        "FILTER_ALL": vb.TERMINAL_RULES[1:2],
        "FILTER_ALL_PLACEHOLDER": vb.TERMINAL_RULES[2:3],
        "FILTER_DEFAULT": _BASE + _COMMON_CONTENT,
        "TEST": vb.TERMINAL_RULES[3:4] + _MINIMAL,
        "FOR_DEVELOPMENT_ONLY": _MINIMAL,
        "KITCHEN_SINK_DEVELOPMENT": _MINIMAL,
        "MINIMAL": _MINIMAL,
        "TOMBSTONING": vb.BOUNCE_RULES + vb.UNAVAILABLE_STATE_RULES,
        "TIMELINE_HOME": _RANKED_HOME,
        "TIMELINE_HOME_LATEST": _CHRON_HOME,
        "TIMELINE_HOME_RECOMMENDATIONS": _RECS,
        "TIMELINE_HOME_COMMUNITIES": _COMMUNITIES,
        "TIMELINE_HOME_TOPIC_FOLLOW_RECOMMENDATIONS": _RECS,
        "TIMELINE_REACTIVE_BLENDING": _RANKED_HOME,
        "TIMELINE_SCORER": _RANKED_HOME,
        "TIMELINE_INJECTION": _RECS,
        "TIMELINE_MENTIONS": _NOTIFICATIONS,
        "TIMELINE_FOLLOWING_ACTIVITY": _NOTIFICATIONS,
        "TIMELINE_CONVERSATIONS": _CONVERSATION,
        "TIMELINE_CONVERSATIONS_DOWNRANKING": _CONVERSATION,
        "TIMELINE_CONVERSATIONS_DOWNRANKING_MINIMAL":
            RELATIONSHIP_RULES + DOWNRANKING_RULES + TOXICITY_REPLY_RULES,
        "TIMELINE_FOCAL_TWEET": _TWEET_DETAIL,
        "TIMELINE_MEDIA": _MEDIA,
        "TIMELINE_LIKED_BY": _ENGAGERS,
        "TIMELINE_RETWEETED_BY": _ENGAGERS,
        "TIMELINE_SUPER_LIKED_BY": _ENGAGERS,
        "TIMELINE_CONTENT_CONTROLS": _RANKED_HOME,
        "TIMELINE_BOOKMARK": _VIEWER_OWNED,
        "TIMELINE_FAVORITES": _VIEWER_OWNED,
        "TIMELINE_FAVORITES_SELF_VIEW": vb.TERMINAL_RULES[:1] + _MINIMAL,
        "TIMELINE_LISTS": _LISTS,
        "TIMELINE_PROFILE": _PROFILE,
        "TIMELINE_PROFILE_ALL": _PROFILE,
        "TIMELINE_PROFILE_SPACES": _PROFILE + vb.SPACE_BREADTH_RULES,
        "TIMELINE_PROFILE_SUPER_FOLLOWS":
            _PROFILE + vb.EXCLUSIVE_TRUSTED_RULES[1:5],
        "PROFILE_MIXER_MEDIA": _MEDIA,
        "PROFILE_MIXER_FAVORITES": _VIEWER_OWNED,
        "USER_PROFILE_HEADER": _SEARCH_USER,
        "USER_SELF_VIEW_ONLY": vb.TERMINAL_RULES[:1] + _MINIMAL,
        "USER_SETTINGS": _MINIMAL,
        "USER_SCOPED_TIMELINE": _SEARCH_TOP,
        "TWEET_SCOPED_TIMELINE": _SEARCH_TOP,
        "SEARCH_TOP": _SEARCH_TOP,
        "SEARCH_TOP_QIG": _SEARCH_TOP,
        "SEARCH_LATEST": _SEARCH_LATEST,
        "SEARCH_PHOTO": _SEARCH_TOP + MEDIA_SURFACE_RULES,
        "SEARCH_VIDEO": _SEARCH_TOP + MEDIA_SURFACE_RULES,
        "SEARCH_MIXER_SRP_MINIMAL": _MINIMAL + SAFE_SEARCH_RULES,
        "SEARCH_MIXER_SRP_STRICT": _SEARCH_STRICT,
        "SEARCH_PEOPLE_SRP": _SEARCH_USER,
        "SEARCH_PEOPLE_TYPEAHEAD": _SEARCH_USER,
        "USER_SEARCH_SRP": _SEARCH_USER,
        "USER_SEARCH_TYPEAHEAD": _SEARCH_USER,
        "SEARCH_BLENDER_USER_RULES": _SEARCH_USER,
        "SEARCH_LATEST_USER_RULES": _SEARCH_USER,
        "SEARCH_HYDRATION": _DATA_API,
        "SAFE_SEARCH_MINIMAL": _SAFE_SEARCH,
        "SAFE_SEARCH_STRICT": _SAFE_SEARCH + vb.NSFW_BREADTH_RULES[17:22],
        "SEARCH_TREND_TAKEOVER_PROMOTED_TWEET": _ADS,
        "LIST_SEARCH": _LISTS,
        "LIST_HEADER": _MINIMAL,
        "LIST_MEMBERSHIPS": _ENGAGERS,
        "LIST_OWNERSHIPS": _ENGAGERS,
        "LIST_RECOMMENDATIONS": _RECS,
        "LIST_SUBSCRIPTIONS": _ENGAGERS,
        "ALL_SUBSCRIBED_LISTS": _ENGAGERS,
        "RECOMMENDATIONS": _RECS,
        "RECOS_VIDEO": _RECS + MEDIA_SURFACE_RULES,
        "RECOS_WRITE_PATH": _WRITE_PATH,
        "EXPLORE_RECOMMENDATIONS": _RECS,
        "TOPIC_RECOMMENDATIONS": _RECS,
        "TOPICS_LANDING_PAGE_TOPIC_RECOMMENDATIONS": _RECS,
        "FOLLOWED_TOPICS_TIMELINE": _LISTS,
        "CURATED_TRENDS_REPRESENTATIVE_TWEET": _TRENDS,
        "TRENDS_REPRESENTATIVE_TWEET": _TRENDS,
        "NEARBY_TIMELINE": _RECS,
        "MOMENTS": _TRENDS,
        "LIVE_VIDEO_TIMELINE": _MEDIA,
        "ARTICLE_TWEET_TIMELINE": _LISTS,
        "TWITTER_ARTICLE_COMPOSE": _WRITE_PATH,
        "TWITTER_ARTICLE_PROFILE_TAB": _PROFILE,
        "TWITTER_ARTICLE_READ": _PROFILE,
        "EDIT_HISTORY_TIMELINE": _TWEET_DETAIL,
        "ELEVATED_QUOTE_TWEET_TIMELINE": _QUOTED,
        "QUOTE_TWEET_TIMELINE": _QUOTED,
        "QUOTED_TWEET_RULES": _QUOTED,
        "DES_QUOTE_TWEET_TIMELINE": _DATA_API,
        "CONVERSATION_FOCAL_TWEET": _TWEET_DETAIL,
        "CONVERSATION_INJECTED_TWEET": _CONVERSATION,
        "CONVERSATION_REPLY": _CONVERSATION,
        "CONVERSATION_FOCAL_PREHYDRATION": _DATA_API,
        "REPLIES_GROUPING": _CONVERSATION,
        "TWEET_DETAIL": _TWEET_DETAIL,
        "TWEET_DETAIL_NON_TOO": _TWEET_DETAIL,
        "TWEET_DETAIL_WITH_INJECTIONS_HYDRATION": _DATA_API,
        "TWEET_ENGAGERS": _ENGAGERS,
        "TWEET_REPLY_NUDGE": vb.DUP_LOWQ_RULES[18:19] + _MINIMAL,
        "TWEET_AWARD": _MINIMAL,
        "TWEET_WRITES_API": _WRITE_PATH,
        "WRITE_PATH_LIMITED_ACTIONS_ENFORCEMENT":
            _WRITE_PATH + vb.COMMUNITY_RULES[22:31]
            + vb.EXCLUSIVE_TRUSTED_RULES[9:10]
            + vb.SEARCH_BREADTH_RULES[21:22],
        "COMMUNITIES": _COMMUNITIES,
        "MODERATED_TWEETS_TIMELINE": _ENGAGERS + vb.COMMUNITY_RULES[28:29],
        "TIMELINE_MODERATED_TWEETS_HYDRATION": _DATA_API,
        "BIRDWATCH_NOTE_AUTHOR": _SEARCH_USER,
        "BIRDWATCH_NOTE_TWEETS_TIMELINE": _CONVERSATION,
        "BIRDWATCH_NEEDS_YOUR_HELP_NOTIFICATIONS": _PUSH,
        "HUMANIZATION_NUDGE": vb.DUP_LOWQ_RULES[17:19] + _MINIMAL,
        "SOFT_INTERVENTION_PIVOT": FOSNR_ENGAGEMENT_RULES + _MINIMAL,
        "EMBEDS_PUBLIC_INTEREST_NOTICE": PUBLIC_INTEREST_RULES + _MINIMAL,
        "EMBEDDED_TWEET": _EMBEDS,
        "EMBED_TWEET_MARKUP": _EMBEDS,
        "CARD_POLL_VOTING": _MINIMAL + vb.DUP_LOWQ_RULES[13:15],
        "CARDS_SERVICE": _DATA_API,
        "STICKERS_TIMELINE": _MEDIA,
        "CURATION_POLICY_VIOLATIONS": vb.TERMINAL_RULES[:1] + _MINIMAL,
        "RITO_ACTIONED_TWEET_TIMELINE":
            _MINIMAL + DOWNRANKING_RULES[8:9],
        "REPORT_CENTER": vb.TERMINAL_RULES[:1] + _MINIMAL,
        "APPEALS": vb.TERMINAL_RULES[:1] + _MINIMAL,
        "NEW_USER_EXPERIENCE": _RECS,
        "RETURNING_USER_EXPERIENCE": _RECS,
        "RETURNING_USER_EXPERIENCE_FOCAL_TWEET": _TWEET_DETAIL,
        "BASE_QIG": _MINIMAL,
        "NOTIFICATIONS_QIG": _NOTIFICATIONS,
        "SOCIAL_PROOF": _ENGAGERS,
        "SIGNALS_REACTIONS": _ENGAGERS,
        "SIGNALS_TWEET_REACTING_USERS": _ENGAGERS,
        "FOLLOWER_CONNECTIONS": _ENGAGERS,
        "SUPER_FOLLOWER_CONNECTIONS": _ENGAGERS,
        "FRIENDS_FOLLOWING_LIST": _ENGAGERS,
        "FOLLOWING_AND_FOLLOWERS_USER_LIST": _ENGAGERS,
        "TRUSTED_FRIENDS_USER_LIST":
            _ENGAGERS + vb.EXCLUSIVE_TRUSTED_RULES[5:10],
        "TWITTER_DELEGATE_USER_LIST": _ENGAGERS,
        "BLOCK_MUTE_USERS_TIMELINE": vb.TERMINAL_RULES[:1] + _MINIMAL,
        "SUPER_LIKE": _ENGAGERS,
        "USER_MILESTONE_RECOMMENDATION": _RECS,
        "CONTENT_CONTROL_TOOL_INSTALL": _MINIMAL,
        "SHOPPING_MANAGER_SPY_MODE": vb.TERMINAL_RULES[:1] + _MINIMAL,
        "GRYPHON_DECKS_AND_COLUMNS": _LISTS,
        "GRAPHQL_DEFAULT": _BASE + _COMMON_CONTENT,
        "STRATO_EXT_LIMITED_ENGAGEMENTS":
            vb.AVOID_RULES[5:6] + vb.COMMUNITY_RULES[22:31] + _MINIMAL,
        "LIVE_PIPELINE_ENGAGEMENT_COUNTS": _DATA_API,
        "STREAM_SERVICES": _DATA_API,
        "ZIPBIRD_CONSUMER_ARCHIVES": _DATA_API,
        "DEPRECATED_SAFETY_LEVEL": _MINIMAL,
        "ACCESS_INTERNAL_PROMOTED_CONTENT": _ADS,
        "QUICK_PROMOTE_TWEET_ELIGIBILITY": _ADS,
        "REVENUE": _ADS,
        "VIDEO_ADS": _ADS,
        "BRAND_SAFETY": _ADS,
        "DEV_PLATFORM_GET_LIST_TWEETS": _DATA_API,
        "DEV_PLATFORM_COMPLIANCE_STREAM": _DATA_API,
    }
    if N in exact:
        return exact[N]
    if N.startswith("DES_"):
        return _DATA_API
    if N.startswith("ADS_"):
        return _ADS
    if N.startswith("MAGIC_RECS") or N.startswith("NOTIFICATIONS_"):
        if "PUSH" in N or N.startswith("MAGIC_RECS"):
            return _PUSH
        if "WRITE" in N or "WRITER" in N or "HYDRATOR" in N:
            return _WRITE_PATH
        return _NOTIFICATIONS
    if N.startswith("DIRECT_MESSAGES"):
        if "SEARCH" in N:
            return RELATIONSHIP_RULES + DM_RULES + vb.DM_BREADTH_RULES
        if "INBOX" in N or "CONVERSATION_LIST" in N:
            return _DM_INBOX
        if "MUTED" in N:
            return vb.TERMINAL_RULES[:1] + _MINIMAL
        return _DM
    if N.startswith("SPACE"):
        if "SHARING" in N or "HOME_TIMELINE" in N or "FLEETLINE" in N \
                or "AVATAR" in N:
            return _SPACES + FOSNR_AMPLIFICATION_RULES
        if "NOTIFICATIONS" in N:
            return _SPACES + _PUSH[-8:]
        if "SELLER" in N or "PARTICIPANTS" in N:
            return _ENGAGERS
        return _SPACES
    if "HYDRATION" in N:
        return _DATA_API
    raise KeyError(f"unassigned safety level: {N}")


CATALOG_RULES: Dict[SafetyLevel, List[Rule]] = {
    lvl: _classify(lvl.name) for lvl in SafetyLevel
}


def catalog_engine(stats=None):
    from the_algorithm_tpu_torch.pipeline.visibility import VisibilityRuleEngine

    return VisibilityRuleEngine(CATALOG_RULES, stats=stats)


def all_rule_names() -> List[str]:
    seen = []
    for rules in CATALOG_RULES.values():
        for r in rules:
            if r.name not in seen:
                seen.append(r.name)
    return seen


# -- store-backed rules (country takedowns + author safety states) -------------
#
# ≡ the reference's interaction between visibilitylib and the takedown /
# user-state stores (``CountryWithheldTweet``/``WithheldAuthor`` rule family
# and the suspended/deactivated-author rules). Conditions close over the
# live stores and read ``tweet_id``/``author_id``/``viewer_country`` from
# the feature map (VisibilityFilter feeds ``candidate.features``; put the
# ids there via a hydrator or the candidate-lift hydrator).


def store_backed_rules(takedowns=None, author_state_fn=None) -> List[Rule]:
    """Rules wired to the tweetypie TakedownStore and the ingester's
    author-state table; pass whichever stores are deployed."""
    rules: List[Rule] = []
    if takedowns is not None:
        rules.append(Rule(
            "DropCountryWithheldTweet",
            lambda f: takedowns.is_withheld(
                int(f.get("tweet_id", -1)), f.get("viewer_country")
            ),
            Action.DROP, "withheld_in_country", fail_closed=True,
        ))
    if author_state_fn is not None:
        def _bad_author(f):
            st = author_state_fn(int(f.get("author_id", -1)))
            return st is not None and int(st) != 0  # != AuthorState.NORMAL

        rules.append(Rule(
            "DropUnavailableAuthorContent", _bad_author, Action.DROP,
            "author_unavailable", fail_closed=True,
        ))
    return rules


def catalog_engine_with_stores(takedowns=None, author_state_fn=None,
                               stats=None):
    """Catalog engine with the store-backed rules prepended at every level
    (they are relationship-grade drops — severity before label rules)."""
    from the_algorithm_tpu_torch.pipeline.visibility import VisibilityRuleEngine

    extra = store_backed_rules(takedowns, author_state_fn)
    rules = {lvl: extra + list(rs) for lvl, rs in CATALOG_RULES.items()}
    return VisibilityRuleEngine(rules, stats=stats)
