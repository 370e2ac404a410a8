"""Pushservice candidate adaptors, predicates, fatigue, and NTab store.

Counterpart of ``the_algorithm_tpu/mixers/push_candidates.py``, copied;
the health predicate brings the T&S scores to the host explicitly (a
score function may return tensors on the card).

≡ ``pushservice/src/main/scala/com/twitter/frigate/pushservice/{adaptor,
predicate,store,take}/`` (SURVEY.md §2.1, 42k LoC): the reference fans a
refresh out over ~14 candidate adaptors, stacks dozens of target/candidate
predicates (health models, fatigue, dedup, language), and the take step
writes sent notifications to NTab with per-type fatigue bookkeeping.

Here: :class:`CRT` is the CommonRecommendationType enum; adaptors wrap the
framework's retrieval engines and stamp the CRT; predicates are pure
functions over (target, candidate, NTab history); :class:`NTabStore` keeps
the per-user sent log that drives dedup + per-type fatigue + caret-feedback
demotion; :func:`build_push_adaptors` is the PushCandidateSourceGenerator
analog.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidateSource


class CRT(enum.Enum):
    """≡ CommonRecommendationType (the notification kind)."""

    IN_NETWORK_TWEET = "in_network_tweet"
    OON_TWEET = "oon_tweet"
    GEO_POP_TWEET = "geo_pop_tweet"
    TREND_TWEET = "trend_tweet"
    TOPIC_TWEET = "topic_tweet"
    VIDEO_TWEET = "video_tweet"
    FRS_TWEET = "frs_tweet"  # tweet by a recommended-to-follow author
    HIGH_QUALITY_TWEET = "high_quality_tweet"


OON_CRTS = frozenset(
    {CRT.OON_TWEET, CRT.GEO_POP_TWEET, CRT.TREND_TWEET, CRT.TOPIC_TWEET,
     CRT.VIDEO_TWEET, CRT.HIGH_QUALITY_TWEET}
)


class AdaptorSource(CandidateSource):
    """Wrap any CandidateSource and stamp CRT + adaptor name
    (≡ ``GenericCandidateAdaptor``)."""

    def __init__(self, inner: CandidateSource, crt: CRT, name: str,
                 max_results: Optional[int] = None):
        self._inner = inner
        self._crt = crt
        self._name = name
        self._max = max_results

    @property
    def name(self):
        return self._name

    def get(self, target, params) -> List[Candidate]:
        out = self._inner.get(target, params)
        if self._max is not None:
            out = out[: self._max]
        for c in out:
            c.features["crt"] = self._crt
            c.source = self._name
        return out


def build_push_adaptors(
    *,
    earlybird_source: Optional[CandidateSource] = None,
    content_mixer_source: Optional[CandidateSource] = None,
    frs_tweet_source: Optional[CandidateSource] = None,
    geo_top_source: Optional[CandidateSource] = None,
    trends_source: Optional[CandidateSource] = None,
    topic_source: Optional[CandidateSource] = None,
    video_source: Optional[CandidateSource] = None,
    high_quality_source: Optional[CandidateSource] = None,
) -> List[AdaptorSource]:
    """≡ ``PushCandidateSourceGenerator``: the adaptor fleet, skipping
    undeployed stores. Adaptor ↔ reference file:

    - earlybird    ↔ ``EarlyBirdFirstDegreeCandidateAdaptor``
    - content mix  ↔ ``ContentRecommenderMixerAdaptor``
    - frs tweets   ↔ ``FRSTweetCandidateAdaptor``
    - geo top      ↔ ``TopTweetsByGeoAdaptor`` / ``TripGeoCandidatesAdaptor``
    - trends       ↔ ``TrendsCandidatesAdaptor``
    - topic        ↔ (topic tweets via CR-mixer path)
    - video        ↔ ``ExploreVideoTweetCandidateAdaptor``
    - high quality ↔ ``HighQualityTweetsAdaptor``
    """
    table = [
        (earlybird_source, CRT.IN_NETWORK_TWEET, "EarlybirdFirstDegree"),
        (content_mixer_source, CRT.OON_TWEET, "ContentRecommenderMixer"),
        (frs_tweet_source, CRT.FRS_TWEET, "FRSTweetCandidate"),
        (geo_top_source, CRT.GEO_POP_TWEET, "TopTweetsByGeo"),
        (trends_source, CRT.TREND_TWEET, "TrendsCandidates"),
        (topic_source, CRT.TOPIC_TWEET, "TopicTweets"),
        (video_source, CRT.VIDEO_TWEET, "ExploreVideoTweet"),
        (high_quality_source, CRT.HIGH_QUALITY_TWEET, "HighQualityTweets"),
    ]
    return [
        AdaptorSource(src, crt, name)
        for src, crt, name in table
        if src is not None
    ]


# -- NTab store (sent-notification history) ------------------------------------


@dataclasses.dataclass(frozen=True)
class SentNotification:
    tweet_id: int
    crt: CRT
    sent_at: int  # seconds
    opened: bool = False
    caret_feedback: bool = False  # "see less often"


class NTabStore:
    """Per-user sent-notification log (≡ the NTab/notification-history
    store feeding FatiguePredicate + TargetNtabCaretClickFatiguePredicate)."""

    def __init__(self):
        self._log: Dict[int, List[SentNotification]] = {}

    def record_sent(self, user_id: int, n: SentNotification) -> None:
        self._log.setdefault(int(user_id), []).append(n)

    def record_feedback(
        self, user_id: int, tweet_id: int, *, opened=False, caret=False
    ) -> None:
        for i, n in enumerate(self._log.get(int(user_id), [])):
            if n.tweet_id == tweet_id:
                self._log[int(user_id)][i] = dataclasses.replace(
                    n, opened=n.opened or opened,
                    caret_feedback=n.caret_feedback or caret,
                )

    def history(self, user_id: int, since: int = 0) -> List[SentNotification]:
        return [n for n in self._log.get(int(user_id), ())
                if n.sent_at >= since]

    def sent_tweet_ids(self, user_id: int) -> frozenset:
        return frozenset(n.tweet_id for n in self._log.get(int(user_id), ()))


# -- fatigue (per-type budgets + caret demotion) --------------------------------


@dataclasses.dataclass(frozen=True)
class TypeFatiguePolicy:
    """≡ FatiguePredicate knobs, per CRT group."""

    max_per_day: int = 2
    min_interval_s: int = 8 * 3600


@dataclasses.dataclass(frozen=True)
class PushFatigueConfig:
    global_max_per_day: int = 4
    global_min_interval_s: int = 4 * 3600
    per_type: Mapping[CRT, TypeFatiguePolicy] = dataclasses.field(
        default_factory=lambda: {
            CRT.IN_NETWORK_TWEET: TypeFatiguePolicy(3, 4 * 3600),
            CRT.OON_TWEET: TypeFatiguePolicy(1, 24 * 3600),
            CRT.GEO_POP_TWEET: TypeFatiguePolicy(1, 24 * 3600),
            CRT.TREND_TWEET: TypeFatiguePolicy(1, 24 * 3600),
            CRT.TOPIC_TWEET: TypeFatiguePolicy(2, 12 * 3600),
            CRT.VIDEO_TWEET: TypeFatiguePolicy(1, 24 * 3600),
            CRT.FRS_TWEET: TypeFatiguePolicy(1, 24 * 3600),
            CRT.HIGH_QUALITY_TWEET: TypeFatiguePolicy(2, 12 * 3600),
        }
    )
    # a caret ("see less often") on a CRT suppresses that CRT this long
    caret_suppression_s: int = 7 * 86400


def crt_allowed(
    ntab: NTabStore, user_id: int, crt: CRT, now: int,
    config: PushFatigueConfig,
) -> bool:
    """Per-type + global fatigue + caret suppression over NTab history."""
    day = now - 86400
    hist = ntab.history(user_id)
    recent = [n for n in hist if n.sent_at >= day]
    if len(recent) >= config.global_max_per_day:
        return False
    if hist and now - max(n.sent_at for n in hist) < config.global_min_interval_s:
        return False
    pol = config.per_type.get(crt, TypeFatiguePolicy())
    same = [n for n in recent if n.crt == crt]
    if len(same) >= pol.max_per_day:
        return False
    same_all = [n for n in hist if n.crt == crt]
    if same_all and now - max(n.sent_at for n in same_all) < pol.min_interval_s:
        return False
    carets = [n for n in hist if n.crt == crt and n.caret_feedback]
    if carets and now - max(n.sent_at for n in carets) < config.caret_suppression_s:
        return False
    return True


# -- predicate catalog ----------------------------------------------------------

# target predicates: (target, now) -> bool
# candidate predicates: (target, candidate) -> bool


def quiet_hours_predicate(start_hour: int = 22, end_hour: int = 8,
                          utc_offset_attr: str = "utc_offset_s"):
    """Local-time send window (the scheduling gate): no pushes inside
    [start_hour, end_hour) local."""

    def pred(target, now: int) -> bool:
        off = int(getattr(target, utc_offset_attr, 0) or 0)
        hour = ((now + off) % 86400) // 3600
        if start_hour <= end_hour:
            quiet = start_hour <= hour < end_hour
        else:
            quiet = hour >= start_hour or hour < end_hour
        return not quiet

    return pred


def health_model_predicate(
    safety_scores_fn: Callable[[np.ndarray], Mapping[str, np.ndarray]],
    max_nsfw: float = 0.2,
    max_toxicity: float = 0.3,
    max_abuse: float = 0.3,
):
    """≡ ``HealthPredicates`` / ``BqmlHealthModelPredicates``: batch-score
    candidates with the T&S heads and drop unhealthy ones.

    ``safety_scores_fn(tweet_ids [B]) -> {"nsfw"/"toxicity"/"abuse": [B]}``
    wraps the trust_safety model (``models/trust_safety.py``).
    """

    def batch_pred(target, candidates: List[Candidate]) -> List[bool]:
        if not candidates:
            return []
        ids = np.asarray([c.id for c in candidates])
        scores = safety_scores_fn(ids)
        keep = np.ones(len(candidates), bool)
        for key, cap in (("nsfw", max_nsfw), ("toxicity", max_toxicity),
                         ("abuse", max_abuse)):
            if key in scores:
                keep &= host_array(scores[key]) <= cap
        return keep.tolist()

    return batch_pred


def not_already_sent(ntab: NTabStore):
    """≡ the NTab dedup predicate: never push the same tweet twice."""

    def pred(target, c: Candidate) -> bool:
        return c.id not in ntab.sent_tweet_ids(target.user_id)

    return pred


def min_social_proof_for_oon(min_proof: float = 1.0):
    """≡ ``OONSpreadControlPredicate``: OON pushes need social proof."""

    def pred(target, c: Candidate) -> bool:
        if c.features.get("crt") not in OON_CRTS:
            return True
        return float(c.features.get("social_proof", 0.0)) >= min_proof

    return pred


def tweet_engagement_ratio_predicate(min_fav_to_reply: float = 0.5):
    """≡ ``TweetEngagementRatioPredicate``: drop reply-baity tweets."""

    def pred(target, c: Candidate) -> bool:
        favs = float(c.features.get("fav_count", 0.0))
        replies = float(c.features.get("reply_count", 0.0))
        if replies < 20:
            return True
        return favs / max(replies, 1.0) >= min_fav_to_reply

    return pred


def language_match_predicate():
    """≡ ``TweetLanguagePredicate``: candidate language ∈ target languages."""

    def pred(target, c: Candidate) -> bool:
        langs = getattr(target, "languages", None)
        lang = c.features.get("language")
        if not langs or lang is None:
            return True
        return lang in langs

    return pred
