"""PhoenixScorer: per-head action-probability scoring with prod fallback.

≡ ``home-mixer/server/.../functional_component/scorer/PhoenixScorer.scala``
+ the head registry ``model/PhoenixPredictedScoreFeature.scala:16-193``:
each Phoenix head maps to a set of ActionNames (score = max over the set's
predicted probabilities), carries a model weight, an eligibility rule
(video-duration gating for vqv/dwell), and a per-head "use prod" fallback to
the MaskNet ``predicted_*`` feature. The scorer runs only when the query has
a user action sequence (``onlyIf``), truncates to MaxCandidates=1400
(``PhoenixUtils.scala:36``), and writes ``phoenix_<head>`` features plus the
weighted combined score (same combination as
``NaviModelScorer.computeWeightedModelScore``).

Counterpart of ``the_algorithm_tpu/mixers/phoenix_scorer.py`` (host code;
the model runs behind ``predict_fn``, normally
:func:`~the_algorithm_tpu_torch.models.phoenix.scorer_predict_fn`, and the
13-head combination runs on the host in f32).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.models.phoenix import ActionName, BOOL_FEATURES
from the_algorithm_tpu_torch.pipeline.component import Candidate, Scorer

MAX_CANDIDATES = 1400  # PhoenixUtils.scala:36


def _video_gte_10s(c: Candidate) -> bool:
    return bool(c.features.get("has_video", False)) and (
        float(c.features.get("video_duration_ms", 0)) / 1000.0 >= 10
    )


@dataclasses.dataclass(frozen=True)
class PhoenixHead:
    """One row of the PhoenixPredictedScoreFeature registry."""

    name: str
    actions: Sequence[ActionName]
    weight: float
    prod_feature: str  # MaskNet predicted_* fallback feature name
    eligible: Callable[[Candidate], bool] = lambda c: True
    use_prod: bool = False  # the per-head UseProdInPhoenixParams flag


A = ActionName
# ≡ PhoenixPredictedScoreFeature.scala:30-193 (head → actions); weights follow
# the shared ModelWeights params (masknet.DEFAULT_HEAD_WEIGHTS ordering)
PHOENIX_HEADS: Sequence[PhoenixHead] = (
    PhoenixHead("fav", (A.SERVER_TWEET_FAV,), 1.0, "predicted_fav"),
    PhoenixHead("reply", (A.SERVER_TWEET_REPLY,), 13.5, "predicted_reply"),
    PhoenixHead(
        "retweet", (A.SERVER_TWEET_QUOTE, A.SERVER_TWEET_RETWEET), 1.0,
        "predicted_retweet",
    ),
    PhoenixHead(
        "click_engage", (A.CLIENT_TWEET_PHOTO_EXPAND,), 12.0,
        "predicted_good_click_convo",
    ),
    PhoenixHead(
        "click_dwell", (A.CLIENT_TWEET_CLICK,), 12.0,
        "predicted_good_click_profile",
    ),
    PhoenixHead(
        "good_profile_click", (A.CLIENT_TWEET_CLICK_PROFILE,), 10.0,
        "predicted_good_profile_click",
    ),
    PhoenixHead(
        "vqv", (A.CLIENT_TWEET_VIDEO_QUALITY_VIEW,), 0.005,
        "predicted_video_quality_view", eligible=_video_gte_10s,
    ),
    PhoenixHead(
        "share",
        (
            A.CLIENT_TWEET_SHARE_VIA_COPY_LINK,
            A.CLIENT_TWEET_CLICK_SEND_VIA_DIRECT_MESSAGE,
            A.CLIENT_TWEET_SHARE,
        ),
        1.0,
        "predicted_share",
    ),
    PhoenixHead(
        "dwell", (A.CLIENT_TWEET_RECAP_DWELLED,), 0.005, "predicted_dwell",
        eligible=lambda c: not _video_gte_10s(c),
    ),
    PhoenixHead("open_link", (A.CLIENT_TWEET_OPEN_LINK,), 0.1, "predicted_share"),
    PhoenixHead(
        "screenshot", (A.CLIENT_TWEET_TAKE_SCREENSHOT,), 1.0, "predicted_share"
    ),
    PhoenixHead(
        "bookmark", (A.CLIENT_TWEET_BOOKMARK,), 0.3, "predicted_bookmark"
    ),
    PhoenixHead(
        "negative_feedback_v2",
        (
            A.CLIENT_TWEET_NOT_INTERESTED_IN,
            A.CLIENT_TWEET_BLOCK_AUTHOR,
            A.CLIENT_TWEET_MUTE_AUTHOR,
            A.CLIENT_TWEET_REPORT,
        ),
        -74.0,
        "predicted_negative_feedback_v2",
    ),
)


def candidate_bool_features(c: Candidate) -> np.ndarray:
    """≡ PhoenixUtils.getTweetInfoFromCandidates TweetBoolFeatures."""
    is_retweet = c.features.get("source_tweet_id") is not None
    vals = {
        "is_retweet": float(is_retweet),
        "is_reply": float(c.features.get("in_reply_to_tweet_id") is not None),
        "is_quote": float(c.features.get("quoted_tweet_id") is not None),
        "is_for_you": 1.0,
        "is_promoted": 0.0,
    }
    return np.asarray([vals[n] for n in BOOL_FEATURES], np.float32)


class PhoenixScorer(Scorer):
    """Runs the action-sequence model over the candidate set.

    ``predict_fn(author_hashes [C], bool_features [C, NB], valid [C],
    user_actions) -> [C, NUM_ACTIONS]`` probabilities — normally a wrapper
    around :func:`models.phoenix.predict_next_actions` with the
    query's assembled :class:`UserActionSequence`
    (:func:`~the_algorithm_tpu_torch.models.phoenix.scorer_predict_fn`).
    """

    def __init__(
        self,
        predict_fn,
        heads: Sequence[PhoenixHead] = PHOENIX_HEADS,
        name: str = "Phoenix",
    ):
        self._predict = predict_fn
        self.heads = list(heads)
        self._name = name

    @property
    def name(self):
        return self._name

    def only_if(self, query) -> bool:
        """≡ PhoenixScorer.onlyIf: requires a hydrated action sequence."""
        return query.features.get("user_actions") is not None

    def score(self, query, candidates: List[Candidate], params) -> None:
        if not candidates or not self.only_if(query):
            return
        cands = candidates[:MAX_CANDIDATES]
        # source-tweet remap for retweets (PhoenixUtils:49-59)
        authors = np.asarray(
            [
                int(
                    c.features.get("source_user_id")
                    or c.features.get("author_id", 0)
                )
                for c in cands
            ],
            np.int32,
        )
        bools = np.stack([candidate_bool_features(c) for c in cands])
        valid = np.ones(len(cands), bool)
        probs = np.asarray(
            self._predict(
                authors, bools, valid, query.features["user_actions"]
            )
        )  # [C, NUM_ACTIONS]

        weights = torch.tensor([h.weight for h in self.heads], dtype=torch.float32)
        head_probs = np.zeros((len(cands), len(self.heads)), np.float32)
        for j, c in enumerate(cands):
            for k, h in enumerate(self.heads):
                if not h.eligible(c):
                    continue
                if h.use_prod:
                    p = c.features.get(h.prod_feature)
                else:
                    p = max(float(probs[j, int(a)]) for a in h.actions)
                    if p == 0.0:  # missing prediction -> prod fallback
                        p = c.features.get(h.prod_feature)
                if p is None:
                    continue
                head_probs[j, k] = float(p)
                c.features[f"phoenix_{h.name}"] = float(p)
        combined = masknet.weighted_model_score(
            torch.from_numpy(head_probs), weights).numpy()
        for j, c in enumerate(cands):
            c.score = float(combined[j])
