"""Home-mixer: the For You timeline construction pipeline.

≡ ``home-mixer/`` (SURVEY.md §3.1): ForYouProductPipelineConfig →
ScoredTweetsRecommendationPipelineConfig — candidate pipelines (Earlybird
in-network, UTEG, TweetMixer OON) → dedup → feature hydration → global
filters (age/seen/author) → MaskNet multi-head scoring → weighted score
(``NaviModelScorer.computeWeightedModelScore:143-177``) → heuristic
author-diversity rescoring (``ListwiseRescoringProvider`` family) →
selection. Built on the pipeline engine with fail-open + quality factors.

Counterpart of ``the_algorithm_tpu/mixers/home_mixer.py`` (host code). The
model runs behind ``predict_fn`` (numpy [B, F] → probabilities [B, H]):
:func:`~the_algorithm_tpu_torch.models.masknet.predict_fn` builds it over a
MaskNet on the card. The weighted head combination runs on the host in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.mixers import feature_schema
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    CandidatePipeline,
    DedupSelector,
    FeatureHydrator,
    Filter,
    FilterResult,
    Scorer,
    Selector,
)
from the_algorithm_tpu_torch.pipeline.recommendation import (
    QualityFactorConfig,
    RecommendationPipeline,
)


@dataclasses.dataclass
class ForYouQuery:
    """The PipelineQuery analog for the For You product."""

    user_id: int
    followed_authors: Sequence[int] = ()
    seen_tweet_ids: frozenset = frozenset()
    max_results: int = 50
    now: int = 0
    features: Dict[str, object] = dataclasses.field(default_factory=dict)


# -- feature assembly + model scorer ----------------------------------------


class FeatureMatrixAssembler:
    """candidate features → dense [B, F] matrix by a fixed schema
    (the DataRecordConverter/segdense role, ``NaviModelScorer.scala:88-139``).

    Columnar-first: schema entries present in the request's
    :class:`~the_algorithm_tpu_torch.mixers.feature_schema.ColumnarFeatureStore`
    are assembled by vectorized column stacking with searchsorted
    id-alignment (correct across filter-induced shrink/reorder). Scalar
    entries the store doesn't carry fall back to the per-candidate dict —
    the compat path for the narrow object-model features.
    """

    def __init__(self, schema: Sequence):
        self.schema = [
            s if isinstance(s, feature_schema.FeatureSpec)
            else feature_schema.FeatureSpec(s)
            for s in schema
        ]
        self.width = feature_schema.total_width(self.schema)

    def __call__(self, query, candidates: List[Candidate]) -> np.ndarray:
        ids = np.asarray([c.id for c in candidates], np.int64)
        store = feature_schema.peek_store(query)
        if store is not None:
            out = store.assemble(ids, self.schema)
            # overlay dict-only scalars (store-absent names)
            have = set(store.names())
            col = 0
            for spec in self.schema:
                if spec.width == 1 and spec.name not in have:
                    for r, c in enumerate(candidates):
                        v = c.features.get(spec.name)
                        if v is not None:
                            out[r, col] = float(v)
                col += spec.width
            return out
        out = np.zeros((len(candidates), self.width), np.float32)
        col = 0
        for spec in self.schema:
            if spec.width == 1:
                for r, c in enumerate(candidates):
                    v = c.features.get(spec.name)
                    if v is not None:
                        out[r, col] = float(v)
            col += spec.width
        return out


class MaskNetScorer(Scorer):
    """Heavy-ranker scorer: per-head probabilities + weighted combination.

    Stores per-head probabilities as ``predicted_<head>`` features (≡ the
    PREDICTED_IS_* DataRecord features) and the combined score in
    ``candidate.score``.
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],  # [B,F] -> [B,H] probs
        assembler: FeatureMatrixAssembler,
        head_names: Sequence[str],
        head_weights,
        name: str = "MaskNetScorer",
    ):
        self.predict_fn = predict_fn
        self.assembler = assembler
        self.head_names = list(head_names)
        self.head_weights = torch.as_tensor(np.asarray(head_weights, np.float32))
        self._name = name

    @property
    def name(self):
        return self._name

    def score(self, query, candidates, params) -> None:
        if not candidates:
            return
        feats = self.assembler(query, candidates)
        probs = np.asarray(self.predict_fn(feats), np.float32)  # [B, H]
        combined = masknet.weighted_model_score(
            torch.from_numpy(probs), self.head_weights).numpy()
        for r, c in enumerate(candidates):
            for j, h in enumerate(self.head_names):
                c.features[f"predicted_{h}"] = float(probs[r, j])
            c.score = float(combined[r])


# -- heuristic rescoring -----------------------------------------------------


class AuthorDiversityRescorer(Selector):
    """Multiplicative decay for repeated authors, preserving order input →
    re-sorted (≡ the author-diversity listwise rescorer in
    ``scorer/{HeuristicScorer,ListwiseRescoringProvider}.scala``)."""

    def __init__(self, decay: float = 0.5, floor: float = 0.25):
        self.decay = decay
        self.floor = floor

    def select(self, query, candidates, params):
        ranked = sorted(
            candidates, key=lambda c: -(c.score if c.score is not None else 0.0)
        )
        seen_count: Dict[int, int] = {}
        for c in ranked:
            author = c.features.get("author_id")
            if author is None or c.score is None:
                continue
            k = seen_count.get(author, 0)
            factor = max(self.decay**k, self.floor)
            c.score *= factor
            seen_count[author] = k + 1
        return sorted(
            ranked, key=lambda c: -(c.score if c.score is not None else 0.0)
        )


class SeenTweetsFilter(Filter):
    """≡ the seen/impressed filter (impression bloom filter side effect +
    dedup global filter)."""

    def apply(self, query, candidates, params):
        kept, removed = [], []
        for c in candidates:
            (removed if c.id in query.seen_tweet_ids else kept).append(c)
        return FilterResult(kept, removed)


class MaxAgeFilter(Filter):
    def __init__(self, max_age_s: int):
        self.max_age_s = max_age_s

    def apply(self, query, candidates, params):
        kept, removed = [], []
        for c in candidates:
            ts = c.features.get("created_ts")
            if ts is None or query.now - ts <= self.max_age_s:
                kept.append(c)
            else:
                removed.append(c)
        return FilterResult(kept, removed)


# -- the For You pipeline builder -------------------------------------------


DEFAULT_FEATURE_SCHEMA = (
    "retrieval_score", "social_proof", "author_id", "created_ts",
    "fav_count", "reply_count", "retweet_count",
    "fav_7d_avg", "fav_7d_max", "retweet_7d_avg",
    "follows_who_favorited", "follows_who_favorited_normalized",
    "realgraph_score", "tweepcred",
)


def build_for_you_pipeline(
    *,
    candidate_pipelines: Sequence[CandidatePipeline],
    hydrators: Sequence[FeatureHydrator],
    predict_fn: Callable[[np.ndarray], np.ndarray],
    head_names: Sequence[str] = masknet.DEFAULT_HEAD_NAMES,
    head_weights=masknet.DEFAULT_HEAD_WEIGHTS,
    feature_schema: Sequence[str] = DEFAULT_FEATURE_SCHEMA,
    max_tweet_age_s: int = 48 * 3600,
    quality_factor: Optional[QualityFactorConfig] = None,
    query_hydrators: Sequence = (),
    phoenix_scorer=None,
    phoenix_rescoring_store=None,
    phoenix_rerank_alpha: float = 0.5,
    side_effects: Sequence = (),
    stats=None,
) -> RecommendationPipeline:
    """Assemble the ScoredTweets pipeline (engine order per
    ``RecommendationPipelineConfig.scala:57-201``).

    ``phoenix_scorer``: optional
    :class:`~the_algorithm_tpu_torch.mixers.phoenix_scorer.PhoenixScorer` run
    AFTER MaskNet (the reference's scorer order: Navi heads first, Phoenix
    re-scores with per-head prod fallback when the query carries a user
    action sequence — hydrate it via ``query_hydrators`` with
    ``UserActionsQueryHydrator``).
    """
    scorer = MaskNetScorer(
        predict_fn,
        FeatureMatrixAssembler(feature_schema),
        head_names,
        head_weights,
    )
    scorers = [scorer]
    if phoenix_scorer is not None:
        scorers.append(phoenix_scorer)
    hydrators = list(hydrators)
    effects = list(side_effects)
    if phoenix_rescoring_store is not None:
        # the Phoenix loop (PhoenixRescoring hydrator → reranking scorer →
        # scored-candidates side effect feeding the store + training log)
        from the_algorithm_tpu_torch.mixers import phoenix_loop as pl

        hydrators.append(
            pl.PhoenixRescoringFeatureHydrator(phoenix_rescoring_store))
        scorers.append(
            pl.PhoenixModelRerankingScorer(alpha=phoenix_rerank_alpha))
        effects.append(
            pl.ScoredPhoenixCandidatesSideEffect(phoenix_rescoring_store))
    return RecommendationPipeline(
        query_hydrators=list(query_hydrators),
        candidate_pipelines=list(candidate_pipelines),
        post_candidate_selectors=[DedupSelector()],
        post_candidate_hydrators=hydrators,
        global_filters=[
            SeenTweetsFilter(),
            MaxAgeFilter(max_tweet_age_s),
        ],
        scorers=scorers,
        scorer_fail_open=True,  # backup reverse-chron if scoring fails
        result_selectors=[
            AuthorDiversityRescorer(),
            _TruncateToQueryMax(),
        ],
        quality_factor=quality_factor,
        side_effects=effects,
        stats=stats,
    )


class _TruncateToQueryMax(Selector):
    def select(self, query, candidates, params):
        ranked = sorted(
            candidates, key=lambda c: -(c.score if c.score is not None else 0.0)
        )
        return ranked[: query.max_results]
