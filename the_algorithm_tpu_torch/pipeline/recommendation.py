"""The recommendation-pipeline engine: ordered steps with fail-open.

A host copy of ``the_algorithm_tpu/pipeline/recommendation.py`` (that
module's package imports JAX).

≡ ``product-mixer/core/.../pipeline/recommendation/RecommendationPipelineConfig.scala:57-201``
step surface, executed in engine order:

  gates → query hydration (2 phases) → candidate pipelines (parallel,
  fail-open) → post-candidate selectors (merge/dedup) → post-candidate
  feature hydration → global filters → scoring pipelines (fail-open,
  quality-factor-clamped) → result selectors → side effects

plus: per-component FailOpenPolicy
(``ScoredTweetsRecommendationPipelineConfig.scala:493-509``) and the
latency-based linear quality factor that shrinks the scoring batch under
pressure (``:510-521``; Earlybird's ``EarlybirdCPUQualityFactor`` analog).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.core.metrics import NullStats, StatsReceiver
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    CandidatePipeline,
    FeatureHydrator,
    Filter,
    Gate,
    QueryFeatureHydrator,
    Scorer,
    Selector,
    SideEffect,
)


@dataclasses.dataclass(frozen=True)
class FailOpenPolicy:
    """≡ ``pipeline/FailOpenPolicy.scala`` — continue without the component."""

    enabled: bool = True


@dataclasses.dataclass
class QualityFactorConfig:
    """≡ ``LinearLatencyQualityFactorConfig`` (ScoredTweets…Config:510-521).

    Keeps a quality factor qf ∈ [min_qf, 1]; each request above/below the
    latency target nudges qf down/up linearly; the scoring stage only scores
    ``int(qf · len(candidates))`` of its input.
    """

    target_latency_ms: float = 200.0
    min_quality_factor: float = 0.1
    up_step: float = 0.01
    down_step: float = 0.05

    def __post_init__(self):
        self.quality_factor = 1.0

    def update(self, observed_ms: float) -> None:
        if observed_ms > self.target_latency_ms:
            self.quality_factor = max(
                self.min_quality_factor, self.quality_factor - self.down_step
            )
        else:
            self.quality_factor = min(1.0, self.quality_factor + self.up_step)


@dataclasses.dataclass
class PipelineResult:
    candidates: List[Candidate]
    removed: Dict[str, int] = dataclasses.field(default_factory=dict)
    gated: bool = False
    failures: Dict[str, str] = dataclasses.field(default_factory=dict)


class RecommendationPipeline:
    """Engine executing the step order above over in-process components."""

    def __init__(
        self,
        *,
        gates: Sequence[Gate] = (),
        query_hydrators: Sequence[QueryFeatureHydrator] = (),
        query_hydrators_phase2: Sequence[QueryFeatureHydrator] = (),
        candidate_pipelines: Sequence[CandidatePipeline],
        post_candidate_selectors: Sequence[Selector] = (),
        post_candidate_hydrators: Sequence[FeatureHydrator] = (),
        global_filters: Sequence[Filter] = (),
        scorers: Sequence[Scorer] = (),
        scorer_fail_open: bool = False,
        result_selectors: Sequence[Selector] = (),
        side_effects: Sequence[SideEffect] = (),
        quality_factor: Optional[QualityFactorConfig] = None,
        stats: Optional[StatsReceiver] = None,
        max_concurrency: int = 8,
    ):
        self.gates = list(gates)
        self.query_hydrators = list(query_hydrators)
        self.query_hydrators_phase2 = list(query_hydrators_phase2)
        self.candidate_pipelines = list(candidate_pipelines)
        self.post_candidate_selectors = list(post_candidate_selectors)
        self.post_candidate_hydrators = list(post_candidate_hydrators)
        self.global_filters = list(global_filters)
        self.scorers = list(scorers)
        self.scorer_fail_open = scorer_fail_open
        self.result_selectors = list(result_selectors)
        self.side_effects = list(side_effects)
        self.quality_factor = quality_factor
        self.stats = stats or NullStats()
        self._pool = ThreadPoolExecutor(max_workers=max_concurrency)

    def run(self, query: Any, params: Params = Params()) -> PipelineResult:
        t_start = time.perf_counter()
        result = PipelineResult(candidates=[])
        stats = self.stats

        # 1. gates
        for gate in self.gates:
            if not gate.should_continue(query, params):
                stats.counter(f"gate/{gate.name}/closed")
                result.gated = True
                return result

        # 2. query feature hydration (two phases; phase2 may depend on phase1)
        query_features: Dict[str, Any] = {}
        for phase in (self.query_hydrators, self.query_hydrators_phase2):
            for h in phase:
                try:
                    query_features.update(h.hydrate(query, params))
                except Exception as e:  # fail-open on query hydration
                    stats.counter(f"query_hydrator/{h.name}/failures")
                    result.failures[h.name] = str(e)
        if query_features:
            setattr(query, "features", {
                **getattr(query, "features", {}), **query_features
            }) if hasattr(query, "__dict__") else None

        # 3. candidate pipelines — parallel, per-pipeline fail-open
        def run_pipeline(cp: CandidatePipeline) -> List[Candidate]:
            with stats.scope(f"candidate_pipeline/{cp.name}").time("latency"):
                cands = cp.source.get(query, params)
                for c in cands:
                    c.source = cp.name
                for h in cp.hydrators:
                    h.hydrate(query, cands, params)
                for f in cp.filters:
                    fr = f.apply(query, cands, params)
                    result.removed[f"{cp.name}/{f.name}"] = len(fr.removed)
                    cands = fr.kept
                return cands

        futures = {
            cp.name: self._pool.submit(run_pipeline, cp)
            for cp in self.candidate_pipelines
        }
        candidates: List[Candidate] = []
        for cp in self.candidate_pipelines:
            try:
                got = futures[cp.name].result()
                stats.scope(f"candidate_pipeline/{cp.name}").counter(
                    "candidates", len(got)
                )
                candidates.extend(got)
            except Exception as e:
                stats.counter(f"candidate_pipeline/{cp.name}/failures")
                result.failures[cp.name] = str(e)
                if not cp.fail_open:
                    raise

        # 4. post-candidate selectors (merge/dedup)
        for sel in self.post_candidate_selectors:
            candidates = sel.select(query, candidates, params)

        # 5. post-candidate feature hydration (batched)
        for h in self.post_candidate_hydrators:
            try:
                h.hydrate(query, candidates, params)
            except Exception as e:
                stats.counter(f"hydrator/{h.name}/failures")
                result.failures[h.name] = str(e)

        # 6. global filters
        for f in self.global_filters:
            fr = f.apply(query, candidates, params)
            result.removed[f.name] = len(fr.removed)
            candidates = fr.kept

        # 7. scoring — quality-factor-clamped batch, optional fail-open
        if self.scorers and candidates:
            n = len(candidates)
            if self.quality_factor is not None:
                n = max(1, int(n * self.quality_factor.quality_factor))
            to_score = candidates[:n]
            stats.gauge("scoring/batch_size", len(to_score))
            try:
                for s in self.scorers:
                    with stats.scope(f"scorer/{s.name}").time("latency"):
                        s.score(query, to_score, params)
                candidates = to_score + [
                    c for c in candidates[n:]
                ]  # unscored tail keeps score=None (reverse-chron backup)
            except Exception as e:
                stats.counter("scoring/failures")
                result.failures["scoring"] = str(e)
                if not self.scorer_fail_open:
                    raise

        # 8. result selectors
        for sel in self.result_selectors:
            candidates = sel.select(query, candidates, params)

        result.candidates = candidates

        # 9. side effects (fire-and-forget, errors swallowed)
        for se in self.side_effects:
            try:
                se.run(query, candidates, params)
            except Exception as e:
                stats.counter(f"side_effect/{se.name}/failures")
                result.failures[se.name] = str(e)

        elapsed_ms = (time.perf_counter() - t_start) * 1e3
        stats.stat("pipeline/latency_ms", elapsed_ms)
        if self.quality_factor is not None:
            self.quality_factor.update(elapsed_ms)
            stats.gauge("pipeline/quality_factor", self.quality_factor.quality_factor)
        return result
