"""CR-mixer: signal-routed candidate generation with score blending.

A host copy of ``the_algorithm_tpu/mixers/cr_mixer.py``. ≡
``cr-mixer/server/.../candidate_generation/{CandidateSourcesRouter,
CrCandidateGenerator}.scala`` + ``blender/`` (previous-gen OON candidate
generation, SURVEY.md §2.1): extract source signals from USS → route each
signal to the similarity engines that understand it (tweet-based engines
take recent engaged tweets, producer-based take follows, consumer-based take
the user id) → run engines in parallel fail-open → blend → light
filter/truncate.

Complements :mod:`the_algorithm_tpu_torch.mixers.tweet_mixer` (which implements
the current-gen interleave blender): this module adds the router and the
*score-based* blenders cr-mixer used before interleaving won out.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence

from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.core.metrics import NullStats, StatsReceiver
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidateSource


class SignalKind(enum.Enum):
    """≡ USS SignalType groups cr-mixer routes on
    (``CandidateSourcesRouter.scala``)."""

    TWEET_ENGAGEMENT = "tweet_engagement"  # recent fav/RT/reply/share tweets
    PRODUCER = "producer"  # follows / profile visits
    CONSUMER = "consumer"  # the requesting user themself


@dataclasses.dataclass(frozen=True)
class SourceSignal:
    kind: SignalKind
    entity_id: int  # tweet id / producer id / user id
    weight: float = 1.0


# an engine takes (signal, params) → ranked candidates; engines declare
# which signal kinds they consume (≡ similarity_engine/*.scala type tags)
@dataclasses.dataclass
class EngineSpec:
    name: str
    consumes: SignalKind
    engine: Callable[[SourceSignal, Params], List[Candidate]]
    weight: float = 1.0  # blender weight
    max_signals: int = 4  # signals routed per request (fan-out cap)


def route_signals(
    signals: Sequence[SourceSignal], specs: Sequence[EngineSpec]
) -> List[tuple]:
    """→ [(spec, signal)] engine invocations (the router's fan-out plan)."""
    plan = []
    for spec in specs:
        matching = [s for s in signals if s.kind == spec.consumes]
        # strongest signals first, capped (the reference caps per-engine QPS)
        matching.sort(key=lambda s: -s.weight)
        for s in matching[: spec.max_signals]:
            plan.append((spec, s))
    return plan


def _min_max_normalize(cands: List[Candidate]) -> Dict[int, float]:
    if not cands:
        return {}
    scores = [c.score or 0.0 for c in cands]
    lo, hi = min(scores), max(scores)
    if hi <= lo:
        return {c.id: 1.0 for c in cands}
    return {c.id: ((c.score or 0.0) - lo) / (hi - lo) for c in cands}


def weighted_score_blend(
    per_engine: Dict[str, List[Candidate]],
    engine_weights: Dict[str, float],
    max_results: int,
) -> List[Candidate]:
    """Score-based blend (≡ cr-mixer's weighted blender): min-max normalize
    each engine's scores (scales are incomparable across engines), then sum
    weight·score over engines per candidate — a candidate surfaced by many
    engines accumulates evidence."""
    acc: Dict[int, float] = {}
    keep: Dict[int, Candidate] = {}
    for name, cands in per_engine.items():
        w = engine_weights.get(name, 1.0)
        normed = _min_max_normalize(cands)
        for c in cands:
            acc[c.id] = acc.get(c.id, 0.0) + w * normed[c.id]
            if c.id not in keep:
                keep[c.id] = c
    out = sorted(acc.items(), key=lambda kv: -kv[1])[:max_results]
    result = []
    for cid, score in out:
        c = keep[cid]
        result.append(
            Candidate(id=c.id, features=c.features, score=score, source=c.source)
        )
    return result


def rank_decay_blend(
    per_engine: Dict[str, List[Candidate]],
    engine_weights: Dict[str, float],
    max_results: int,
    decay: float = 0.97,
) -> List[Candidate]:
    """Rank-based blend: contribution = weight·decay^rank — robust to score
    scales entirely (only order matters), the reference's rank blender."""
    acc: Dict[int, float] = {}
    keep: Dict[int, Candidate] = {}
    for name, cands in per_engine.items():
        w = engine_weights.get(name, 1.0)
        for rank, c in enumerate(cands):
            acc[c.id] = acc.get(c.id, 0.0) + w * (decay ** rank)
            if c.id not in keep:
                keep[c.id] = c
    out = sorted(acc.items(), key=lambda kv: -kv[1])[:max_results]
    return [
        Candidate(id=cid, features=keep[cid].features, score=s,
                  source=keep[cid].source)
        for cid, s in out
    ]


@dataclasses.dataclass
class CrMixerConfig:
    max_results: int = 200
    blender: str = "weighted"  # weighted | rank_decay | interleave
    min_blended_score: float = 0.0


class CrCandidateGenerator:
    """≡ ``CrCandidateGenerator.scala``: the full signal→candidates flow."""

    def __init__(
        self,
        specs: Sequence[EngineSpec],
        config: CrMixerConfig = CrMixerConfig(),
        stats: Optional[StatsReceiver] = None,
    ):
        self.specs = list(specs)
        self.config = config
        self.stats = (stats or NullStats()).scope("cr_mixer")

    def generate(
        self, signals: Sequence[SourceSignal], params: Params
    ) -> List[Candidate]:
        plan = route_signals(signals, self.specs)
        per_engine: Dict[str, List[Candidate]] = {}
        for spec, signal in plan:
            try:
                got = spec.engine(signal, params)
            except Exception:  # fail-open per engine (≡ cr-mixer semantics)
                self.stats.counter(f"{spec.name}/failures")
                continue
            self.stats.counter(f"{spec.name}/candidates", len(got))
            per_engine.setdefault(spec.name, []).extend(got)

        weights = {s.name: s.weight for s in self.specs}
        if self.config.blender == "weighted":
            blended = weighted_score_blend(
                per_engine, weights, self.config.max_results
            )
        elif self.config.blender == "rank_decay":
            blended = rank_decay_blend(
                per_engine, weights, self.config.max_results
            )
        else:
            from the_algorithm_tpu_torch.mixers.tweet_mixer import interleave_blend

            blended = interleave_blend(
                list(per_engine.values()), self.config.max_results
            )
        return [
            c for c in blended
            if (c.score or 0.0) >= self.config.min_blended_score
        ]


class CrMixerSource(CandidateSource):
    """Pipeline-facing wrapper: query must expose ``signals``."""

    def __init__(self, generator: CrCandidateGenerator):
        self.generator = generator

    def get(self, query: Any, params: Params) -> List[Candidate]:
        signals = getattr(query, "signals", None) or query["signals"]
        return self.generator.generate(signals, params)
