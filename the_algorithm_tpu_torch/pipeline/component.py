"""Functional-component traits: the product-mixer component model.

A host copy of ``the_algorithm_tpu/pipeline/component.py`` (that module's
package imports JAX). ≡ ``product-mixer/core/.../functional_component/
{candidate_source,feature_hydrator,filter,gate,scorer,selector,side_effect}/``:
a pipeline is composed of small typed components, each taking the query and
(for candidate-stage components) the candidate set.

In-process data model: a **query** is any object; **candidates** are
:class:`Candidate` records carrying an id and a ``FeatureMap`` (plain dict).
Components are duck-typed ABCs; the hot math inside them (retrieval kernels,
model forwards) runs on batched tensors, and the pipeline layer only
orchestrates.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

from the_algorithm_tpu_torch.core.config import Params

FeatureMap = Dict[str, Any]


@dataclasses.dataclass
class Candidate:
    """≡ product-mixer ``CandidateWithFeatures``."""

    id: int
    features: FeatureMap = dataclasses.field(default_factory=dict)
    score: Optional[float] = None
    source: Optional[str] = None

    def get(self, feature: str, default=None):
        return self.features.get(feature, default)


class Component(abc.ABC):
    """Base: every component has an identifier for stats/fail-open maps."""

    @property
    def name(self) -> str:
        return type(self).__name__


class Gate(Component):
    """≡ ``functional_component/gate/Gate.scala`` — stop the pipeline early."""

    @abc.abstractmethod
    def should_continue(self, query: Any, params: Params) -> bool:
        ...


class QueryFeatureHydrator(Component):
    """≡ ``BaseQueryFeatureHydrator`` — add features about the query/user."""

    @abc.abstractmethod
    def hydrate(self, query: Any, params: Params) -> FeatureMap:
        ...


class CandidateSource(Component):
    """≡ ``functional_component/candidate_source/CandidateSource.scala``."""

    @abc.abstractmethod
    def get(self, query: Any, params: Params) -> List[Candidate]:
        ...


class FeatureHydrator(Component):
    """≡ ``BaseCandidateFeatureHydrator`` — batch-annotate candidates."""

    @abc.abstractmethod
    def hydrate(
        self, query: Any, candidates: List[Candidate], params: Params
    ) -> None:
        """Mutates ``candidate.features`` in place (batched)."""


class FilterResult(NamedTuple):
    kept: List[Candidate]
    removed: List[Candidate]


class Filter(Component):
    """≡ ``functional_component/filter/Filter.scala``."""

    @abc.abstractmethod
    def apply(
        self, query: Any, candidates: List[Candidate], params: Params
    ) -> FilterResult:
        ...


class Scorer(Component):
    """≡ ``functional_component/scorer/Scorer.scala`` — sets scores."""

    @abc.abstractmethod
    def score(
        self, query: Any, candidates: List[Candidate], params: Params
    ) -> None:
        """Mutates ``candidate.score`` (and/or score features) in place."""


class Selector(Component):
    """≡ ``functional_component/selector/Selector.scala`` — order/truncate."""

    @abc.abstractmethod
    def select(
        self, query: Any, candidates: List[Candidate], params: Params
    ) -> List[Candidate]:
        ...


class SideEffect(Component):
    """≡ ``functional_component/side_effect/`` — fire-and-forget observers."""

    @abc.abstractmethod
    def run(self, query: Any, result: Sequence[Candidate], params: Params) -> None:
        ...


@dataclasses.dataclass
class CandidatePipeline:
    """≡ ``CandidatePipelineConfig``: source + its own hydrators/filters.

    ``fail_open``: swallow source errors and contribute nothing (the
    per-pipeline FailOpenPolicy, ScoredTweetsRecommendationPipelineConfig:493-509).
    """

    source: CandidateSource
    hydrators: Sequence[FeatureHydrator] = ()
    filters: Sequence[Filter] = ()
    fail_open: bool = True

    @property
    def name(self) -> str:
        return self.source.name


# -- common reusable components (component-library analog) -------------------


class LambdaGate(Gate):
    def __init__(self, fn: Callable[[Any, Params], bool], name: str = "LambdaGate"):
        self._fn = fn
        self._name = name

    @property
    def name(self):
        return self._name

    def should_continue(self, query, params):
        return self._fn(query, params)


class DedupSelector(Selector):
    """≡ PickFirstCandidateMerger dedup (ScoredTweets…Config:463-469)."""

    def select(self, query, candidates, params):
        seen = set()
        out = []
        for c in candidates:
            if c.id not in seen:
                seen.add(c.id)
                out.append(c)
        return out


class TopKScoreSelector(Selector):
    def __init__(self, k: int):
        self.k = k

    def select(self, query, candidates, params):
        ranked = sorted(
            candidates, key=lambda c: -(c.score if c.score is not None else 0.0)
        )
        return ranked[: self.k]


class PredicateFilter(Filter):
    def __init__(self, fn: Callable[[Any, Candidate, Params], bool], name: str):
        self._fn = fn
        self._name = name

    @property
    def name(self):
        return self._name

    def apply(self, query, candidates, params):
        kept, removed = [], []
        for c in candidates:
            (kept if self._fn(query, c, params) else removed).append(c)
        return FilterResult(kept, removed)
