"""Stock pipeline components — the product-mixer component library.

A host copy of ``the_algorithm_tpu/pipeline/component_library.py`` (that
module's package imports JAX).

≡ ``product-mixer/component-library/src/main/scala/.../component_library/
{gate,filter,selector}/`` (the shared catalog every product pipeline
composes from). Each class mirrors one reference file (named in its
docstring); they operate on the framework's duck-typed query/Candidate
model (``pipeline/component.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from the_algorithm_tpu_torch.core.config import Param
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    Filter,
    FilterResult,
    Gate,
    Selector,
)

# Twitter snowflake epoch (ms): ids encode creation time in the top bits.
SNOWFLAKE_EPOCH_MS = 1288834974657


def snowflake_creation_ms(tweet_id: int) -> int:
    """≡ ``SnowflakeId.unixTimeMillisFromId`` — creation time from the id."""
    return (int(tweet_id) >> 22) + SNOWFLAKE_EPOCH_MS


# -- gates ----------------------------------------------------------------------


class DefinedUserIdGate(Gate):
    """≡ ``DefinedUserIdGate.scala`` — stop for logged-out requests."""

    def should_continue(self, query, params) -> bool:
        return getattr(query, "user_id", None) is not None


class DefinedCountryCodeGate(Gate):
    """≡ ``DefinedCountryCodeGate.scala``."""

    def should_continue(self, query, params) -> bool:
        return bool(getattr(query, "country_code", None))


class FirstPageGate(Gate):
    """≡ ``FirstPageGate.scala`` — run only on non-cursored requests."""

    def should_continue(self, query, params) -> bool:
        return getattr(query, "cursor", None) in (None, 0, "")

class FeatureGate(Gate):
    """≡ ``FeatureGate.scala`` — continue iff a query feature is truthy."""

    def __init__(self, feature: str, name: Optional[str] = None):
        self._feature = feature
        self._name = name or f"FeatureGate[{feature}]"

    @property
    def name(self):
        return self._name

    def should_continue(self, query, params) -> bool:
        return bool(query.features.get(self._feature))


class ParamGate(Gate):
    """≡ the param-gated gate pattern — continue iff the Param resolves
    truthy (experiment-bucketed via the config system)."""

    def __init__(self, param: Param):
        self._param = param

    @property
    def name(self):
        return f"ParamGate[{self._param.name}]"

    def should_continue(self, query, params) -> bool:
        return bool(params(self._param))


class QualityFactorGate(Gate):
    """≡ ``QualityFactorGate.scala`` — stop optional pipelines when the
    engine's quality factor has degraded below a floor."""

    def __init__(self, min_quality: float = 0.5):
        self._min = min_quality

    def should_continue(self, query, params) -> bool:
        qf = query.features.get("quality_factor", 1.0)
        return float(qf) >= self._min


# -- filters --------------------------------------------------------------------


def _split(candidates, keep_fn):
    kept, removed = [], []
    for c in candidates:
        (kept if keep_fn(c) else removed).append(c)
    return FilterResult(kept, removed)


class ExcludedIdsFilter(Filter):
    """≡ ``ExcludedIdsFilter.scala`` — drop request-scoped excluded ids."""

    def apply(self, query, candidates, params):
        excluded = set(getattr(query, "excluded_ids", ()) or ())
        return _split(candidates, lambda c: c.id not in excluded)


class FeatureFilter(Filter):
    """≡ ``FeatureFilter.scala`` — keep candidates whose bool feature is
    true (or false, when inverted)."""

    def __init__(self, feature: str, keep_if: bool = True,
                 name: Optional[str] = None):
        self._feature = feature
        self._keep_if = keep_if
        self._name = name or f"FeatureFilter[{feature}]"

    @property
    def name(self):
        return self._name

    def apply(self, query, candidates, params):
        return _split(
            candidates,
            lambda c: bool(c.features.get(self._feature)) == self._keep_if,
        )


class FeatureValueConditionalFilter(Filter):
    """≡ ``FeatureValueConditionalFilter.scala`` — keep iff fn(value)."""

    def __init__(self, feature: str, condition: Callable[[Any], bool],
                 missing_ok: bool = False):
        self._feature = feature
        self._cond = condition
        self._missing_ok = missing_ok

    def apply(self, query, candidates, params):
        def keep(c):
            v = c.features.get(self._feature)
            if v is None:
                return self._missing_ok
            return self._cond(v)

        return _split(candidates, keep)


class HasAuthorIdFeatureFilter(Filter):
    """≡ ``HasAuthorIdFeatureFilter.scala``."""

    def apply(self, query, candidates, params):
        return _split(
            candidates, lambda c: c.features.get("author_id") is not None
        )


class ParamGatedFilter(Filter):
    """≡ ``ParamGatedFilter.scala`` — run the inner filter only when the
    Param is on (otherwise pass everything through)."""

    def __init__(self, param: Param, inner: Filter):
        self._param = param
        self._inner = inner

    @property
    def name(self):
        return f"ParamGated[{self._inner.name}]"

    def apply(self, query, candidates, params):
        if not params(self._param):
            return FilterResult(list(candidates), [])
        return self._inner.apply(query, candidates, params)


class SnowflakeIdAgeFilter(Filter):
    """≡ ``SnowflakeIdAgeFilter.scala`` — drop tweets older than max age,
    deriving creation time from the snowflake id itself."""

    def __init__(self, max_age_ms: int):
        self._max_age_ms = max_age_ms

    def apply(self, query, candidates, params):
        now_ms = int(getattr(query, "now", 0)) * 1000
        return _split(
            candidates,
            lambda c: now_ms - snowflake_creation_ms(c.id) <= self._max_age_ms,
        )


class TweetAuthorIsSelfFilter(Filter):
    """≡ ``TweetAuthorIsSelfFilter.scala`` — drop the viewer's own tweets."""

    def apply(self, query, candidates, params):
        uid = getattr(query, "user_id", None)
        return _split(
            candidates, lambda c: c.features.get("author_id") != uid
        )


class TweetIsNotReplyFilter(Filter):
    """≡ ``TweetIsNotReplyFilter.scala``."""

    def apply(self, query, candidates, params):
        return _split(candidates, lambda c: not c.features.get("is_reply"))


class TweetLanguageFilter(Filter):
    """≡ ``TweetLanguageFilter.scala`` — candidate language ∈ the viewer's
    understood languages (missing language passes)."""

    def apply(self, query, candidates, params):
        langs = getattr(query, "languages", None)

        def keep(c):
            lang = c.features.get("language")
            return lang is None or not langs or lang in langs

        return _split(candidates, keep)


class TweetAuthorCountryFilter(Filter):
    """≡ ``TweetAuthorCountryFilter.scala`` + the takedown store: drop
    tweets withheld in the viewer's country."""

    def __init__(self, takedowns):  # storage.tweetypie.TakedownStore
        self._takedowns = takedowns

    def apply(self, query, candidates, params):
        country = getattr(query, "country_code", None)
        return _split(
            candidates,
            lambda c: not self._takedowns.is_withheld(c.id, country),
        )


class BloomFilterDedupFilter(Filter):
    """≡ ``AdaptiveLongIntBloomFilterDedupFilter.scala`` — drop candidates
    whose id hits the viewer's impression bloom filter."""

    def __init__(self, filters: Dict[int, Any]):  # user_id -> BloomFilter
        self._filters = filters

    def apply(self, query, candidates, params):
        bf = self._filters.get(getattr(query, "user_id", None))
        if bf is None:
            return FilterResult(list(candidates), [])
        return _split(candidates, lambda c: c.id not in bf)


# -- selectors ------------------------------------------------------------------


class DropDuplicateCandidates(Selector):
    """≡ ``DropDuplicateCandidates.scala`` — first-wins dedup by a
    DeduplicationKey fn (default: candidate id)."""

    def __init__(self, key_fn: Callable[[Candidate], Any] = lambda c: c.id):
        self._key_fn = key_fn

    def select(self, query, candidates, params):
        seen, out = set(), []
        for c in candidates:
            k = self._key_fn(c)
            if k not in seen:
                seen.add(k)
                out.append(c)
        return out


class DropMaxCandidates(Selector):
    """≡ ``DropMaxCandidates.scala`` / ``DropMaxResults.scala`` — truncate,
    optionally by a Param."""

    def __init__(self, max_candidates: Optional[int] = None,
                 param: Optional[Param] = None):
        assert (max_candidates is None) != (param is None)
        self._max = max_candidates
        self._param = param

    def select(self, query, candidates, params):
        n = self._max if self._max is not None else int(params(self._param))
        return list(candidates)[:n]


class DropTooFewResults(Selector):
    """≡ ``DropTooFewResults.scala`` — all-or-nothing minimum size (a
    module that can't fill its slot renders nothing)."""

    def __init__(self, min_results: int):
        self._min = min_results

    def select(self, query, candidates, params):
        return list(candidates) if len(candidates) >= self._min else []


class InsertAppendResults(Selector):
    """≡ ``InsertAppendResults.scala`` — append a fixed candidate list
    (promoted modules, who-to-follow inserts) after the organic results."""

    def __init__(self, extra_fn: Callable[[Any], List[Candidate]]):
        self._extra_fn = extra_fn

    def select(self, query, candidates, params):
        out = list(candidates)
        seen = {c.id for c in out}
        for c in self._extra_fn(query):
            if c.id not in seen:
                out.append(c)
        return out


class SortCandidates(Selector):
    """≡ ``UpdateSortCandidates`` — order by a key fn (default: score)."""

    def __init__(self, key_fn: Callable[[Candidate], float] = None,
                 descending: bool = True):
        self._key_fn = key_fn or (
            lambda c: c.score if c.score is not None else float("-inf")
        )
        self._desc = descending

    def select(self, query, candidates, params):
        return sorted(candidates, key=self._key_fn, reverse=self._desc)


class DropOrthogonalCandidates(Selector):
    """≡ ``DropOrthogonalCandidates.scala`` — drop candidates that appear
    in another pipeline's results (cross-pipeline dedup by source rank)."""

    def __init__(self, other_results_fn: Callable[[Any], Sequence[Candidate]]):
        self._other = other_results_fn

    def select(self, query, candidates, params):
        taken = {c.id for c in self._other(query)}
        return [c for c in candidates if c.id not in taken]
