"""Mixer pipeline: heterogeneous timeline construction.

A host copy of ``the_algorithm_tpu/pipeline/mixer.py`` (that module's
package imports JAX).

≡ ``product-mixer/core/.../pipeline/mixer/MixerPipelineConfig.scala`` plus the
URT premarshaller layer (``component-library/premarshaller/urt/``): a mixer
pipeline runs several candidate pipelines producing *different kinds* of
results — primary tweets, grouped modules (conversations, who-to-follow),
injected ads, prompts — then position-aware selectors weave them into one
ordered timeline with cursors and client instructions
(``FollowingMixerPipelineConfig.scala``,
``ListTweetsMixerPipelineConfig.scala``).

The engine here is deliberately host-side Python — it orchestrates; any hot
math (search scoring, module ranking) lives in the batched sources it calls.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence

from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    CandidatePipeline,
    Gate,
    SideEffect,
)


class EntryKind(enum.Enum):
    """What a timeline entry is — drives positioning + client rendering."""

    TWEET = "tweet"
    MODULE = "module"
    AD = "ad"
    PROMPT = "prompt"


@dataclasses.dataclass
class Module:
    """A named group of candidates rendered as one timeline module
    (≡ URT ``TimelineModule``: conversation threads, who-to-follow)."""

    kind: str  # e.g. "conversation", "who_to_follow"
    items: List[Candidate]
    header: Optional[str] = None
    item_kind: str = "tweet"  # "tweet" | "user" — what the items are


@dataclasses.dataclass
class TimelineEntry:
    kind: EntryKind
    candidate: Optional[Candidate] = None  # TWEET / AD / PROMPT
    module: Optional[Module] = None  # MODULE

    @property
    def sort_id(self) -> int:
        if self.candidate is not None:
            return self.candidate.id
        if self.module and self.module.items:
            return max(c.id for c in self.module.items)
        return 0


@dataclasses.dataclass
class Instruction:
    """Client instruction (≡ URT instruction builders:
    ShowAlert / ReplaceEntry / ClearCache / Navigation)."""

    op: str  # "show_alert" | "replace_entry" | "clear_cache" | "navigate"
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Timeline:
    """The marshalled response (≡ URT ``Timeline``)."""

    entries: List[TimelineEntry]
    instructions: List[Instruction] = dataclasses.field(default_factory=list)
    top_cursor: Optional[int] = None
    bottom_cursor: Optional[int] = None

    def tweet_ids(self) -> List[int]:
        out = []
        for e in self.entries:
            if e.kind == EntryKind.TWEET and e.candidate is not None:
                out.append(e.candidate.id)
            elif e.module is not None and e.module.item_kind == "tweet":
                out.extend(c.id for c in e.module.items)
        return out


# -- mixer result pipelines ---------------------------------------------------


@dataclasses.dataclass
class MixerCandidatePipeline:
    """A candidate pipeline tagged with how its results enter the timeline.

    ``kind``: what entries it produces.  ``to_entries`` lets a pipeline emit
    modules (e.g. the conversation service groups several candidates into one
    module) — default wraps each candidate as one entry of ``kind``.
    ``instruction_only``: results become :class:`Instruction`s, not entries
    (edited-tweets → replace_entry; new-tweets pill → show_alert).
    """

    pipeline: CandidatePipeline
    kind: EntryKind = EntryKind.TWEET
    grouper: Optional[Any] = None  # Callable[[query, List[Candidate]], List[TimelineEntry]]
    instruction_builder: Optional[Any] = None  # Callable[[query, List[Candidate]], List[Instruction]]

    @property
    def name(self) -> str:
        return self.pipeline.name


# -- position-aware selectors -------------------------------------------------


class EntrySelector:
    """Selector over the heterogeneous entry list (vs candidate Selector)."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def select(
        self, query: Any, entries: List[TimelineEntry], params: Params
    ) -> List[TimelineEntry]:
        raise NotImplementedError


class SortByRecency(EntrySelector):
    """Reverse-chron primary ordering (snowflake ids are time-ordered) —
    the Following/ListTweets ordering (``UpdateSortCandidates`` + recency)."""

    def select(self, query, entries, params):
        primary = [e for e in entries if e.kind == EntryKind.TWEET]
        rest = [e for e in entries if e.kind != EntryKind.TWEET]
        primary.sort(key=lambda e: -e.sort_id)
        return primary + rest


class SortModulesByRecency(EntrySelector):
    """Interleave modules among tweets by their newest item's id."""

    def select(self, query, entries, params):
        placed = [e for e in entries if e.kind in (EntryKind.TWEET, EntryKind.MODULE)]
        rest = [e for e in entries if e.kind not in (EntryKind.TWEET, EntryKind.MODULE)]
        placed.sort(key=lambda e: -e.sort_id)
        return placed + rest


class InsertFixedPositionModule(EntrySelector):
    """Place entries of ``kind`` at a fixed position
    (≡ ``InsertFixedPositionResults`` — the WTF module slot)."""

    def __init__(self, kind: EntryKind, position: int, module_kind: Optional[str] = None):
        self.kind = kind
        self.position = position
        self.module_kind = module_kind

    def _matches(self, e: TimelineEntry) -> bool:
        if e.kind != self.kind:
            return False
        return self.module_kind is None or (
            e.module is not None and e.module.kind == self.module_kind
        )

    def select(self, query, entries, params):
        movable = [e for e in entries if self._matches(e)]
        others = [e for e in entries if not self._matches(e)]
        pos = min(self.position, len(others))
        return others[:pos] + movable + others[pos:]


class InsertAdResults(EntrySelector):
    """Weave AD entries into the stream with a minimum organic spacing
    (≡ ``selector/ads/{AdsInjector,InsertAdResults}.scala``)."""

    def __init__(self, min_spacing: int = 4, first_position: int = 2, max_ads: int = 4):
        self.min_spacing = min_spacing
        self.first_position = first_position
        self.max_ads = max_ads

    def select(self, query, entries, params):
        ads = [e for e in entries if e.kind == EntryKind.AD][: self.max_ads]
        organic = [e for e in entries if e.kind != EntryKind.AD]
        if not ads:
            return organic
        out: List[TimelineEntry] = []
        next_slot = self.first_position
        ai = 0
        for e in organic:
            while ai < len(ads) and len(out) == next_slot:
                out.append(ads[ai])
                ai += 1
                next_slot = len(out) + self.min_spacing
            out.append(e)
        # ads that found no spacing-respecting slot are dropped, never
        # appended back-to-back at the tail (the reference AdsInjector drops
        # unplaceable ads rather than violating min_spacing)
        return out


class DropMaxModuleItemCandidates(EntrySelector):
    """Truncate each module to at most N items
    (≡ ``DropMaxModuleItemCandidates``)."""

    def __init__(self, max_items: int, module_kind: Optional[str] = None):
        self.max_items = max_items
        self.module_kind = module_kind

    def select(self, query, entries, params):
        out = []
        for e in entries:
            if e.module is not None and (
                self.module_kind is None or e.module.kind == self.module_kind
            ) and len(e.module.items) > self.max_items:
                # rebuild rather than truncate in place — module objects may
                # be shared with the source pipeline's own result lists
                out.append(dataclasses.replace(
                    e,
                    module=dataclasses.replace(
                        e.module, items=e.module.items[: self.max_items]
                    ),
                ))
            else:
                out.append(e)
        return out


class DropModuleTooFewItems(EntrySelector):
    """Remove modules below a minimum size
    (≡ ``DropModuleTooFewModuleItemResults``)."""

    def __init__(self, min_items: int, module_kind: Optional[str] = None):
        self.min_items = min_items
        self.module_kind = module_kind

    def select(self, query, entries, params):
        out = []
        for e in entries:
            if e.module is not None and (
                self.module_kind is None or e.module.kind == self.module_kind
            ):
                if len(e.module.items) < self.min_items:
                    continue
            out.append(e)
        return out


class DropMaxEntries(EntrySelector):
    """Server max-results truncation (≡ ``DropMaxCandidates`` with
    ``ServerMaxResultsParam``), preserving non-tweet entries already woven."""

    def __init__(self, max_entries: int):
        self.max_entries = max_entries

    def select(self, query, entries, params):
        return entries[: self.max_entries]


# -- the mixer engine ---------------------------------------------------------


@dataclasses.dataclass
class MixerPipeline:
    """gates → query hydration → candidate pipelines → entry selectors →
    cursors/instructions → side effects (step order per
    ``MixerPipelineConfig.scala``)."""

    candidate_pipelines: Sequence[MixerCandidatePipeline]
    gates: Sequence[Gate] = ()
    query_hydrators: Sequence[Any] = ()
    entry_selectors: Sequence[EntrySelector] = ()
    side_effects: Sequence[SideEffect] = ()
    stats: Any = None

    def _count(self, name: str, n: int = 1) -> None:
        # the JAX package calls ``.incr(n)`` on what ``counter`` returns
        # (None) and so raises on the first count; the port counts
        if self.stats is not None:
            self.stats.counter(name, n)

    def run(self, query: Any, params: Optional[Params] = None) -> Timeline:
        params = params if params is not None else Params()
        for g in self.gates:
            if not g.should_continue(query, params):
                self._count(f"mixer/gate_stopped/{g.name}")
                return Timeline(entries=[])
        for qh in self.query_hydrators:
            feats = qh.hydrate(query, params)
            if feats:
                if getattr(query, "features", None) is None:
                    # never .update() an anonymous default — hydrated
                    # features would be silently discarded
                    query.features = dict(feats)
                else:
                    query.features.update(feats)

        entries: List[TimelineEntry] = []
        instructions: List[Instruction] = []
        for mcp in self.candidate_pipelines:
            cp = mcp.pipeline
            try:
                cands = cp.source.get(query, params)
            except Exception:
                if not cp.fail_open:
                    raise
                self._count(f"mixer/pipeline_failed/{mcp.name}")
                continue
            for h in cp.hydrators:
                h.hydrate(query, cands, params)
            for f in cp.filters:
                cands = f.apply(query, cands, params).kept
            self._count(f"mixer/candidates/{mcp.name}", len(cands))
            if mcp.instruction_builder is not None:
                instructions.extend(mcp.instruction_builder(query, cands))
            elif mcp.grouper is not None:
                entries.extend(mcp.grouper(query, cands))
            else:
                entries.extend(
                    TimelineEntry(kind=mcp.kind, candidate=c) for c in cands
                )

        for sel in self.entry_selectors:
            entries = sel.select(query, entries, params)

        tl = Timeline(entries=entries, instructions=instructions)
        tweet_ids = [e.sort_id for e in entries if e.kind == EntryKind.TWEET]
        if tweet_ids:
            # ordered top/bottom cursors over the primary tweet ids
            # (≡ OrderedTopCursorBuilder / OrderedBottomCursorBuilder with
            # TweetIdSelector)
            tl.top_cursor = max(tweet_ids)
            tl.bottom_cursor = min(tweet_ids)
        for se in self.side_effects:
            try:
                se.run(query, entries, params)
            except Exception:
                self._count(f"mixer/side_effect_failed/{se.name}")
        return tl
