"""URT (Unified Rich Timeline) entities, decorators, and the marshaller.

A host copy of ``the_algorithm_tpu/pipeline/urt.py`` (that module's
package imports JAX).

≡ ``product-mixer/component-library/.../decorator/urt/`` +
``premarshaller/urt/``: the mixer's selected entries are *decorated* into
typed URT items (tweet / user / ad items with social context, interstitial
covers, promoted metadata), grouped into timeline modules with
headers/footers, and *marshalled* into the instruction-based wire response
(AddEntries / ReplaceEntry / ShowAlert / TerminateTimeline + cursors) the
clients render (``UrtItemCandidateDecorator.scala``,
``UrtItemInModuleDecorator.scala``, ``builder/social_context/
FeatureSocialContextBuilder.scala``).

Host-side response marshalling — no device work; the typed layer sits
between :mod:`the_algorithm_tpu_torch.pipeline.mixer` output and the HTTP edge.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

from the_algorithm_tpu_torch.pipeline.mixer import (
    EntryKind,
    Instruction,
    Timeline,
    TimelineEntry,
)

# -- URT items ----------------------------------------------------------------


@dataclasses.dataclass
class SocialContext:
    """≡ GeneralModuleSocialContextBuilder / FeatureSocialContextBuilder
    output: the "Liked by people you follow" line over an item."""

    context_type: str  # "social_proof" | "topic" | "followed_by" | ...
    text: str
    user_ids: Sequence[int] = ()

    def to_dict(self) -> Dict[str, Any]:
        return {"contextType": self.context_type, "text": self.text,
                "userIds": [int(u) for u in self.user_ids]}


@dataclasses.dataclass
class UrtItem:
    """Base content item (≡ TimelineItem subtypes under builder/item/)."""

    item_type: str
    id: int
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    social_context: Optional[SocialContext] = None
    interstitial: Optional[str] = None  # cover reason (visibility)
    promoted_metadata: Optional[Dict[str, Any]] = None  # ads

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"itemType": self.item_type, "id": int(self.id)}
        if self.metadata:
            out["metadata"] = self.metadata
        if self.social_context is not None:
            out["socialContext"] = self.social_context.to_dict()
        if self.interstitial is not None:
            out["interstitial"] = {"reason": self.interstitial}
        if self.promoted_metadata is not None:
            out["promotedMetadata"] = self.promoted_metadata
        return out


# -- timeline entries ---------------------------------------------------------


@dataclasses.dataclass
class UrtEntry:
    entry_id: str
    sort_index: int

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError


@dataclasses.dataclass
class ItemEntry(UrtEntry):
    item: UrtItem = None

    def to_dict(self):
        return {"entryId": self.entry_id, "sortIndex": self.sort_index,
                "content": {"kind": "item", "item": self.item.to_dict()}}


@dataclasses.dataclass
class ModuleEntry(UrtEntry):
    """≡ TimelineModule with display type + header/footer
    (UrtMultipleModulesDecorator / module header-footer builders)."""

    display_type: str = "vertical"  # "vertical" | "carousel" | "conversation"
    header: Optional[str] = None
    footer: Optional[str] = None
    items: List[UrtItem] = dataclasses.field(default_factory=list)

    def to_dict(self):
        mod: Dict[str, Any] = {
            "displayType": self.display_type,
            "items": [i.to_dict() for i in self.items],
        }
        if self.header:
            mod["header"] = {"text": self.header}
        if self.footer:
            mod["footer"] = {"text": self.footer}
        return {"entryId": self.entry_id, "sortIndex": self.sort_index,
                "content": {"kind": "module", "module": mod}}


@dataclasses.dataclass
class CursorEntry(UrtEntry):
    cursor_type: str = "bottom"  # "top" | "bottom"
    value: str = ""

    def to_dict(self):
        return {"entryId": self.entry_id, "sortIndex": self.sort_index,
                "content": {"kind": "cursor",
                            "cursorType": self.cursor_type,
                            "value": self.value}}


# -- wire instructions --------------------------------------------------------


@dataclasses.dataclass
class UrtInstruction:
    op: str  # addEntries | replaceEntry | showAlert | clearCache | terminate
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self):
        return {self.op: self.payload}


@dataclasses.dataclass
class UrtTimelineResponse:
    instructions: List[UrtInstruction]

    def to_dict(self):
        return {"timeline": {
            "instructions": [i.to_dict() for i in self.instructions]}}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def entries(self) -> List[Dict[str, Any]]:
        for ins in self.instructions:
            if ins.op == "addEntries":
                return ins.payload["entries"]
        return []


# -- decorators ---------------------------------------------------------------


class FeatureSocialContextBuilder:
    """≡ ``FeatureSocialContextBuilder.scala``: build the context line from
    candidate features — social proof counts, topic attribution, or the
    followed-by relation."""

    def __call__(self, candidate) -> Optional[SocialContext]:
        f = candidate.features
        proof = f.get("social_proof")
        if proof:
            n = int(proof)
            return SocialContext(
                "social_proof",
                f"Liked by {n} {'person' if n == 1 else 'people'} you follow",
                user_ids=f.get("social_proof_user_ids", ()),
            )
        topic = f.get("topic_name") or f.get("topic_id")
        if f.get("topic_relevance") and topic is not None:
            return SocialContext("topic", f"Based on your interest: {topic}")
        if f.get("author_follows_viewer"):
            return SocialContext("followed_by", "Follows you")
        return None


class UrtItemCandidateDecorator:
    """candidate → :class:`UrtItem` (≡ ``UrtItemCandidateDecorator.scala``).

    ``item_type`` picks the builder family (builder/item/{tweet,user,ad});
    the social-context builder and visibility interstitials ride along.
    """

    def __init__(self, item_type: str = "tweet",
                 social_context_builder=None):
        self.item_type = item_type
        self.social_context = (social_context_builder
                               or FeatureSocialContextBuilder())

    def __call__(self, candidate) -> UrtItem:
        f = candidate.features
        meta: Dict[str, Any] = {}
        if candidate.score is not None:
            meta["score"] = float(candidate.score)
        if candidate.source:
            meta["source"] = str(candidate.source)
        if f.get("author_id") is not None:
            meta["authorId"] = int(f["author_id"])
        return UrtItem(
            item_type=self.item_type,
            id=int(candidate.id),
            metadata=meta,
            social_context=self.social_context(candidate),
            interstitial=f.get("visibility_interstitial"),
            promoted_metadata=(
                {"advertiserId": int(f.get("advertiser_id", 0)),
                 "disclosureType": "ad"}
                if candidate.source == "ads" or f.get("promoted") else None),
        )


class UrtItemInModuleDecorator:
    """module → :class:`ModuleEntry` (≡ ``UrtItemInModuleDecorator.scala``):
    decorate each member candidate, attach module chrome."""

    _DISPLAY = {"conversation": "conversation", "who_to_follow": "vertical",
                "carousel": "carousel"}

    def __init__(self, tweet_decorator=None, user_decorator=None):
        self.tweet_decorator = tweet_decorator or UrtItemCandidateDecorator()
        self.user_decorator = (user_decorator
                               or UrtItemCandidateDecorator(item_type="user"))

    def __call__(self, module, entry_id: str, sort_index: int) -> ModuleEntry:
        dec = (self.user_decorator if module.item_kind == "user"
               else self.tweet_decorator)
        return ModuleEntry(
            entry_id=entry_id,
            sort_index=sort_index,
            display_type=self._DISPLAY.get(module.kind, "vertical"),
            header=module.header,
            items=[dec(c) for c in module.items],
        )


# -- the marshaller -----------------------------------------------------------


class UrtTimelineMarshaller:
    """mixer :class:`Timeline` → :class:`UrtTimelineResponse`
    (≡ the URT premarshaller: sort-index allocation, entry ids, cursor
    entries, and the instruction envelope)."""

    def __init__(self, tweet_decorator=None, module_decorator=None,
                 sort_index_step: int = 10):
        self.tweet_decorator = tweet_decorator or UrtItemCandidateDecorator()
        self.module_decorator = module_decorator or UrtItemInModuleDecorator(
            tweet_decorator=self.tweet_decorator)
        self.step = sort_index_step

    def _entry(self, e: TimelineEntry, sort_index: int) -> UrtEntry:
        if e.kind == EntryKind.MODULE and e.module is not None:
            mod_id = (max((c.id for c in e.module.items), default=0))
            return self.module_decorator(
                e.module, f"module-{e.module.kind}-{mod_id}", sort_index)
        item = self.tweet_decorator(e.candidate)
        if e.kind == EntryKind.AD:
            if item.promoted_metadata is None:
                item.promoted_metadata = {"disclosureType": "ad"}
            return ItemEntry(f"promoted-tweet-{e.candidate.id}", sort_index,
                             item=item)
        return ItemEntry(f"tweet-{e.candidate.id}", sort_index, item=item)

    def marshal(self, timeline: Timeline) -> UrtTimelineResponse:
        n = len(timeline.entries)
        # descending sort indexes, newest/top first (URT clients order by
        # sortIndex descending; leave headroom for cursors)
        top_index = (n + 2) * self.step
        entries: List[UrtEntry] = []
        for i, e in enumerate(timeline.entries):
            entries.append(self._entry(e, top_index - (i + 1) * self.step))

        if timeline.top_cursor is not None:
            entries.insert(0, CursorEntry(
                "cursor-top", top_index, cursor_type="top",
                value=str(timeline.top_cursor)))
        if timeline.bottom_cursor is not None:
            entries.append(CursorEntry(
                "cursor-bottom", 0, cursor_type="bottom",
                value=str(timeline.bottom_cursor)))

        instructions = [UrtInstruction(
            "addEntries", {"entries": [e.to_dict() for e in entries]})]
        for ins in timeline.instructions:
            instructions.append(self._wire_instruction(ins))
        return UrtTimelineResponse(instructions=instructions)

    @staticmethod
    def _wire_instruction(ins: Instruction) -> UrtInstruction:
        if ins.op == "replace_entry":
            return UrtInstruction("replaceEntry", {
                "entryIdToReplace": f"tweet-{ins.payload['entry_id']}",
                "withTweetId": int(ins.payload["with"]),
            })
        if ins.op == "show_alert":
            return UrtInstruction("showAlert", dict(ins.payload))
        if ins.op == "clear_cache":
            return UrtInstruction("clearCache", {})
        if ins.op == "navigate":
            return UrtInstruction("navigate", dict(ins.payload))
        return UrtInstruction(ins.op, dict(ins.payload))


def marshal_timeline(timeline: Timeline, **kw) -> UrtTimelineResponse:
    """One-call decoration + marshalling of a mixer product's output."""
    return UrtTimelineMarshaller(**kw).marshal(timeline)
