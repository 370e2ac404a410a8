"""Home-mixer non-ranked products: Following, Subscribed, ListTweets,
ListRecommendedUsers — plus the product registry.

≡ ``home-mixer/server/.../product/{following,subscribed,list_tweets,
list_recommended_users}/`` and ``HomeProductPipelineRegistryConfig.scala``.
The For You ranked product lives in :mod:`home_mixer`; these products are
reverse-chron mixer pipelines over the earlybird index (author allow-list +
cursor window queries, ``FollowingEarlybirdQueryTransformer.scala``), with
conversation-module grouping, a who-to-follow module at a fixed slot, ads
injection, edited-tweet replace instructions and the new-tweets pill alert
(``FollowingMixerPipelineConfig.scala``).

Counterpart of ``the_algorithm_tpu/mixers/home_products.py`` (host code over
the port's earlybird index, which runs its scans where the index lives).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from the_algorithm_tpu_torch.core.config import Param
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    CandidatePipeline,
    CandidateSource,
)
from the_algorithm_tpu_torch.pipeline.mixer import (
    DropMaxEntries,
    DropMaxModuleItemCandidates,
    DropModuleTooFewItems,
    EntryKind,
    InsertAdResults,
    InsertFixedPositionModule,
    Instruction,
    MixerCandidatePipeline,
    MixerPipeline,
    Module,
    SortModulesByRecency,
    TimelineEntry,
)
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.search import earlybird

# quality-tier experiment param: force a request into (True) or out of
# (False) the EXACT full-corpus retrieval tier; None defers to the sticky
# ``exact_retrieval_tier`` decider dial (the configapi FSParam pattern:
# experiment-bucketed per-request override over a fleet availability)
EXACT_RETRIEVAL_TIER: Param = Param("exact_retrieval_tier", None)


@dataclasses.dataclass
class TimelineQuery:
    """Shared query shape for the chron products (≡ FollowingQuery /
    SubscribedQuery / ListTweetsQuery). Cursoring is by tweet-id window:
    ``since_id`` (top cursor — newer than) / ``max_id`` (bottom cursor —
    older than), per ``FollowingEarlybirdQueryTransformer.scala:40-52``."""

    user_id: int
    followed_authors: Sequence[int] = ()
    subscribed_authors: Sequence[int] = ()
    list_id: Optional[int] = None
    since_id: Optional[int] = None
    max_id: Optional[int] = None
    last_polling_ts: Optional[int] = None
    served_tweet_ids: Sequence[int] = ()
    max_results: int = 40
    now: int = 1 << 30
    features: Dict[str, object] = dataclasses.field(default_factory=dict)


# -- candidate sources --------------------------------------------------------


class AuthorListEarlybirdSource(CandidateSource):
    """Reverse-chron earlybird fetch restricted to an author allow-list
    (≡ ``FollowingEarlybirdCandidatePipelineConfig`` — a match-all query
    with FEATURE_VALUE_IN_ACCEPT_LIST author operand + SINCE_ID/MAX_ID)."""

    def __init__(self, index: earlybird.EarlybirdIndex,
                 authors_of=lambda q: q.followed_authors,
                 include_self: bool = True,
                 name: str = "FollowingEarlybird"):
        self.index = index
        self.authors_of = authors_of
        self.include_self = include_self
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query: TimelineQuery, params) -> List[Candidate]:
        authors = list(self.authors_of(query))
        if self.include_self:
            authors.append(query.user_id)
        if not authors:
            return []
        dev = self.index.tweet_ids.device
        follows = torch.tensor(sorted(set(int(a) for a in authors)),
                               dtype=torch.int32, device=dev)
        # the cursor window is pushed INTO the index scan (SINCE_ID/MAX_ID
        # operands) and the fetch ranks by recency, so the newest matching
        # tweets are never crowded out of the result window by older ones
        # (rankingMode=Recency, ``FollowingEarlybirdQueryTransformer``)
        q = earlybird.SearchQuery(
            tokens=torch.full((1,), int(PAD_ID), dtype=torch.int32,
                              device=dev),  # match-all
            require_all=True,
            min_ts=0,
            max_ts=int(query.now),
            followed_authors=follows,
            min_id=None if query.since_id is None else int(query.since_id),
            max_id=None if query.max_id is None else int(query.max_id),
        )
        ids, _ = earlybird.search(self.index, q, rank_by="recency",
                                  max_results=max(query.max_results, 8))
        # each id's last ring slot (the JAX package's id → slot dict keeps
        # the last), its author and creation time: read on the index's
        # device, the few result rows copied to the host
        T = self.index.tweet_ids.shape[0]
        hit = self.index.tweet_ids[None, :] == ids[:, None]  # [X, T]
        slot = (T - 1) - torch.argmax(hit.flip(1).to(torch.int8), dim=1)
        ids = ids.cpu().numpy()
        authors_arr = self.index.author[slot].cpu().numpy()
        ts = self.index.created_ts[slot].cpu().numpy()
        out = []
        for i, tid in enumerate(ids):
            tid = int(tid)
            if tid == int(PAD_ID):
                continue
            out.append(Candidate(
                id=tid,
                source=self._name,
                features={
                    "author_id": int(authors_arr[i]),
                    "created_ts": int(ts[i]),
                    "in_network": True,
                },
            ))
        out.sort(key=lambda c: -c.id)
        return out[: query.max_results]


class ListMembersSource(CandidateSource):
    """List timeline fetch: tweets by the list's members
    (≡ ``ListTweetsTimelineServiceCandidatePipelineConfig`` —
    TimelineType.List through timelineservice; here the device index is the
    timeline store, restricted to the list membership)."""

    def __init__(self, index: earlybird.EarlybirdIndex,
                 list_members: Dict[int, Sequence[int]]):
        self.inner = AuthorListEarlybirdSource(
            index,
            authors_of=lambda q: list_members.get(q.list_id, ()),
            include_self=False,
            name="ListTweetsTimelineService",
        )

    @property
    def name(self):
        return "ListTweetsTimelineService"

    def get(self, query, params):
        return self.inner.get(query, params)


class WhoToFollowModuleSource(CandidateSource):
    """Runs an FRS flow and wraps results for the WTF module slot
    (≡ ``FollowingWhoToFollowCandidatePipelineConfigBuilder`` →
    ``who_to_follow_module/WhoToFollowArmCandidatePipelineConfig``)."""

    def __init__(self, flow, request_of=lambda q: q):
        self.flow = flow
        self.request_of = request_of

    @property
    def name(self):
        return "WhoToFollowModule"

    def get(self, query, params) -> List[Candidate]:
        return self.flow.run(self.request_of(query))


def who_to_follow_grouper(query, candidates: List[Candidate]) -> List[TimelineEntry]:
    if not candidates:
        return []
    return [TimelineEntry(
        kind=EntryKind.MODULE,
        module=Module(kind="who_to_follow", items=list(candidates),
                      header="Who to follow", item_kind="user"),
    )]


class ConversationGrouper:
    """Groups reply candidates with their ancestors into conversation
    modules (≡ ``ConversationServiceCandidatePipelineConfigBuilder`` +
    conversation-module decorator). Non-replies pass through as tweets."""

    def __init__(self, resolver, max_ancestors: int = 2):
        self.resolver = resolver  # storage.tweetypie.ConversationResolver
        self.max_ancestors = max_ancestors

    def __call__(self, query, candidates: List[Candidate]) -> List[TimelineEntry]:
        out: List[TimelineEntry] = []
        placed: set = set()  # ids already rendered inside an earlier module
        for c in candidates:
            if c.id in placed:
                continue
            chain = self.resolver(c)
            if len(chain) <= 1:
                out.append(TimelineEntry(kind=EntryKind.TWEET, candidate=c))
                continue
            placed.update(a.id for a in chain)
            ancestors = chain[:-1][-self.max_ancestors:]
            items = [
                Candidate(id=a.id, features=dict(a.features), source=c.source)
                for a in ancestors
            ] + [c]
            out.append(TimelineEntry(
                kind=EntryKind.MODULE,
                module=Module(kind="conversation", items=items),
            ))
        return out


class StaticAdsSource(CandidateSource):
    """Ad candidates from a host-side line-item store (the goldfinch /
    AdsCandidatePipelineBuilder role — external in the reference)."""

    def __init__(self, line_items: Sequence[Candidate]):
        self.line_items = list(line_items)

    @property
    def name(self):
        return "AdsCandidatePipeline"

    def get(self, query, params):
        return [Candidate(id=c.id, features=dict(c.features), source="ads")
                for c in self.line_items]


# -- instruction builders -----------------------------------------------------


class EditedTweetsInstructionBuilder:
    """Emits replace_entry instructions for served tweets that were edited
    (≡ ``EditedTweetsCandidatePipelineConfig``: candidates are the latest
    versions of previously-served stale tweets)."""

    def __init__(self, edit_chains):
        self.edit_chains = edit_chains  # storage.tweetypie.EditChainStore

    def __call__(self, query, _cands) -> List[Instruction]:
        out = []
        for tid in query.served_tweet_ids:
            if self.edit_chains.is_stale(tid):
                out.append(Instruction(
                    op="replace_entry",
                    payload={"entry_id": int(tid),
                             "with": int(self.edit_chains.latest(tid))},
                ))
        return out


class NewTweetsPillInstructionBuilder:
    """show_alert when in-network tweets newer than the last poll exist
    (≡ ``NewTweetsPillCandidatePipelineConfig`` +
    ``UpdateNewTweetsPillDecoration``)."""

    def __init__(self, index: earlybird.EarlybirdIndex, min_new: int = 1):
        self.index = index
        self.min_new = min_new

    def __call__(self, query, _cands) -> List[Instruction]:
        if query.last_polling_ts is None:
            return []
        authors = sorted(set(int(a) for a in query.followed_authors))
        index = self.index
        follows = torch.tensor(authors, dtype=torch.int64,
                               device=index.author.device)
        # in slot order, as the JAX package's loop over the ring
        fresh_mask = ((index.tweet_ids != int(PAD_ID))
                      & (index.created_ts.to(torch.int64) > int(query.last_polling_ts))
                      & torch.isin(index.author.to(torch.int64), follows))
        fresh = [int(a) for a in index.author[fresh_mask].cpu().numpy()]
        if len(fresh) >= self.min_new:
            return [Instruction(
                op="show_alert",
                payload={"kind": "new_tweets_pill",
                         "user_ids": sorted(set(fresh))[:3],
                         "count": len(fresh)},
            )]
        return []


# -- product pipeline builders ------------------------------------------------


def build_following_pipeline(
    *,
    index: earlybird.EarlybirdIndex,
    conversation_resolver=None,
    wtf_flow=None,
    ads: Sequence[Candidate] = (),
    edit_chains=None,
    wtf_position: int = 5,
    ad_spacing: int = 4,
    stats=None,
) -> MixerPipeline:
    """≡ ``FollowingMixerPipelineConfig`` (in-network reverse-chron)."""
    source = AuthorListEarlybirdSource(index)
    grouper = (ConversationGrouper(conversation_resolver)
               if conversation_resolver is not None else None)
    pipelines = [MixerCandidatePipeline(
        pipeline=CandidatePipeline(source=source),
        kind=EntryKind.TWEET,
        grouper=grouper,
    )]
    if wtf_flow is not None:
        pipelines.append(MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=WhoToFollowModuleSource(wtf_flow)),
            kind=EntryKind.MODULE,
            grouper=who_to_follow_grouper,
        ))
    if ads:
        pipelines.append(MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=StaticAdsSource(ads)),
            kind=EntryKind.AD,
        ))
    if edit_chains is not None:
        pipelines.append(MixerCandidatePipeline(
            pipeline=CandidatePipeline(
                source=_NullSource("EditedTweets")),
            instruction_builder=EditedTweetsInstructionBuilder(edit_chains),
        ))
    pipelines.append(MixerCandidatePipeline(
        pipeline=CandidatePipeline(source=_NullSource("NewTweetsPill")),
        instruction_builder=NewTweetsPillInstructionBuilder(index),
    ))
    return MixerPipeline(
        candidate_pipelines=pipelines,
        entry_selectors=[
            SortModulesByRecency(),
            DropMaxModuleItemCandidates(3, module_kind="conversation"),
            DropModuleTooFewItems(2, module_kind="who_to_follow"),
            DropMaxModuleItemCandidates(5, module_kind="who_to_follow"),
            InsertFixedPositionModule(EntryKind.MODULE, wtf_position,
                                      module_kind="who_to_follow"),
            InsertAdResults(min_spacing=ad_spacing),
            _DropMaxFromQuery(),
        ],
        stats=stats,
    )


def build_subscribed_pipeline(*, index, stats=None) -> MixerPipeline:
    """≡ ``SubscribedMixerPipelineConfig`` — earlybird over the user's
    subscribed (super-follow) authors only; no ads, no modules."""
    source = AuthorListEarlybirdSource(
        index, authors_of=lambda q: q.subscribed_authors,
        include_self=False, name="SubscribedEarlybird")
    return MixerPipeline(
        candidate_pipelines=[MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=source))],
        entry_selectors=[SortModulesByRecency(), _DropMaxFromQuery()],
        stats=stats,
    )


def build_list_tweets_pipeline(
    *, index, list_members: Dict[int, Sequence[int]],
    ads: Sequence[Candidate] = (), stats=None,
) -> MixerPipeline:
    """≡ ``ListTweetsMixerPipelineConfig``."""
    pipelines = [MixerCandidatePipeline(
        pipeline=CandidatePipeline(source=ListMembersSource(index, list_members)))]
    if ads:
        pipelines.append(MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=StaticAdsSource(ads)),
            kind=EntryKind.AD,
        ))
    return MixerPipeline(
        candidate_pipelines=pipelines,
        entry_selectors=[SortModulesByRecency(), InsertAdResults(),
                         _DropMaxFromQuery()],
        stats=stats,
    )


def build_list_recommended_users_pipeline(*, wtf_flow, stats=None) -> MixerPipeline:
    """≡ ``product/list_recommended_users`` — user recommendations to add
    to a list, served as one module."""
    return MixerPipeline(
        candidate_pipelines=[MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=WhoToFollowModuleSource(wtf_flow)),
            kind=EntryKind.MODULE,
            grouper=who_to_follow_grouper,
        )],
        entry_selectors=[DropMaxModuleItemCandidates(20,
                                                     module_kind="who_to_follow")],
        stats=stats,
    )


class _NullSource(CandidateSource):
    def __init__(self, name):
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params):
        return []


class _DropMaxFromQuery(DropMaxEntries):
    """Max-results truncation read from the query, statelessly — selector
    instances are shared by every request running through one pipeline, so
    the limit must never be written onto ``self`` (a write would race
    concurrent ``run()`` calls and truncate one request with another's
    ``max_results``)."""

    def __init__(self):
        super().__init__(0)

    def select(self, query, entries, params):
        return entries[: query.max_results]


# -- For You full mixer ---------------------------------------------------------


class ScoredTweetsSource(CandidateSource):
    """Wraps the scored-tweets RecommendationPipeline as a mixer candidate
    pipeline (≡ ``ForYouScoredTweetsCandidatePipelineConfig`` delegating to
    ``ScoredTweetsRecommendationPipelineConfig``)."""

    def __init__(self, recommendation_pipeline, name="ForYouScoredTweets"):
        self.pipeline = recommendation_pipeline
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        return self.pipeline.run(query, params).candidates


class SortByScore:
    """Primary ordering for the ranked product (score, not recency)."""

    name = "SortByScore"

    def select(self, query, entries, params):
        primary = [e for e in entries if e.kind == EntryKind.TWEET]
        rest = [e for e in entries if e.kind != EntryKind.TWEET]
        primary.sort(key=lambda e: -(e.candidate.score or 0.0))
        return primary + rest


def build_for_you_mixer(
    *,
    scored_tweets_pipeline,
    wtf_flow=None,
    ads: Sequence[Candidate] = (),
    edit_chains=None,
    wtf_position: int = 6,
    ad_spacing: int = 5,
    stats=None,
) -> MixerPipeline:
    """≡ ``ForYouScoredTweetsMixerPipelineConfig``: the ranked scored-tweets
    pipeline mixed with the who-to-follow module, ads injection, and the
    edited-tweets instruction pipeline — the full For You response."""
    pipelines = [MixerCandidatePipeline(
        pipeline=CandidatePipeline(
            source=ScoredTweetsSource(scored_tweets_pipeline),
            fail_open=False),  # no backup product: scoring failures raise
    )]
    if wtf_flow is not None:
        pipelines.append(MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=WhoToFollowModuleSource(wtf_flow)),
            kind=EntryKind.MODULE,
            grouper=who_to_follow_grouper,
        ))
    if ads:
        pipelines.append(MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=StaticAdsSource(ads)),
            kind=EntryKind.AD,
        ))
    if edit_chains is not None:
        pipelines.append(MixerCandidatePipeline(
            pipeline=CandidatePipeline(source=_NullSource("EditedTweets")),
            instruction_builder=EditedTweetsInstructionBuilder(edit_chains),
        ))
    return MixerPipeline(
        candidate_pipelines=pipelines,
        entry_selectors=[
            SortByScore(),
            DropModuleTooFewItems(2, module_kind="who_to_follow"),
            DropMaxModuleItemCandidates(5, module_kind="who_to_follow"),
            InsertFixedPositionModule(EntryKind.MODULE, wtf_position,
                                      module_kind="who_to_follow"),
            InsertAdResults(min_spacing=ad_spacing),
            _DropMaxFromQuery(),
        ],
        stats=stats,
    )


# -- registry -----------------------------------------------------------------


class HomeProductPipelineRegistry:
    """product name → pipeline (≡ ``HomeProductPipelineRegistryConfig``)."""

    def __init__(self):
        self._by_name: Dict[str, object] = {}

    def register(self, product: str, pipeline) -> None:
        self._by_name[product] = pipeline

    def get(self, product: str):
        if product not in self._by_name:
            raise KeyError(f"unknown product: {product!r}")
        return self._by_name[product]

    def products(self) -> List[str]:
        return sorted(self._by_name)
