"""Tweet-mixer candidate-pipeline catalog — the full OON source breadth.

Counterpart of ``the_algorithm_tpu/mixers/candidate_pipeline_catalog.py``
(host code over the port's engines; the spec table is the same row for
row). ≡ ``tweet-mixer/server/.../candidate_pipeline/`` (50
CandidatePipelineConfig files, SURVEY.md §2.1) and cr-mixer's
``CandidateSourcesRouter``. Each
reference file wires one (signal → similarity engine → params) combination
into a gated pipeline; here the catalog is table-driven: a
:class:`PipelineSpec` names the family, the per-pipeline enable Param, the
query signals it needs, and a factory closing over the :class:`SourceWorld`
stores. :func:`build_catalog` instantiates every spec whose stores exist;
:func:`enabled_pipelines` is the router (param gate + signal availability).

Families covered (reference file ↔ spec):

- EarlybirdInNetwork              ↔ ``EarlybirdInNetworkCandidatePipelineConfigFactory``
- SimClusters InterestedIn / TweetBased / ProducerBased / PromotedCreator /
  ContentExplorationCold          ↔ ``Simclusters*CandidatePipelineConfigFactory``
- TwHIN consumer / tweet / rebuild ↔ ``Twhin*`` / ``TwHIN*SimilarityCandidatePipeline…``
- DeepRetrieval user-tweet / tweet-tweet / media / evergreen /
  content-exploration             ↔ ``*DeepRetrieval*`` / ``Evergreen*`` /
  ``ContentExplorationDR*``
- UTEG / UTG tweet / UTG producer / UTG expansion / UVG / UVG expansion /
  UAG                             ↔ ``UTEG…`` ``UTG*…`` ``UVG*…`` (UAG via cr-mixer)
- Topic: popular / skit / skit-high-precision / certo / pop-geo / trends
                                  ↔ ``PopularTopicTweets…`` ``SkitTopicTweets…``
  ``CertoTopicTweets…`` ``PopularGeoTweets…`` ``TrendsVideo…``
- QIG search-history              ↔ ``QigSearchHistoryTweetsCandidatePipeline…``
- Diffusion                       ↔ diffusion engine (cr-mixer similarity_engine)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.core.config import Param, Params
from the_algorithm_tpu_torch.mixers import similarity_engines as se
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    CandidatePipeline,
    CandidateSource,
)
from the_algorithm_tpu_torch.search import earlybird


@dataclasses.dataclass
class SourceWorld:
    """Handles to the retrieval stores the engines read — each field is one
    reference store/dataset; ``None`` means the store isn't deployed and
    every spec needing it is skipped (the reference gates these the same
    way via warmup/availability)."""

    # SimClusters ANN
    sann_index: Any = None  # ClusterTweetIndex
    sann_config: Any = None  # ann.SimClustersANNConfig
    interested_in_fn: Optional[Callable] = None  # query -> SparseEmbedding
    tweet_embedding_fn: Optional[Callable] = None  # tweet_id -> SparseEmbedding
    producer_embedding_fn: Optional[Callable] = None  # query -> SparseEmbedding
    cold_index: Any = None  # content-exploration cold SANN index
    promoted_creator_index: Any = None
    # TwHIN / dense
    twhin_items: Any = None  # [N, D]
    twhin_rebuild_items: Any = None
    twhin_user_vec_fn: Optional[Callable] = None  # query -> [D]
    twhin_tweet_vec_fn: Optional[Callable] = None  # tweet_id -> [D]
    # Deep-retrieval two-tower tables
    dr_tweet_items: Any = None
    dr_media_items: Any = None
    dr_evergreen_items: Any = None
    dr_user_vec_fn: Optional[Callable] = None
    dr_tweet_vec_fn: Optional[Callable] = None
    # graphs
    uteg_graph: Any = None  # uteg.EngagementGraph
    ad_graph: Any = None
    utg_left: Any = None  # EngagementGraph
    utg_right: Any = None  # graphjet.RightIndex
    video_mask: Any = None  # [T] bool
    # topic / geo / trend indices (rows keyed by topic/geo/trend id)
    topic_index: Any = None
    certo_topic_index: Any = None
    geo_index: Any = None
    trend_index: Any = None
    # QIG
    qig_ids: Any = None
    qig_scores: Any = None
    # diffusion
    diffusion_index: Any = None
    # earlybird
    earlybird_index: Any = None
    earlybird_query_fn: Optional[Callable] = None  # query -> SearchQuery
    # content/text-embedding ANN (ContentAnnTweetBased / embedding-similarity)
    content_ann_items: Any = None  # [N, D] text/content embeddings
    content_tweet_vec_fn: Optional[Callable] = None  # tweet_id -> [D]
    # video corpora (clip / semantic / evergreen / trends video)
    clip_long_items: Any = None
    clip_short_items: Any = None
    semantic_video_items: Any = None
    evergreen_video_items: Any = None
    # cross-border / tier-two exploration DR tables
    dr_cross_border_items: Any = None
    dr_tier_two_items: Any = None
    # events / grok-topic / control-ai topic indexes (topic-shaped)
    events_index: Any = None
    pop_grok_topic_index: Any = None
    control_ai_topic_index: Any = None
    # haplolite per-country popular-tweet store {country: [(id, score)]}
    haplolite_store: Any = None
    # external-id set of video tweets (TrendsVideo corpus restriction)
    video_tweet_ids: Any = None
    # curated per-language author timelines {lang: [author_id]}
    curated_tls_authors: Any = None
    # pinned-tweet → related-creator producer embeddings
    pinned_tweet_author_fn: Optional[Callable] = None  # tweet_id -> author_id
    producer_embedding_by_id_fn: Optional[Callable] = None  # author -> emb
    # r3 engine variants: TwHIN user table for collab-filter, a
    # similar-consumer seed provider (RealGraph top-K / embedding kNN), and
    # a producer→audience provider (the producer's recent engagers)
    twhin_user_items: Any = None  # [U, D] TwHIN USER embeddings
    similar_consumers_fn: Optional[Callable] = None  # q -> (ids, weights)
    producer_engagers_fn: Optional[Callable] = None  # producer -> (ids, w)
    # r4 engine variants: trip popularity index, two-tower deep retrieval,
    # model-scored earlybird, versioned lookup
    trip_embedding_stores: Any = None  # {model_id: user_id -> SparseEmbedding}
    trip_index: Any = None  # {(trip_source_id, cluster_id): [(tweet, score)]}
    trip_model_id: Optional[str] = None
    two_tower_user_fn: Optional[Callable] = None  # user_id -> [D]
    two_tower_items: Any = None  # [N, D] item-tower table
    two_tower_item_ids: Any = None  # [N] tweet ids (optional)
    eb_seeds_fn: Optional[Callable] = None  # query -> (author_ids, weights)
    eb_model_score_fn: Optional[Callable] = None  # features [T,F] -> [T]
    eb_tf_score_fn: Optional[Callable] = None  # features [T,F] -> [T]
    lookup_engines: Any = None  # {model_id: CandidateSource}
    lookup_default_model: Optional[str] = None


# query-signal extractors — the USS-derived signals a spec needs
def _has_source_tweet(q) -> bool:
    return bool(np.asarray(getattr(q, "recent_engagement_ids", ())).size) or \
        getattr(q, "source_tweet_id", None) is not None


def _source_tweet(q) -> int:
    st = getattr(q, "source_tweet_id", None)
    if st is not None:
        return int(st)
    return int(np.asarray(q.recent_engagement_ids)[0])


def _recent_tweets(q, n: int = 4) -> List[int]:
    ids = list(np.asarray(getattr(q, "recent_engagement_ids", ())).tolist())
    st = getattr(q, "source_tweet_id", None)
    if st is not None:
        ids = [int(st)] + ids
    return [int(i) for i in ids[:n]]


def _has_follows(q) -> bool:
    return bool(len(getattr(q, "followed_authors", ()) or ()))


def _has_topic(q) -> bool:
    return getattr(q, "topic_id", None) is not None


def _has_geo(q) -> bool:
    return getattr(q, "geo_id", None) is not None


SIGNAL_CHECKS: Dict[str, Callable[[Any], bool]] = {
    "consumer": lambda q: getattr(q, "user_id", None) is not None,
    "source_tweet": _has_source_tweet,
    "follows": _has_follows,
    "topic": _has_topic,
    "geo": _has_geo,
    "trend": lambda q: getattr(q, "trend_id", None) is not None,
    "search_history": lambda q: getattr(q, "last_searched_tweet_id", None)
    is not None,
    "language": lambda q: getattr(q, "language_code", None) is not None,
    "country": lambda q: getattr(q, "country_code", None) is not None,
    "event": lambda q: getattr(q, "event_id", None) is not None,
    "interests": lambda q: bool(getattr(q, "interest_topic_ids", ()) or ()),
    "pinned_tweet": lambda q: getattr(q, "pinned_tweet_id", None) is not None,
}


class ExpansionSource(CandidateSource):
    """Union a per-source-tweet engine over the viewer's recent engagement
    tweets (≡ the *Expansion* pipeline variants: fan the engine out over
    the signal set instead of only the primary source tweet)."""

    def __init__(self, engine_for_tweet: Callable[[int], CandidateSource],
                 tweets_fn: Callable[[Any], List[int]],
                 max_results: int, name: str):
        self._engine_for_tweet = engine_for_tweet
        self._tweets_fn = tweets_fn
        self._max = max_results
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        from the_algorithm_tpu_torch.mixers.tweet_mixer import interleave_blend

        per = []
        for t in self._tweets_fn(query):
            eng = self._engine_for_tweet(int(t))
            per.append(eng.get(query, params))
        out = interleave_blend(per, self._max)
        for c in out:
            c.source = self._name
        return out


class AuthorAllowListSource(CandidateSource):
    """Recency-ranked earlybird fetch restricted to a stored author
    allow-list (the curated per-language author timelines hold *author*
    ids, which must be resolved to their recent tweets through the index —
    a match-all recency query with the author-accept-list operand, like
    ``FollowingEarlybirdQueryTransformer``)."""

    def __init__(self, index, authors_fn: Callable[[Any], Sequence[int]],
                 name: str, max_results: int = 200):
        self._index = index
        self._authors_fn = authors_fn
        self._name = name
        self._max = max_results

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        authors = sorted(set(int(a) for a in (self._authors_fn(query) or ())))
        if not authors:
            return []
        dev = self._index.tweet_ids.device
        q = earlybird.SearchQuery(
            tokens=torch.full((1,), PAD_ID, dtype=torch.int32, device=dev),  # match-all
            require_all=True,
            min_ts=0,
            max_ts=2**31 - 1,
            followed_authors=torch.tensor(authors, dtype=torch.int32, device=dev),
        )
        ids, _ = earlybird.search(
            self._index, q, max_results=self._max, rank_by="recency")
        out = []
        for rank, tid in enumerate(ids.cpu().numpy()):
            tid = int(tid)
            if tid == int(PAD_ID):
                continue
            score = 1.0 / (1.0 + rank)
            out.append(Candidate(id=tid, score=score, source=self._name,
                                 features={"retrieval_score": score}))
        return out


class ListStoreSource(CandidateSource):
    """Host-side keyed list store → candidates (the Haplolite popular-by-
    country store and the curated per-language author timelines are plain
    KV lists, not device indexes)."""

    def __init__(self, rows_fn: Callable[[Any], Sequence], name: str,
                 max_results: int = 200):
        self._rows_fn = rows_fn
        self._name = name
        self._max = max_results

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        rows = self._rows_fn(query) or ()
        out = []
        for r in rows[: self._max]:
            tid, score = (r if isinstance(r, (tuple, list)) else (r, 0.0))
            out.append(Candidate(id=int(tid), score=float(score),
                                 source=self._name,
                                 features={"retrieval_score": float(score)}))
        return out


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    name: str
    family: str
    signals: Sequence[str]  # keys into SIGNAL_CHECKS (all required)
    needs: Sequence[str]  # SourceWorld fields that must be non-None
    factory: Callable[[SourceWorld], CandidateSource]
    enabled_by_default: bool = True

    @property
    def param(self) -> Param:
        return Param(f"tweet_mixer.enable_{self.name}", self.enabled_by_default)


def _sann(world, index, name, emb_attr):
    emb_fn = getattr(world, emb_attr)
    return se.SimClustersANNEngine(index, world.sann_config, emb_fn, name=name)


def _dense(world, items, name, vec_attr, k=200):
    return se.TwHINANNEngine(items, getattr(world, vec_attr), k=k, name=name)


def _topic(world, index, name, attr="topic_id", **kw):
    return se.TopicTweetEngine(
        index, lambda q: getattr(q, attr), name=name, **kw
    )


def _utg(world, name, mask=None, **kw):
    return se.UTGEngine(
        world.utg_left, world.utg_right, _source_tweet,
        candidate_mask=mask, name=name, **kw,
    )


def _utg_expansion(world, name, mask=None):
    def engine_for_tweet(t):
        return se.UTGEngine(
            world.utg_left, world.utg_right, lambda q: t,
            candidate_mask=mask, name=name,
        )

    return ExpansionSource(engine_for_tweet, _recent_tweets, 200, name)


def catalog_specs() -> List[PipelineSpec]:
    """The full spec table (one row ≡ one reference CandidatePipelineConfig)."""
    S = PipelineSpec
    return [
        # -- r4 engine variants (cr-mixer engine tail)
        S("trip_geo_popular", "trip", ("consumer",),
          ("trip_embedding_stores", "trip_index", "trip_model_id"),
          lambda w: se.TripEngine(
              w.trip_embedding_stores, w.trip_index, w.trip_model_id,
              trip_source_id="TOP_GEO",
              name="ConsumerEmbeddingBasedTripSimilarityEngine")),
        S("trip_domain_popular", "trip", ("consumer",),
          ("trip_embedding_stores", "trip_index", "trip_model_id"),
          lambda w: se.TripEngine(
              w.trip_embedding_stores, w.trip_index, w.trip_model_id,
              trip_source_id="TOP_DOMAIN",
              name="TripDomainPopularTweets")),
        S("two_tower_consumer", "deep_retrieval", ("consumer",),
          ("two_tower_user_fn", "two_tower_items"),
          lambda w: se.TwoTowerEngine(
              w.two_tower_user_fn, w.two_tower_items,
              item_ids=w.two_tower_item_ids)),
        S("earlybird_model_based", "earlybird", ("consumer",),
          ("earlybird_index", "eb_seeds_fn", "eb_model_score_fn"),
          lambda w: se.EarlybirdModelBasedEngine(
              w.earlybird_index, w.eb_seeds_fn, w.eb_model_score_fn)),
        S("earlybird_tensorflow_based", "earlybird", ("consumer",),
          ("earlybird_index", "eb_seeds_fn", "eb_tf_score_fn"),
          lambda w: se.EarlybirdTensorflowBasedEngine(
              w.earlybird_index, w.eb_seeds_fn, w.eb_tf_score_fn)),
        S("offline_simclusters_lookup", "lookup", ("consumer",),
          ("lookup_engines", "lookup_default_model"),
          lambda w: se.LookupEngine(
              w.lookup_engines, w.lookup_default_model,
              cache_ttl_s=600.0)),
        # -- in-network search
        S("earlybird_in_network", "earlybird", ("consumer", "follows"),
          ("earlybird_index", "earlybird_query_fn"),
          lambda w: se.EarlybirdEngine(
              w.earlybird_index, w.earlybird_query_fn,
              name="EarlybirdInNetwork")),
        # -- simclusters family
        S("simclusters_interested_in", "simclusters", ("consumer",),
          ("sann_index", "sann_config", "interested_in_fn"),
          lambda w: _sann(w, w.sann_index, "SimClustersInterestedIn",
                          "interested_in_fn")),
        S("simclusters_tweet_based", "simclusters", ("source_tweet",),
          ("sann_index", "sann_config", "tweet_embedding_fn"),
          lambda w: se.SimClustersANNEngine(
              w.sann_index, w.sann_config,
              lambda q: w.tweet_embedding_fn(_source_tweet(q)),
              name="SimClustersTweetBased")),
        S("simclusters_producer_based", "simclusters", ("consumer",),
          ("sann_index", "sann_config", "producer_embedding_fn"),
          lambda w: _sann(w, w.sann_index, "SimClustersProducerBased",
                          "producer_embedding_fn")),
        S("simclusters_promoted_creator", "simclusters", ("consumer",),
          ("promoted_creator_index", "sann_config", "producer_embedding_fn"),
          lambda w: _sann(w, w.promoted_creator_index,
                          "SimClustersPromotedCreator",
                          "producer_embedding_fn")),
        S("content_exploration_simclusters_cold", "simclusters", ("consumer",),
          ("cold_index", "sann_config", "interested_in_fn"),
          lambda w: _sann(w, w.cold_index, "ContentExplorationSimclustersCold",
                          "interested_in_fn"),
          enabled_by_default=False),
        # -- twhin family
        S("twhin_consumer_based", "twhin", ("consumer",),
          ("twhin_items", "twhin_user_vec_fn"),
          lambda w: _dense(w, w.twhin_items, "TwhinConsumerBased",
                           "twhin_user_vec_fn")),
        S("twhin_tweet_similarity", "twhin", ("source_tweet",),
          ("twhin_items", "twhin_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.twhin_items,
              lambda q: w.twhin_tweet_vec_fn(_source_tweet(q)),
              name="TwhinTweetSimilarity")),
        S("twhin_rebuild_tweet_similarity", "twhin", ("source_tweet",),
          ("twhin_rebuild_items", "twhin_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.twhin_rebuild_items,
              lambda q: w.twhin_tweet_vec_fn(_source_tweet(q)),
              name="TwhinRebuildTweetSimilarity"),
          enabled_by_default=False),
        # -- deep-retrieval (two-tower) family
        S("deep_retrieval_user_tweet", "deep_retrieval", ("consumer",),
          ("dr_tweet_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.dr_tweet_items, "DeepRetrievalUserTweet",
                           "dr_user_vec_fn")),
        S("deep_retrieval_tweet_tweet", "deep_retrieval", ("source_tweet",),
          ("dr_tweet_items", "dr_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.dr_tweet_items,
              lambda q: w.dr_tweet_vec_fn(_source_tweet(q)),
              name="DeepRetrievalTweetTweet")),
        S("media_deep_retrieval_user_tweet", "deep_retrieval", ("consumer",),
          ("dr_media_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.dr_media_items, "MediaDeepRetrievalUserTweet",
                           "dr_user_vec_fn")),
        S("evergreen_dr_user_tweet", "deep_retrieval", ("consumer",),
          ("dr_evergreen_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.dr_evergreen_items, "EvergreenDRUserTweet",
                           "dr_user_vec_fn")),
        S("content_exploration_dr_tweet_tweet", "deep_retrieval",
          ("source_tweet",), ("dr_evergreen_items", "dr_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.dr_evergreen_items,
              lambda q: w.dr_tweet_vec_fn(_source_tweet(q)),
              name="ContentExplorationDRTweetTweet"),
          enabled_by_default=False),
        # -- graph family
        S("uteg", "graph", ("consumer", "follows"), ("uteg_graph",),
          lambda w: se.UTEGEngine(
              w.uteg_graph,
              lambda q: (list(q.followed_authors),
                         [1.0] * len(q.followed_authors)),
              name="UTEG")),
        S("utg_tweet_based", "graph", ("source_tweet",),
          ("utg_left", "utg_right"),
          lambda w: _utg(w, "UTGTweetBased")),
        S("utg_producer_based", "graph", ("consumer", "follows"),
          ("utg_left",),
          lambda w: se.UTEGEngine(
              w.utg_left,
              lambda q: (list(q.followed_authors),
                         [1.0] * len(q.followed_authors)),
              name="UTGProducerBased")),
        S("utg_expansion_tweet_based", "graph", ("source_tweet",),
          ("utg_left", "utg_right"),
          lambda w: _utg_expansion(w, "UTGExpansionTweetBased")),
        S("uvg_tweet_based", "graph", ("source_tweet",),
          ("utg_left", "utg_right", "video_mask"),
          lambda w: _utg(w, "UVGTweetBased", mask=w.video_mask)),
        S("uvg_expansion_tweet_based", "graph", ("source_tweet",),
          ("utg_left", "utg_right", "video_mask"),
          lambda w: _utg_expansion(w, "UVGExpansionTweetBased",
                                   mask=w.video_mask)),
        S("uag", "graph", ("consumer", "follows"), ("ad_graph",),
          lambda w: se.UAGEngine(
              w.ad_graph,
              lambda q: (list(q.followed_authors),
                         [1.0] * len(q.followed_authors)),
              name="UAG"),
          enabled_by_default=False),
        # -- topic/geo/trend family
        S("popular_topic_tweets", "topic", ("topic",), ("topic_index",),
          lambda w: _topic(w, w.topic_index, "PopularTopicTweets",
                           min_relevance=0.0)),
        S("skit_topic_tweets", "topic", ("topic",), ("topic_index",),
          lambda w: _topic(w, w.topic_index, "SkitTopicTweets",
                           min_relevance=0.25)),
        S("skit_high_precision_topic_tweets", "topic", ("topic",),
          ("topic_index",),
          lambda w: _topic(w, w.topic_index, "SkitHighPrecisionTopicTweets",
                           high_precision=True)),
        S("certo_topic_tweets", "topic", ("topic",), ("certo_topic_index",),
          lambda w: _topic(w, w.certo_topic_index, "CertoTopicTweets")),
        S("popular_geo_tweets", "topic", ("geo",), ("geo_index",),
          lambda w: _topic(w, w.geo_index, "PopularGeoTweets",
                           attr="geo_id")),
        S("trends_tweets", "topic", ("trend",), ("trend_index",),
          lambda w: _topic(w, w.trend_index, "TrendsTweets",
                           attr="trend_id")),
        # -- qig + diffusion
        S("qig_search_history_tweets", "qig", ("search_history",),
          ("qig_ids", "qig_scores"),
          lambda w: se.QIGEngine(
              w.qig_ids, w.qig_scores,
              lambda q: q.last_searched_tweet_id,
              name="QigSearchHistoryTweets")),
        # -- r3 engine variants (cr-mixer similarity_engine breadth)
        S("twhin_collab_filter", "twhin", ("consumer",),
          ("twhin_user_items", "uteg_graph", "twhin_user_vec_fn"),
          lambda w: se.TwhinCollabFilterEngine(
              w.twhin_user_items, w.uteg_graph, w.twhin_user_vec_fn,
              name="TwhinCollabFilter")),
        S("consumers_based_utg", "graph", ("consumer",),
          ("utg_left", "similar_consumers_fn"),
          lambda w: se.ConsumersBasedUTGEngine(
              w.utg_left, w.similar_consumers_fn,
              name="ConsumersBasedUserTweetGraph")),
        S("producer_based_utg", "graph", ("consumer", "follows"),
          ("utg_left", "producer_engagers_fn"),
          lambda w: se.ProducerBasedUTGEngine(
              w.utg_left, w.producer_engagers_fn,
              lambda q: (list(q.followed_authors)[:8],
                         [1.0] * min(len(q.followed_authors), 8)),
              name="ProducerBasedUserTweetGraph")),
        S("tweet_based_unified", "unified", ("source_tweet",),
          ("utg_left", "utg_right", "qig_ids", "qig_scores"),
          lambda w: se.UnifiedEngine([
              se.UTGEngine(w.utg_left, w.utg_right,
                           lambda q: _source_tweet(q), name="UTG"),
              se.QIGEngine(w.qig_ids, w.qig_scores,
                           lambda q: _source_tweet(q), name="QIG"),
          ], name="TweetBasedUnified")),
        S("diffusion", "diffusion", ("consumer",),
          ("diffusion_index", "sann_config", "interested_in_fn"),
          lambda w: se.DiffusionEngine(
              w.diffusion_index, w.sann_config, w.interested_in_fn,
              name="Diffusion")),
        # -- content/text-embedding ANN family
        S("content_ann_tweet_based", "content_ann", ("source_tweet",),
          ("content_ann_items", "content_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.content_ann_items,
              lambda q: w.content_tweet_vec_fn(_source_tweet(q)),
              name="ContentAnnTweetBased")),
        S("dr_tweet_tweet_embedding_similarity", "content_ann",
          ("source_tweet",), ("content_ann_items", "dr_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.content_ann_items,
              lambda q: w.dr_tweet_vec_fn(_source_tweet(q)),
              name="DeepRetrievalTweetTweetEmbeddingSimilarity")),
        S("content_exploration_embedding_similarity", "content_ann",
          ("source_tweet",), ("content_ann_items", "content_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.content_ann_items,
              lambda q: w.content_tweet_vec_fn(_source_tweet(q)),
              k=100, name="ContentExplorationEmbeddingSimilarity"),
          enabled_by_default=False),
        S("content_exploration_embedding_similarity_tier_two", "content_ann",
          ("source_tweet",), ("dr_tier_two_items", "content_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.dr_tier_two_items,
              lambda q: w.content_tweet_vec_fn(_source_tweet(q)),
              k=100, name="ContentExplorationEmbeddingSimilarityTierTwo"),
          enabled_by_default=False),
        # -- exploration DR tiers + cross-border + media T-T
        S("content_exploration_dr_user_tweet", "deep_retrieval",
          ("consumer",), ("dr_evergreen_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.dr_evergreen_items,
                           "ContentExplorationDRUserTweet", "dr_user_vec_fn"),
          enabled_by_default=False),
        S("content_exploration_dr_user_tweet_tier_two", "deep_retrieval",
          ("consumer",), ("dr_tier_two_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.dr_tier_two_items,
                           "ContentExplorationDRUserTweetTierTwo",
                           "dr_user_vec_fn"),
          enabled_by_default=False),
        S("content_exploration_dr_tweet_tweet_tier_two", "deep_retrieval",
          ("source_tweet",), ("dr_tier_two_items", "dr_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.dr_tier_two_items,
              lambda q: w.dr_tweet_vec_fn(_source_tweet(q)),
              name="ContentExplorationDRTweetTweetTierTwo"),
          enabled_by_default=False),
        S("content_exploration_evergreen_dr_tweet_tweet", "deep_retrieval",
          ("source_tweet",), ("dr_evergreen_items", "dr_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.dr_evergreen_items,
              lambda q: w.dr_tweet_vec_fn(_source_tweet(q)),
              name="ContentExplorationEvergreenDRTweetTweet"),
          enabled_by_default=False),
        S("evergreen_dr_cross_border_user_tweet", "deep_retrieval",
          ("consumer", "country"), ("dr_cross_border_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.dr_cross_border_items,
                           "EvergreenDRCrossBorderUserTweet",
                           "dr_user_vec_fn")),
        S("media_deep_retrieval_tweet_tweet", "deep_retrieval",
          ("source_tweet",), ("dr_media_items", "dr_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.dr_media_items,
              lambda q: w.dr_tweet_vec_fn(_source_tweet(q)),
              name="MediaDeepRetrievalTweetTweetSimilarity")),
        S("twhin_user_tweet_similarity", "twhin", ("consumer",),
          ("twhin_items", "twhin_user_vec_fn"),
          lambda w: _dense(w, w.twhin_items, "TwhinUserTweetSimilarity",
                           "twhin_user_vec_fn", k=100)),
        # -- video corpora
        S("twitter_clip_v0_long_video", "video", ("consumer",),
          ("clip_long_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.clip_long_items, "TwitterClipV0LongVideo",
                           "dr_user_vec_fn")),
        S("twitter_clip_v0_short_video", "video", ("consumer",),
          ("clip_short_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.clip_short_items, "TwitterClipV0ShortVideo",
                           "dr_user_vec_fn")),
        S("semantic_video", "video", ("source_tweet",),
          ("semantic_video_items", "content_tweet_vec_fn"),
          lambda w: se.TwHINANNEngine(
              w.semantic_video_items,
              lambda q: w.content_tweet_vec_fn(_source_tweet(q)),
              name="SemanticVideo")),
        S("evergreen_videos", "video", ("consumer",),
          ("evergreen_video_items", "dr_user_vec_fn"),
          lambda w: _dense(w, w.evergreen_video_items, "EvergreenVideos",
                           "dr_user_vec_fn")),
        S("trends_video", "video", ("trend",),
          ("trend_index", "video_tweet_ids"),
          lambda w: se.TopicTweetEngine(
              w.trend_index, lambda q: q.trend_id,
              allowed_ids=w.video_tweet_ids, name="TrendsVideo")),
        # -- topic-shaped extras
        S("events_tweets", "topic", ("event",), ("events_index",),
          lambda w: _topic(w, w.events_index, "Events", attr="event_id")),
        S("pop_grok_topic_tweets", "topic", ("topic",),
          ("pop_grok_topic_index",),
          lambda w: _topic(w, w.pop_grok_topic_index, "PopGrokTopicTweets")),
        S("control_ai_topic", "topic", ("topic",), ("control_ai_topic_index",),
          lambda w: _topic(w, w.control_ai_topic_index, "ControlAiTopic"),
          enabled_by_default=False),
        S("user_interests_summary", "topic", ("interests",), ("topic_index",),
          lambda w: ExpansionSource(
              lambda t: se.TopicTweetEngine(
                  w.topic_index, lambda q, _t=t: _t,
                  name="UserInterestsSummary"),
              lambda q: [int(t) for t in q.interest_topic_ids[:4]],
              200, "UserInterestsSummary")),
        S("user_location_tweets", "topic", ("consumer",), ("geo_index",),
          lambda w: _topic(w, w.geo_index, "UserLocation", attr="geo_id")),
        # -- host KV stores
        S("haplolite", "popularity", ("country",), ("haplolite_store",),
          lambda w: ListStoreSource(
              lambda q: w.haplolite_store.get(q.country_code),
              "Haplolite")),
        S("curated_user_tls_per_language", "curated", ("language",),
          ("curated_tls_authors", "earlybird_index"),
          lambda w: AuthorAllowListSource(
              w.earlybird_index,
              lambda q: w.curated_tls_authors.get(q.language_code),
              "CuratedUserTlsPerLanguage")),
        # -- pinned-tweet related creators
        S("pinned_tweet_related_creator", "simclusters",
          ("pinned_tweet",),
          ("sann_index", "sann_config", "pinned_tweet_author_fn",
           "producer_embedding_by_id_fn"),
          lambda w: se.SimClustersANNEngine(
              w.sann_index, w.sann_config,
              lambda q: w.producer_embedding_by_id_fn(
                  w.pinned_tweet_author_fn(int(q.pinned_tweet_id))),
              name="PinnedTweetRelatedCreator")),
    ]


def build_catalog(world: SourceWorld) -> List[tuple]:
    """[(spec, CandidatePipeline)] for every spec whose stores exist."""
    out = []
    for spec in catalog_specs():
        if any(getattr(world, f) is None for f in spec.needs):
            continue
        out.append((spec, CandidatePipeline(source=spec.factory(world))))
    return out


def enabled_pipelines(
    catalog: Sequence[tuple], query, params: Params
) -> List[CandidatePipeline]:
    """The router: param gate (per-pipeline enable Param, decider-overridable)
    ∧ signal availability (≡ ``CandidateSourcesRouter`` routing by
    SignalType presence)."""
    out = []
    for spec, pipe in catalog:
        if not params(spec.param):
            continue
        if all(SIGNAL_CHECKS[s](query) for s in spec.signals):
            out.append(pipe)
    return out
