"""The heavy-ranker feature schema + columnar feature store.

Counterpart of ``the_algorithm_tpu/mixers/feature_schema.py`` (host numpy,
copied; the port imports nothing of the JAX package). ≡ home-mixer's
~6000-feature hydration width (``home-mixer/README.md:22-24``, 109 shared +
~30 scored-tweets hydrators under ``functional_component/feature_hydrator/``)
and the segdense slot mapping that densifies them for the model
(``navi/segdense/src/mapper.rs``).

The columnar design: hydrators emit **columnar** blocks — ``{name: [B] or
[B, K] numpy array}`` per candidate batch — into a per-request
:class:`ColumnarFeatureStore`; the scorer assembles the model's [B, F]
matrix with pure numpy column stacking and searchsorted id-alignment.
No per-candidate (or per-candidate-per-feature) Python loop touches the
hot path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One schema entry: a scalar (width=1) or a vector feature family."""

    name: str
    width: int = 1


def expand(schema: Sequence[FeatureSpec]) -> List[str]:
    """Flat column names (vector features expand name_0..name_{K-1})."""
    out: List[str] = []
    for s in schema:
        if s.width == 1:
            out.append(s.name)
        else:
            out.extend(f"{s.name}_{i}" for i in range(s.width))
    return out


def total_width(schema: Sequence[FeatureSpec]) -> int:
    return sum(s.width for s in schema)


class ColumnarFeatureStore:
    """Per-request accumulator of vectorized hydrator outputs.

    Blocks are keyed by candidate id, so assembly stays correct after
    filters shrink or reorder the candidate list between hydration and
    scoring (the engine runs globalFilters after hydration,
    ``RecommendationPipelineConfig.scala:57-201``).

    Storage is *block-wise* — each ``add()`` call stores ONE [N, W] matrix
    plus a name→column-range index, so assembling a ~6,000-wide schema
    costs one id-alignment (searchsorted) per hydrator block and one
    contiguous slice per run of schema columns, not one gather per column
    (the segdense densifier's slot-range trick, ``navi/segdense/src/mapper.rs``).
    """

    def __init__(self):
        # block: (sorted_ids [N], matrix [N, W])
        self._blocks: List[Tuple[np.ndarray, np.ndarray]] = []
        # name -> (block_idx, start_col, width)
        self._name_index: Dict[str, Tuple[int, int, int]] = {}

    def add(self, ids: np.ndarray, columns: Mapping[str, np.ndarray]) -> None:
        ids = np.asarray(ids, np.int64)
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        mats: List[np.ndarray] = []
        start = 0
        bi = len(self._blocks)
        for name, col in columns.items():
            col = np.asarray(col, np.float32)
            if col.shape[0] != ids.shape[0]:
                raise ValueError(
                    f"column '{name}' has {col.shape[0]} rows for "
                    f"{ids.shape[0]} ids"
                )
            if col.ndim == 1:
                col = col[:, None]
            w = col.shape[1]
            self._name_index[name] = (bi, start, w)
            mats.append(col[order])
            start += w
        if not mats:
            return
        self._blocks.append(
            (sorted_ids, np.concatenate(mats, axis=1) if len(mats) > 1
             else mats[0])
        )

    def add_block(
        self, ids: np.ndarray, names: Sequence[str], matrix: np.ndarray
    ) -> None:
        """Register a whole [N, W] block of scalar columns in one shot —
        the zero-copy path for hydrators that already hold their output as
        one matrix (e.g. the aggregate-framework rollups: building ~300
        per-column arrays just to re-concatenate them costs more than the
        math)."""
        ids = np.asarray(ids, np.int64)
        matrix = np.asarray(matrix, np.float32)
        if matrix.shape != (ids.shape[0], len(names)):
            raise ValueError(
                f"block shape {matrix.shape} != ({ids.shape[0]}, {len(names)})")
        order = np.argsort(ids, kind="stable")
        bi = len(self._blocks)
        for j, name in enumerate(names):
            self._name_index[name] = (bi, j, 1)
        self._blocks.append((ids[order], matrix[order]))

    def names(self) -> List[str]:
        return sorted(self._name_index)

    def _align(self, block_idx: int, ids: np.ndarray):
        """(pos [B], found [B]) for gathering block rows by candidate id."""
        sorted_ids, _ = self._blocks[block_idx]
        pos = np.searchsorted(sorted_ids, ids)
        pos = np.clip(pos, 0, sorted_ids.shape[0] - 1)
        return pos, sorted_ids[pos] == ids

    def gather(self, name: str, ids: np.ndarray) -> np.ndarray:
        """Rows for ``ids`` (zeros where absent) — vectorized id-alignment."""
        ids = np.asarray(ids, np.int64)
        entry = self._name_index.get(name)
        if entry is None:
            return np.zeros((ids.shape[0],), np.float32)
        bi, start, w = entry
        pos, found = self._align(bi, ids)
        vals = self._blocks[bi][1]
        out = vals[pos, start:start + w].astype(np.float32, copy=True)
        out[~found] = 0.0
        return out[:, 0] if w == 1 else out

    def assemble(
        self, ids: np.ndarray, schema: Sequence[FeatureSpec]
    ) -> np.ndarray:
        """[B, total_width] matrix in schema order (pure numpy).

        Contiguous schema runs that live in the same stored block slice out
        as ONE fancy-index, so cost scales with the number of hydrator
        blocks (~20), not the number of columns (~6,000).
        """
        ids = np.asarray(ids, np.int64)
        B = ids.shape[0]
        align_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        def aligned(bi):
            if bi not in align_cache:
                align_cache[bi] = self._align(bi, ids)
            return align_cache[bi]

        pieces: List[np.ndarray] = []
        run_bi, run_start, run_end = -1, 0, 0  # current contiguous run

        def flush():
            nonlocal run_bi
            if run_bi < 0:
                return
            pos, found = aligned(run_bi)
            vals = self._blocks[run_bi][1]
            seg = vals[pos, run_start:run_end].astype(np.float32, copy=True)
            seg[~found] = 0.0
            pieces.append(seg)
            run_bi = -1

        for spec in schema:
            entry = self._name_index.get(spec.name)
            if entry is None:
                flush()
                pieces.append(np.zeros((B, spec.width), np.float32))
                continue
            bi, start, w = entry
            if w != spec.width:
                # width mismatch: zero-pad / truncate to the schema width
                flush()
                pos, found = aligned(bi)
                vals = self._blocks[bi][1]
                got = vals[pos, start:start + w].astype(np.float32, copy=True)
                got[~found] = 0.0
                fixed = np.zeros((B, spec.width), np.float32)
                k = min(spec.width, w)
                fixed[:, :k] = got[:, :k]
                pieces.append(fixed)
                continue
            if bi == run_bi and start == run_end:
                run_end = start + w  # extend the contiguous run
            else:
                flush()
                run_bi, run_start, run_end = bi, start, start + w
        flush()
        return (np.concatenate(pieces, axis=1) if pieces
                else np.zeros((B, 0), np.float32))


# -- columnar hydrator base ----------------------------------------------------


def store_of(query) -> ColumnarFeatureStore:
    """The per-request store, created lazily on ``query.features``."""
    store = query.features.get("columnar_store")
    if store is None:
        store = query.features["columnar_store"] = ColumnarFeatureStore()
    return store


def peek_store(query):
    features = getattr(query, "features", None)
    if not isinstance(features, Mapping):
        return None
    return features.get("columnar_store")


class ColumnarFeatureHydrator:
    """A FeatureHydrator that emits vectorized column blocks into the
    request's :class:`ColumnarFeatureStore` instead of per-candidate dicts.

    Subclasses implement :meth:`hydrate_columns` returning
    ``{name: [B] or [B, K] array}`` for the batch — one vectorized (often
    jitted) call, never a per-candidate loop.
    """

    @property
    def name(self) -> str:
        return type(self).__name__

    def hydrate(self, query, candidates, params) -> None:
        if not candidates:
            return
        ids = np.asarray([c.id for c in candidates], np.int64)
        cols = self.hydrate_columns(query, ids, candidates, params)
        store_of(query).add(ids, cols)

    def hydrate_columns(self, query, ids, candidates, params):
        raise NotImplementedError


# -- the wide schema (≥1000 features across the reference's major families) ---
#
# Family constants are shared with mixers/wide_hydrators.py so the schema and
# the hydrator outputs can never drift apart.

def _eb_doc_features() -> Tuple[str, ...]:
    """The earlybird index's per-doc schema IS the eb_* serve family —
    imported from the port's earlybird so the two can never drift."""
    from the_algorithm_tpu_torch.search.earlybird import DOC_FEATURES

    return DOC_FEATURES


EB_DOC_FEATURES = _eb_doc_features()
ENGAGEMENT_LABELS = (
    "fav", "reply", "retweet", "quote", "click", "profile_click",
    "video_view", "share", "bookmark", "dwell", "open_link", "screenshot",
    "report", "negative_feedback", "good_click",
)
AGG_HALFLIVES_S = (1800.0, 86400.0, 7 * 86400.0, 50 * 86400.0)
AGG_HALFLIFE_NAMES = ("30m", "1d", "7d", "50d")
# full exposed metric set per (label, half-life): stored count/sum/sumsq/max
# plus derived mean — the aggregation framework's metric catalog
# (``metrics/{CountMetric,SumMetric,SumSqMetric,MaxMetric}.scala``)
AGG_METRICS = ("count", "sum", "mean", "sumsq", "max")
# keyed crosses beyond user×author — all full-metric now
PAIR_AGG_PREFIXES = (
    "user_author_oon_agg", "user_engager_agg", "user_mention_agg",
    "user_original_author_agg", "user_topic_agg", "user_list_agg",
    "user_dow_agg", "user_hour_agg",
)
# round-3 keyed crosses (TimelinesAggregationConfigDetails keyed groups +
# realtime v2 variants): author×topic, viewer×{source,language,media,
# conversation-root}, and the global per-topic rollup
EXTRA_AGG_PREFIXES = (
    "author_topic_agg", "user_source_agg", "user_language_agg",
    "user_media_agg", "user_conversation_agg", "topic_agg",
)
AUTHOR_META_FEATURES = (
    "author_follower_count_log", "author_following_count_log",
    "author_account_age_days", "author_is_verified",
)
CONTEXT_FEATURES = (
    "retrieval_score", "social_proof", "author_id", "created_ts",
    "is_in_network", "topic_relevance",
)


USS_WINDOW_NAMES = ("90d", "30d", "7d")
# serving-context blocks (request time-of-day/day-of-week one-hots, client
# surface one-hot, page/session scalars — the reference's RequestContext /
# non-ML serving features)
CONTEXT_CLIENTS = 8
CONTEXT_SCALARS = (
    "is_first_page", "refresh_count_log", "session_age_minutes_log",
    "served_depth",
)


# every retrieval source a candidate can carry, for the source one-hot
# block: the JAX package's candidate-pipeline catalog (``catalog_specs``),
# then the in-network / graph / product sources. A frozen copy: the port has
# no catalog yet, and tests/test_torch_hydration.py holds it equal to the
# JAX package's ``candidate_source_names()``.
CANDIDATE_SOURCE_NAMES = (
    "trip_geo_popular", "trip_domain_popular", "two_tower_consumer", "earlybird_model_based",
    "earlybird_tensorflow_based", "offline_simclusters_lookup", "earlybird_in_network",
    "simclusters_interested_in", "simclusters_tweet_based", "simclusters_producer_based",
    "simclusters_promoted_creator", "content_exploration_simclusters_cold", "twhin_consumer_based",
    "twhin_tweet_similarity", "twhin_rebuild_tweet_similarity", "deep_retrieval_user_tweet",
    "deep_retrieval_tweet_tweet", "media_deep_retrieval_user_tweet", "evergreen_dr_user_tweet",
    "content_exploration_dr_tweet_tweet", "uteg", "utg_tweet_based", "utg_producer_based",
    "utg_expansion_tweet_based", "uvg_tweet_based", "uvg_expansion_tweet_based", "uag",
    "popular_topic_tweets", "skit_topic_tweets", "skit_high_precision_topic_tweets",
    "certo_topic_tweets", "popular_geo_tweets", "trends_tweets", "qig_search_history_tweets",
    "twhin_collab_filter", "consumers_based_utg", "producer_based_utg", "tweet_based_unified",
    "diffusion", "content_ann_tweet_based", "dr_tweet_tweet_embedding_similarity",
    "content_exploration_embedding_similarity",
    "content_exploration_embedding_similarity_tier_two", "content_exploration_dr_user_tweet",
    "content_exploration_dr_user_tweet_tier_two", "content_exploration_dr_tweet_tweet_tier_two",
    "content_exploration_evergreen_dr_tweet_tweet", "evergreen_dr_cross_border_user_tweet",
    "media_deep_retrieval_tweet_tweet", "twhin_user_tweet_similarity",
    "twitter_clip_v0_long_video", "twitter_clip_v0_short_video", "semantic_video",
    "evergreen_videos", "trends_video", "events_tweets", "pop_grok_topic_tweets",
    "control_ai_topic", "user_interests_summary", "user_location_tweets", "haplolite",
    "curated_user_tls_per_language", "pinned_tweet_related_creator", "EarlybirdInNetwork",
    "DirectUteg", "FollowingEarlybird", "SubscribedEarlybird", "ListTweetsTimelineService", "ads",
    "ForYouScoredTweets", "backfill", "cached",
)


def candidate_source_names() -> List[str]:
    """Every retrieval source a candidate can carry, for the source one-hot
    block."""
    return list(CANDIDATE_SOURCE_NAMES)


def build_wide_schema() -> List[FeatureSpec]:
    """The full-width heavy-ranker schema (≥6000 flat features — the
    reference's prod hydration width, ``home-mixer/README.md:22-24``).

    Families mirror the reference hydrator families (feature_hydrator/*):
    Earlybird doc features, RealGraph edges, TwHIN user/author/tweet (+
    negative/follow variants), SimClusters engagement similarity (RSX,
    four similarity kinds), SimClusters sparse→dense projections, large
    user/author embeddings, media CLIP clusters, 18 aggregate-framework
    groups at the full metric catalog, USS signal counts over three
    windows, GFS intersections, serving-context and source one-hots.
    """
    from the_algorithm_tpu_torch.features import graph_features, user_signals
    from the_algorithm_tpu_torch.features import representation_scorer as rsx
    from the_algorithm_tpu_torch.graph import realgraph

    schema: List[FeatureSpec] = []
    # earlybird doc features (EarlybirdFeatureHydrator)
    schema += [FeatureSpec(f"eb_{n}") for n in EB_DOC_FEATURES]
    # realgraph edge features (RealGraphQueryFeatureHydrator family)
    for t in realgraph.INTERACTION_TYPES:
        schema.append(FeatureSpec(f"realgraph_{t}_decayed"))
    schema += [
        FeatureSpec("realgraph_days_since"),
        FeatureSpec("realgraph_score"),
        FeatureSpec("realgraph_p_interaction"),
    ]
    # twhin embeddings (TwhinUser*/TwhinAuthorFollow/TwhinUserNegative)
    schema.append(FeatureSpec("twhin_user", 64))
    schema.append(FeatureSpec("twhin_author", 64))
    schema.append(FeatureSpec("twhin_tweet", 64))
    schema.append(FeatureSpec("twhin_user_negative", 64))
    schema.append(FeatureSpec("twhin_author_follow", 64))
    # RSX engagement-similarity features (SimClustersEngagementSimilarity…):
    # kind × signal × window × {min,avg,max} (cosine keeps bare names)
    for kind in rsx.SIMILARITY_KINDS:
        prefix = "rsx_" if kind == "cosine" else f"rsx_{kind}_"
        for w in rsx.WINDOWS_S:  # ordered as the RSX kernel emits
            for sig in rsx.SIGNAL_TYPES:
                for agg in ("avg", "max", "min"):
                    schema.append(FeatureSpec(f"{prefix}{sig}_{w}_{agg}"))
    # simclusters sparse→dense bucket projections (viewer InterestedIn,
    # candidate tweet embedding — UserSimClusters / TweetSimClusters
    # hydrator families)
    schema.append(FeatureSpec("user_simclusters_proj", 64))
    schema.append(FeatureSpec("tweet_simclusters_proj", 64))
    # large embeddings (user interests / author aggregates)
    schema.append(FeatureSpec("user_interests_emb", 128))
    schema.append(FeatureSpec("author_agg_emb", 128))
    # media CLIP clusters (MediaClusterFeatureHydrator)
    schema.append(FeatureSpec("media_clip_clusters", 64))
    # tweet text embedding (TweetTextEmbedding hydrator family)
    schema.append(FeatureSpec("text_emb", 128))
    # aggregate framework groups, full metric catalog:
    # entity rollups (tweet / author / viewer), the user×author cross, the
    # keyed crosses, and the round-3 groups — every group is
    # label × {count,sum,mean,sumsq,max} × half-life
    for prefix in (
        "tweet_agg", "author_agg", "user_agg", "user_author_agg",
        *PAIR_AGG_PREFIXES, *EXTRA_AGG_PREFIXES,
    ):
        for label in ENGAGEMENT_LABELS:
            for hl in AGG_HALFLIFE_NAMES:  # ordered as the hydrator emits
                for metric in AGG_METRICS:
                    schema.append(
                        FeatureSpec(f"{prefix}_{label}_{metric}_{hl}"))
    # USS signal counts per signal type × window (UserSignalService)
    for w in USS_WINDOW_NAMES:
        for sig in user_signals.SignalType:
            schema.append(FeatureSpec(f"uss_{sig.name.lower()}_count_{w}"))
    # graph feature service intersections (canonical GFS pairs + normalized)
    for n in graph_features.FEATURE_PAIRS:
        schema.append(FeatureSpec(n))
        schema.append(FeatureSpec(n + "_normalized"))
    # author reputation + account meta + follow relation
    schema.append(FeatureSpec("tweepcred"))
    schema += [FeatureSpec(n) for n in AUTHOR_META_FEATURES]
    schema += [
        FeatureSpec("viewer_follows_author"),
        FeatureSpec("author_follows_viewer"),
    ]
    # retrieval/context scalars lifted from the candidate object model
    schema += [FeatureSpec(n) for n in CONTEXT_FEATURES]
    # serving context: request-time one-hots + session scalars
    schema.append(FeatureSpec("ctx_hour_of_day", 24))
    schema.append(FeatureSpec("ctx_day_of_week", 7))
    schema.append(FeatureSpec("ctx_client", CONTEXT_CLIENTS))
    schema += [FeatureSpec(f"ctx_{n}") for n in CONTEXT_SCALARS]
    # candidate retrieval-source one-hot (the source-attribution block)
    schema.append(
        FeatureSpec("source_onehot", len(candidate_source_names())))
    return schema


WIDE_SCHEMA = build_wide_schema()
