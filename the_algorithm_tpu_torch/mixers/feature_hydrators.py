"""Concrete home-mixer feature hydrators + side effects.

≡ the hydrator library under ``home-mixer/server/.../functional_component/
feature_hydrator/`` (109 files) and ``product/scored_tweets/feature_hydrator/``
— each reference hydrator batches an RPC multiget against a feature store;
here each is one vectorized device call against the corresponding
in-process subsystem:

- :class:`EarlybirdFeatureHydrator`        ≡ ``EarlybirdFeatureHydrator.scala``
- :class:`RealGraphFeatureHydrator`        ≡ ``RealGraphQueryFeatureHydrator`` /
  ``RealGraphViewerAuthorFeatureHydrator``
- :class:`TweepcredFeatureHydrator`        ≡ author-reputation hydration
- :class:`GraphFeatureServiceHydrator`     ≡ GFS-backed two-hop features
  (``graph-feature-service`` intersections: follows-who-faved etc.)
- :class:`SimClustersEngagementSimilarityFeatureHydrator`
  ≡ ``SimClustersEngagementSimilarityFeatureHydrator.scala`` (RSX block)
- :class:`TwhinEmbeddingFeatureHydrator`   ≡ ``TwhinUser{Positive,Negative}``/
  tweet-embedding hydrators (dot products as features)
- :class:`AggregatesFeatureHydrator`       ≡ aggregation-framework DataRecord
  hydration (decayed counts per (user) or (author) key)
- :class:`RecentEngagementsQueryHydrator`  ≡ USS recent-engagements fetch
- :class:`ScribeServedCandidatesSideEffect`≡ ``HomeScribeServedCandidates…``
- :class:`ImpressionBloomFilterSideEffect` ≡ ``PublishImpressionBloomFilter…``

Counterpart of ``the_algorithm_tpu/mixers/feature_hydrators.py``. The
device reads (GFS, RSX, the aggregate store, USS) run where their tables
live and come back to the host once a batch; the TwHIN tables of
:class:`TwhinEmbeddingFeatureHydrator` and the tweepcred vector are host
copies, as the JAX package takes them (``np.asarray``).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array, resolve
from the_algorithm_tpu_torch.core.hashing import murmur3_x64_128
from the_algorithm_tpu_torch.features import aggregation, graph_features
from the_algorithm_tpu_torch.features import representation_scorer as rsx
from the_algorithm_tpu_torch.features import user_signals
from the_algorithm_tpu_torch.models import phoenix
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    FeatureHydrator,
    QueryFeatureHydrator,
    SideEffect,
)


def _author_ids(candidates: List[Candidate]) -> np.ndarray:
    return np.asarray(
        [int(c.features.get("author_id", -1)) for c in candidates], np.int32
    )


def _ids(candidates: List[Candidate]) -> np.ndarray:
    return np.asarray([c.id for c in candidates], np.int32)


class EarlybirdFeatureHydrator(FeatureHydrator):
    """Per-tweet engagement-count features from a tweet feature table.

    ``tweet_features``: {tweet_id: {name: value}} or a callable
    ``ids -> {name: [B] array}`` (the in-index Earlybird doc features).
    """

    FEATURES = ("fav_count", "reply_count", "retweet_count", "created_ts")

    def __init__(self, tweet_features):
        self._src = tweet_features

    def hydrate(self, query, candidates, params) -> None:
        if not candidates:
            return
        if callable(self._src):
            block = self._src(_ids(candidates))
            for j, c in enumerate(candidates):
                for name, col in block.items():
                    c.features[name] = float(col[j])
            return
        for c in candidates:
            row = self._src.get(c.id)
            if row:
                c.features.update(row)


class RealGraphFeatureHydrator(FeatureHydrator):
    """user→author interaction strength (the RealGraph edge weight).

    ``score_fn(user_id, author_ids[B]) -> [B]`` should wrap a jitted lookup
    over the RealGraph :class:`EdgeTable` + p(interaction) model
    (``graph/realgraph.py``).
    """

    def __init__(self, score_fn: Callable[[int, np.ndarray], np.ndarray]):
        self._score_fn = score_fn

    def hydrate(self, query, candidates, params) -> None:
        if not candidates:
            return
        scores = np.asarray(self._score_fn(query.user_id, _author_ids(candidates)))
        for j, c in enumerate(candidates):
            c.features["realgraph_score"] = float(scores[j])


class TweepcredFeatureHydrator(FeatureHydrator):
    """Author reputation [0,100] (``graph/tweepcred.py`` output)."""

    def __init__(self, reputation: np.ndarray):
        self._rep = host_array(reputation)

    def hydrate(self, query, candidates, params) -> None:
        authors = _author_ids(candidates)
        ok = (authors >= 0) & (authors < self._rep.shape[0])
        vals = np.where(ok, self._rep[np.clip(authors, 0, self._rep.shape[0] - 1)], 0.0)
        for j, c in enumerate(candidates):
            c.features["tweepcred"] = float(vals[j])


class GraphFeatureServiceHydrator(FeatureHydrator):
    """Two-hop social-proof counts: of the viewer's follows, how many
    faved/retweeted/followed each candidate's author (GFS intersections)."""

    def __init__(self, tables: graph_features.GraphTables):
        self._tables = tables

    def hydrate(self, query, candidates, params) -> None:
        if not candidates:
            return
        dev = self._tables.neighbors.device
        block = graph_features.feature_block(
            self._tables,
            int(query.user_id),
            torch.from_numpy(_author_ids(candidates).clip(min=0)).to(dev),
        )
        for name, col in block.items():
            col = col.cpu().numpy()
            for j, c in enumerate(candidates):
                c.features[name] = float(col[j])


class SimClustersEngagementSimilarityFeatureHydrator(FeatureHydrator):
    """RSX block: cosine(candidate embedding, user's recent engagement
    tweets) with min/avg/max × signal × window aggregations."""

    def __init__(
        self,
        tweet_embedding_fn,  # ids [B] -> SparseEmbedding [B, K]
        engagement_fn,  # user_id -> rsx.EngagementSet
    ):
        self._emb = tweet_embedding_fn
        self._eng = engagement_fn

    def hydrate(self, query, candidates, params) -> None:
        if not candidates:
            return
        cand_emb = self._emb(_ids(candidates))
        engagements = self._eng(query.user_id)
        block = rsx.engagement_similarity_features(
            cand_emb, engagements, int(query.now)
        )
        for name, col in block.items():
            col = col.cpu().numpy()
            for j, c in enumerate(candidates):
                c.features[name] = float(col[j])


class TwhinEmbeddingFeatureHydrator(FeatureHydrator):
    """TwHIN dense-embedding features: viewer·tweet dot product (positive
    and, with a negative user table, TwhinUserNegative)."""

    def __init__(
        self,
        user_table: np.ndarray,  # [U, D]
        tweet_table: np.ndarray,  # [T, D]
        negative_user_table: Optional[np.ndarray] = None,
    ):
        self._u = host_array(user_table)
        self._t = host_array(tweet_table)
        self._n = None if negative_user_table is None else host_array(
            negative_user_table
        )

    def hydrate(self, query, candidates, params) -> None:
        if not candidates:
            return
        ids = _ids(candidates).clip(min=0) % self._t.shape[0]
        u = self._u[query.user_id % self._u.shape[0]]
        dots = self._t[ids] @ u
        ndots = None
        if self._n is not None:
            ndots = self._t[ids] @ self._n[query.user_id % self._n.shape[0]]
        for j, c in enumerate(candidates):
            c.features["twhin_user_tweet_dot"] = float(dots[j])
            if ndots is not None:
                c.features["twhin_user_negative_dot"] = float(ndots[j])


class AggregatesFeatureHydrator(FeatureHydrator):
    """Decayed aggregate counts keyed by author (or tweet): the
    aggregation-framework DataRecord hydration."""

    def __init__(
        self,
        group: aggregation.AggregateGroup,
        store: aggregation.AggregateStore,
        resolver: aggregation.KeyResolver,
        key_fn: Callable[[Any, Candidate], tuple] = lambda q, c: (
            c.features.get("author_id", -1),
        ),
        prefix: str = "",
    ):
        self._group = group
        self._store = store
        self._resolver = resolver
        self._key_fn = key_fn
        self._prefix = prefix

    def hydrate(self, query, candidates, params) -> None:
        if not candidates:
            return
        rows = self._resolver.resolve(
            [self._key_fn(query, c) for c in candidates]
        )
        rows = torch.from_numpy(rows).to(self._store.values.device)
        block = aggregation.read(
            self._group, self._store, rows, int(query.now)
        ).cpu().numpy()
        names = self._group.output_names()
        for j, c in enumerate(candidates):
            for k, name in enumerate(names):
                c.features[self._prefix + name] = float(block[j, k])


class RecentEngagementsQueryHydrator(QueryFeatureHydrator):
    """USS fetch of the viewer's recent positive engagements into query
    features (feeds RSX + UTEG seeding)."""

    def __init__(
        self,
        store: user_signals.SignalStore,
        signal_types: Sequence[user_signals.SignalType] = (
            user_signals.SignalType.TWEET_FAVORITE,
            user_signals.SignalType.RETWEET,
            user_signals.SignalType.REPLY,
        ),
    ):
        self._store = store
        self._types = tuple(signal_types)

    def hydrate(self, query, params) -> Dict[str, Any]:
        ids, ts, valid, types = (
            t.cpu().numpy() for t in user_signals.fetch_engagement_tweets(
                self._store, int(query.user_id), self._types)
        )
        return {
            "recent_engagement_ids": ids[valid],
            "recent_engagement_ts": ts[valid],
            "recent_engagement_types": types[valid],
        }


class UserActionsQueryHydrator(QueryFeatureHydrator):
    """Assemble the viewer's aggregated action sequence for Phoenix scoring.

    ≡ ``UserActionsQueryFeatureHydrator.scala``: raw action events → 5-minute
    window aggregation, maxLength truncation (reference 1024), optional
    dwell exclusion (the dense variant); exposes ``user_actions`` (device
    arrays, on ``device``: the card unless it names another),
    ``user_actions_size``, and the explicit-signal marker.
    """

    EXPLICIT = frozenset(
        ("SERVER_TWEET_FAV", "SERVER_TWEET_REPLY", "SERVER_TWEET_RETWEET",
         "SERVER_TWEET_QUOTE", "SERVER_USER_FOLLOW")
    )

    def __init__(
        self,
        events_fn: Callable[[int], Sequence[tuple]],  # user_id -> [(ts_ms, action_id, author_hash)]
        max_length: int = 256,
        exclude_dwells: bool = False,
        device=None,
    ):
        self._events = events_fn
        self._max_length = max_length
        self._exclude_dwells = exclude_dwells
        self._device = resolve(device, "UserActionsQueryHydrator")

    def hydrate(self, query, params) -> Dict[str, Any]:
        events = list(self._events(query.user_id))
        out = phoenix.aggregate_history(
            events,
            now_ms=int(query.now) * 1000,
            max_length=self._max_length,
            exclude_dwells=self._exclude_dwells,
        )
        seq = phoenix.UserActionSequence(
            *(torch.from_numpy(out[k]).to(self._device)
              for k in ("action_ids", "author_hashes", "age_s", "valid"))
        )
        explicit_ids = {
            int(phoenix.ActionName[n]) for n in self.EXPLICIT
        }
        has_explicit = bool(
            set(out["action_ids"][out["valid"]].tolist()) & explicit_ids
        )
        size = int(out["valid"].sum())
        return {
            "user_actions": seq if size else None,
            "user_actions_size": size,
            "user_actions_contains_explicit_signals": has_explicit,
        }


# -- side effects -------------------------------------------------------------


class ScribeServedCandidatesSideEffect(SideEffect):
    """Log served candidates for training-data closure
    (≡ ``HomeScribeServedCandidatesSideEffect.scala``): JSON lines through a
    sink callable (file append, Kafka producer, ...)."""

    def __init__(self, sink: Callable[[str], None], served_key: str = "home"):
        self._sink = sink
        self._key = served_key

    def run(self, query, result, params) -> None:
        record = {
            "key": self._key,
            "user_id": int(query.user_id),
            "served_at": int(getattr(query, "now", 0) or time.time()),
            "candidates": [
                {
                    "tweet_id": int(c.id),
                    "score": None if c.score is None else float(c.score),
                    "source": c.source,
                    "predicted": {
                        k: float(v)
                        for k, v in c.features.items()
                        if k.startswith("predicted_")
                    },
                }
                for c in result
            ],
        }
        self._sink(json.dumps(record, separators=(",", ":")))


class BloomFilter:
    """Plain m-bit k-hash bloom filter over int64 keys (murmur3-derived)."""

    def __init__(self, n_bits: int = 1 << 16, n_hashes: int = 4):
        assert n_bits & (n_bits - 1) == 0
        self.bits = np.zeros(n_bits, bool)
        self.n_hashes = n_hashes

    def _slots(self, key: int) -> List[int]:
        h1, h2 = murmur3_x64_128(int(key).to_bytes(8, "little", signed=True))
        return [
            (h1 + i * h2) % self.bits.shape[0] for i in range(self.n_hashes)
        ]

    def add(self, key: int) -> None:
        for s in self._slots(key):
            self.bits[s] = True

    def __contains__(self, key: int) -> bool:
        return all(self.bits[s] for s in self._slots(key))


class ImpressionBloomFilterSideEffect(SideEffect):
    """Record served tweet ids in a per-user bloom filter so later requests
    can cheaply drop already-shown tweets
    (≡ ``PublishImpressionBloomFilterSideEffect.scala``)."""

    def __init__(self, filters: Optional[Dict[int, BloomFilter]] = None):
        self.filters = filters if filters is not None else {}

    def run(self, query, result, params) -> None:
        bf = self.filters.get(query.user_id)
        if bf is None:
            bf = self.filters[query.user_id] = BloomFilter()
        for c in result:
            bf.add(c.id)

    def seen(self, user_id: int, tweet_id: int) -> bool:
        bf = self.filters.get(user_id)
        return bf is not None and tweet_id in bf


class ScribeClientEventSideEffect(SideEffect):
    """Log client-visible serving events in the raw LogEvent shape the UUA
    ClientEventAdapter consumes (≡ ``HomeScribeClientEventSideEffect.scala``
    — the second half of the training-data closure: served impressions flow
    back in as client events).

    Emits one ``{user_id, item_type, action, item_id, ts_ms, author_id,
    surface, position}`` JSON line per served candidate.
    """

    def __init__(self, sink: Callable[[str], None], surface: str = "home",
                 action: str = "impression"):
        self._sink = sink
        self._surface = surface
        self._action = action

    def run(self, query, result, params) -> None:
        now_ms = int(getattr(query, "now", 0) or time.time()) * 1000
        for pos, c in enumerate(result):
            self._sink(json.dumps({
                "user_id": int(query.user_id),
                "item_type": "tweet",
                "action": self._action,
                "item_id": int(c.id),
                "ts_ms": now_ms,
                "author_id": c.features.get("author_id"),
                "surface": self._surface,
                "position": pos,
            }, separators=(",", ":")))
