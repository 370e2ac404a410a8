"""Representation Manager (RMS): one facade for every embedding lookup.

Counterpart of ``the_algorithm_tpu/simclusters/representation_manager.py``
(``representation-manager/server/.../store/{User,Tweet,Topic}
SimClustersEmbeddingStore.scala`` and the client ``StoreBuilder``): a typed
facade that serves SimClusters embeddings for users, tweets and topics from
underlying stores, with a host cache in front of a store.

A :class:`TableEmbeddingStore` holds an [N, K] (cluster id, score) table on
its device; a multiget maps entity ids to rows on the host and reads both
tables with one ``row_gather`` launch (K·4-byte rows: the TMA ring where K is
a multiple of 4, else the word kernel). A :class:`CachedEmbeddingStore`
is a host LRU+TTL cache with an injected clock: a hit is host rows, a miss a
fetch from the store beneath, read back through ``host_array``; its answer
goes to the device of the store beneath.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array, resolve
from the_algorithm_tpu_torch.core.metrics import NullStats, StatsReceiver
from the_algorithm_tpu_torch.ops.gather import row_gather
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding


class EntityKind(enum.Enum):
    """≡ thrift ``InternalId`` arms used by RMS columns."""

    USER = "user"
    TWEET = "tweet"
    TOPIC = "topic"


class EmbeddingKind(enum.Enum):
    """≡ thrift ``EmbeddingType`` values RMS serves (``embedding.thrift``)."""

    FAV_BASED_PRODUCER = "FavBasedProducer"
    FOLLOW_BASED_PRODUCER = "FollowBasedProducer"
    AGGREGATABLE_PRODUCER = "AggregatableLogFavBasedProducer"
    FAV_BASED_USER_INTERESTED_IN = "FavBasedUserInterestedIn"
    FOLLOW_BASED_USER_INTERESTED_IN = "FollowBasedUserInterestedIn"
    LOG_FAV_BASED_TWEET = "LogFavBasedTweet"
    FAV_TFG_TOPIC = "FavTfgTopic"
    LOG_FAV_BASED_KGO_TOPIC = "LogFavBasedKgoApeTopic"


@dataclasses.dataclass(frozen=True)
class EmbeddingId:
    """≡ ``SimClustersEmbeddingId`` (embedding.thrift): what × version × who."""

    kind: EmbeddingKind
    entity: EntityKind
    model_version: str = "20m145k2020"


class EmbeddingStore(Protocol):
    """A store serves a batch of entity ids → padded sparse embeddings."""

    device: torch.device

    def multiget(self, ids: np.ndarray) -> SparseEmbedding:  # [B] → [B, K]
        ...


class TableEmbeddingStore:
    """An [N, K] embedding table on a device; a multiget is one row gather.

    ``row_of``: the host's entity id → row mapping. A missing id reads an
    all-PAD row (the reference returns an empty embedding on a miss).
    """

    def __init__(self, cluster_ids: torch.Tensor, scores: torch.Tensor, row_of: Dict[int, int]):
        if cluster_ids.shape != scores.shape or cluster_ids.device != scores.device:
            raise ValueError(f"ids {tuple(cluster_ids.shape)} on {cluster_ids.device} and scores "
                             f"{tuple(scores.shape)} on {scores.device} must match")
        self.cluster_ids = cluster_ids.to(torch.int32).contiguous()
        self.scores = scores.to(torch.float32).contiguous()
        self.row_of = row_of
        self._k = int(cluster_ids.shape[1])

    @property
    def capacity(self) -> int:
        return self._k

    @property
    def device(self) -> torch.device:
        return self.cluster_ids.device

    def multiget(self, ids: np.ndarray) -> SparseEmbedding:
        rows = np.asarray([self.row_of.get(int(i), -1) for i in np.asarray(ids).reshape(-1)], np.int32)
        present = torch.from_numpy(rows >= 0).to(self.device)[:, None]
        safe = torch.from_numpy(np.where(rows >= 0, rows, 0).astype(np.int32)).to(self.device)
        out_ids, out_scores = row_gather(safe, self.cluster_ids, self.scores)
        return SparseEmbedding(torch.where(present, out_ids, PAD_ID), torch.where(present, out_scores, 0.0))


class CachedEmbeddingStore:
    """Host LRU+TTL cache in front of a store (the memcache layer).

    ≡ ``representation-manager`` cache modules: per-entity cached rows with a
    TTL; eviction is LRU at ``max_items``. Only the missing ids reach the
    store beneath (one multiget, so one row gather on a table store); the
    answer is built on the host and copied to that store's device.
    """

    def __init__(
        self,
        underlying: EmbeddingStore,
        *,
        ttl_s: float = 600.0,
        max_items: int = 100_000,
        stats: Optional[StatsReceiver] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.underlying = underlying
        self.ttl_s = ttl_s
        self.max_items = max_items
        self.stats = (stats or NullStats()).scope("rms_cache")
        self._clock = clock
        self._cache: "OrderedDict[int, Tuple[float, np.ndarray, np.ndarray]]" = OrderedDict()

    @property
    def device(self) -> torch.device:
        return self.underlying.device

    def multiget(self, ids: np.ndarray) -> SparseEmbedding:
        ids = np.asarray(ids).reshape(-1)
        now = self._clock()
        missing: list = []
        hit_rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for i in ids:
            key = int(i)
            entry = self._cache.get(key)
            if entry is not None and now - entry[0] <= self.ttl_s:
                self._cache.move_to_end(key)
                hit_rows[key] = (entry[1], entry[2])
            else:
                missing.append(key)
        self.stats.counter("hits", len(ids) - len(missing))
        self.stats.counter("misses", len(missing))
        if missing:
            fetched = self.underlying.multiget(np.asarray(missing, np.int64))
            f_ids, f_scores = host_array(fetched.ids), host_array(fetched.scores)
            for j, key in enumerate(missing):
                self._cache[key] = (now, f_ids[j], f_scores[j])
                self._cache.move_to_end(key)
                hit_rows[key] = (f_ids[j], f_scores[j])
            while len(self._cache) > self.max_items:
                self._cache.popitem(last=False)
        out_ids = np.stack([hit_rows[int(i)][0] for i in ids])
        out_scores = np.stack([hit_rows[int(i)][1] for i in ids])
        return SparseEmbedding(torch.from_numpy(out_ids).to(self.device), torch.from_numpy(out_scores).to(self.device))


class RepresentationManager:
    """The facade: an (EmbeddingId → store) registry with typed lookups.

    ≡ the RMS Strato column surface: every consumer (the SANN source
    embedding fetch, RSX pair scoring, TSPS topic relevance) resolves
    embeddings here.
    """

    def __init__(self, stats: Optional[StatsReceiver] = None):
        self._stores: Dict[EmbeddingId, EmbeddingStore] = {}
        self.stats = (stats or NullStats()).scope("rms")

    def register(self, eid: EmbeddingId, store: EmbeddingStore) -> None:
        self._stores[eid] = store

    def has(self, eid: EmbeddingId) -> bool:
        return eid in self._stores

    def multiget(self, eid: EmbeddingId, ids) -> SparseEmbedding:
        store = self._stores.get(eid)
        if store is None:
            raise KeyError(f"no store registered for {eid}")
        self.stats.counter(f"{eid.kind.value}/requests", len(ids))
        return store.multiget(np.asarray(ids))

    def get(self, eid: EmbeddingId, entity_id: int) -> SparseEmbedding:
        batch = self.multiget(eid, np.asarray([entity_id]))
        return SparseEmbedding(batch.ids[0], batch.scores[0])


def store_from_pairs(
    entity_ids: Sequence[int],
    cluster_ids: np.ndarray,  # [N, K]
    scores: np.ndarray,  # [N, K]
    *,
    cached: bool = False,
    ttl_s: float = 600.0,
    device=None,
) -> EmbeddingStore:
    """≡ the client ``StoreBuilder``: a (cached) table store, its tables on
    the card unless ``device`` names another."""
    dev = resolve(device, "store_from_pairs")
    row_of = {int(e): i for i, e in enumerate(entity_ids)}
    store: EmbeddingStore = TableEmbeddingStore(
        torch.from_numpy(np.asarray(cluster_ids).astype(np.int32)).to(dev),
        torch.from_numpy(np.asarray(scores).astype(np.float32)).to(dev),
        row_of,
    )
    if cached:
        store = CachedEmbeddingStore(store, ttl_s=ttl_s)
    return store
