"""Earlybird index persistence, feature updates, and query caching.

Counterpart of ``the_algorithm_tpu/search/persistence.py`` (three earlybird
subsystems, SURVEY.md §2.1, §5.3-5.4):

- **flush/load** (``earlybird/partition/{EarlybirdIndexFlusher,
  EarlybirdIndexLoader,KafkaStartup}.java``): the index snapshots to one
  ``.npz`` with the ingest-log offset it covers, and :func:`load_index`
  replays the log's tail through the normal ``ingest`` path. The ``.npz``
  is the contract between the packages: a snapshot either flushed loads in
  the other to the same index (``write_pos`` is saved as JAX's int32 scalar).
- **feature-update service** (``earlybird/feature_update_service/``): live
  engagement counters written into the index keyed by tweet id.
- **query cache** (``earlybird/querycache/``): a TTL cache invalidated by
  index writes (host code, copied).

Where the port differs: :func:`load_index` refuses a snapshot whose
feature width is not ``len(DOC_FEATURES)`` unless the caller names the
width (the JAX loader takes any width, and a snapshot of an older schema
then scores with its columns shifted); and the feature updates find a tweet
id's slot through a stable sort of the id column and ``searchsorted``
instead of JAX's [B, T] equality mask (1 GB of bools at B = 4,096 and
T = 262,144), with JAX's rules: the first (lowest) slot of an id held twice
wins, and a miss is dropped. Every function returns a new index; none
writes the tables of the one it was given.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.search.earlybird import DOC_FEATURES, EarlybirdIndex, ingest


def flush_index(index: EarlybirdIndex, path: str, log_offset: int) -> None:
    """Snapshot the index + the ingest-log offset it covers."""
    np.savez_compressed(
        path,
        tokens=host_array(index.tokens),
        author=host_array(index.author),
        created_ts=host_array(index.created_ts),
        features=host_array(index.features),
        tweet_ids=host_array(index.tweet_ids),
        write_pos=np.asarray(index.write_pos, np.int32),
        log_offset=np.asarray(log_offset, np.int64),
    )


def load_index(
    path: str,
    replay: Optional[Callable[[int], Tuple]] = None,
    *,
    num_features: Optional[int] = None,
    device=None,
) -> Tuple[EarlybirdIndex, int]:
    """Load a flushed snapshot onto ``device`` (default: the card); if
    ``replay(offset)`` is given, it must return batched ingest args for log
    entries past ``offset`` (or None) — the Kafka catch-up of
    ``KafkaStartup.java``. Returns (index, offset after replay).

    The snapshot's feature width must be ``num_features``, by default
    ``len(DOC_FEATURES)``; any other raises ``ValueError``."""
    want = len(DOC_FEATURES) if num_features is None else int(num_features)
    with np.load(path) as z:
        width = z["features"].shape[1]
        if width != want:
            raise ValueError(f"snapshot {path} holds {width} feature columns, the schema has {want} "
                             "(pass num_features to load another width)")
        index = EarlybirdIndex.from_numpy(z["tokens"], z["author"], z["created_ts"], z["features"],
                                          z["tweet_ids"], int(z["write_pos"]), device=device)
        offset = int(z["log_offset"])
    if replay is not None:
        tail = replay(offset)
        if tail is not None:
            tokens, authors, ts, feats, ids, new_offset = tail
            if len(host_array(ids)):
                index = ingest(index, *(torch.from_numpy(np.array(host_array(a))) for a in (tokens, authors, ts, feats, ids)))
            offset = new_offset
    return index, offset


# -- archive tier: realtime roll-off -------------------------------------------


def roll_expired(
    realtime: EarlybirdIndex,
    archive: EarlybirdIndex,
    *,
    now: int,
    retention_s: int,
) -> Tuple[EarlybirdIndex, EarlybirdIndex, int]:
    """Move documents older than the realtime retention into the archive
    tier (≡ the segment optimizer + ``EarlybirdIndexFlusher`` roll-off that
    keeps the realtime cluster at ~7 days and hands older segments to the
    full-archive cluster, ``src/java/com/twitter/search/README.md:15``).

    Host-side maintenance pass: expired live docs append into the archive
    ring via the normal ``ingest`` path, in slot order; their realtime slots
    empty (author/tweet_id → PAD). Returns (new_realtime, new_archive,
    n_rolled).
    """
    author = host_array(realtime.author)
    ts = host_array(realtime.created_ts)
    live = author != PAD_ID
    expired = live & (ts.astype(np.int64) < int(now) - int(retention_s))
    n = int(expired.sum())
    if n == 0:
        return realtime, archive, 0
    sel = torch.from_numpy(np.nonzero(expired)[0]).to(realtime.author.device)
    archive = ingest(archive, realtime.tokens[sel], realtime.author[sel], realtime.created_ts[sel],
                     realtime.features[sel], realtime.tweet_ids[sel])
    exp = torch.from_numpy(expired).to(realtime.author.device)
    realtime = realtime._replace(
        author=torch.where(exp, PAD_ID, realtime.author),
        tweet_ids=torch.where(exp, PAD_ID, realtime.tweet_ids),
    )
    return realtime, archive, n


# -- feature-update service ----------------------------------------------------


def find_slots(index: EarlybirdIndex, tweet_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, found) of each id [B] in the ring: the lowest slot holding it
    (a stable sort of the id column keeps equal ids in slot order, and
    ``searchsorted`` finds the first), ``found`` False for a miss."""
    col = index.tweet_ids
    sorted_ids, order = torch.sort(col, stable=True)
    q = tweet_ids.to(col.device, torch.int32)
    pos = torch.searchsorted(sorted_ids, q).clamp_(max=col.shape[0] - 1)
    return order[pos], sorted_ids[pos] == q


def _feature_scatter(index, tweet_ids, feature_idx, values, accumulate: bool) -> EarlybirdIndex:
    dev = index.features.device
    ids = torch.as_tensor(tweet_ids).to(dev).reshape(-1)
    vals = torch.as_tensor(values).to(dev, torch.float32).reshape(-1)
    cols = torch.as_tensor(feature_idx).to(dev, torch.int64).expand(ids.shape[0])
    slot, found = find_slots(index, ids)
    features = index.features.index_put((slot[found], cols[found]), vals[found], accumulate=accumulate)
    return index._replace(features=features)


def apply_feature_updates(
    index: EarlybirdIndex,
    tweet_ids: torch.Tensor,  # [B] external ids to update
    feature_idx: Union[int, torch.Tensor],  # [B] (or one) doc-feature column
    values: torch.Tensor,  # [B] new values
) -> EarlybirdIndex:
    """Engagement-counter updates keyed by tweet id, into a new index.

    Ids not in the ring (already evicted — the reference drops these too)
    are ignored; an id held in two slots updates the lower. Which of two
    updates of one (slot, column) in a batch survives is unspecified, here
    as in the JAX package (an indexed set with repeated indices).
    """
    return _feature_scatter(index, tweet_ids, feature_idx, values, accumulate=False)


def increment_feature(
    index: EarlybirdIndex,
    tweet_ids: torch.Tensor,
    feature_idx: Union[int, torch.Tensor],
    deltas: torch.Tensor,
) -> EarlybirdIndex:
    """Additive variant (fav_count += 1 streams): deltas of one (slot,
    column) accumulate (``index_put_(accumulate=True)``, JAX's ``.add``);
    misses are dropped."""
    return _feature_scatter(index, tweet_ids, feature_idx, deltas, accumulate=True)


# -- query cache ----------------------------------------------------------------


class QueryCache:
    """TTL + write-generation query cache (≡ ``earlybird/querycache/``).

    A cached entry is valid while (a) younger than ``ttl_s`` and (b) the
    index generation hasn't advanced past ``max_stale_writes`` ingests since
    the entry was stored — recency queries tolerate slightly stale results
    (the reference refreshes cached queries on a schedule, not per write).
    """

    def __init__(
        self,
        max_items: int = 1024,
        ttl_s: float = 5.0,
        max_stale_writes: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_items = max_items
        self.ttl_s = ttl_s
        self.max_stale_writes = max_stale_writes
        self._clock = clock
        self._generation = 0
        self._cache: "OrderedDict[Tuple, Tuple[float, int, object]]" = (
            OrderedDict()
        )
        self.hits = 0
        self.misses = 0

    def on_write(self, n_batches: int = 1) -> None:
        self._generation += n_batches

    def get_or_compute(self, key: Tuple, compute: Callable[[], object]):
        now = self._clock()
        entry = self._cache.get(key)
        if entry is not None:
            t, gen, value = entry
            if (
                now - t <= self.ttl_s
                and self._generation - gen <= self.max_stale_writes
            ):
                self._cache.move_to_end(key)
                self.hits += 1
                return value
            del self._cache[key]
        self.misses += 1
        value = compute()
        self._cache[key] = (now, self._generation, value)
        while len(self._cache) > self.max_items:
            self._cache.popitem(last=False)
        return value
