"""Streaming updates into the LIVE device-resident serve state.

Counterpart of ``the_algorithm_tpu/mixers/live_updates.py``: the reference's
realtime ingestion loops (the Storm tweet job folding ~6K fav-events/s into
the SimClusters indexes, ``TweetJob.scala:33-110``; the Heron realtime
aggregates; the User Signal Service rings), folded straight into the tables
the batched engine serves from.

A **single writer** folds each event micro-batch into NEW tables and swaps
the scorer's ``tables`` in one assignment (copy-on-write): the aggregate
stores are folded and packed into a fresh ``agg_packed`` buffer with fresh
views, the rings and the engagement history are copied and their touched
rows written once. Nothing the serve thread may be reading is written in
place; a serve batch reads ``scorer.tables`` once (its snapshot) and the
next batch sees the new tables.

The JAX package pushes ring events with a ``lax.scan``, one event per step.
:func:`_push_rows` composes a batch at once: the events sorted by key
(stably), each event's slot (run length − 1 − its position in its run),
slots ≥ W dropped, the old row shifted right by the run length, and each
touched row written once. The plan is made on the host from the batch's
numpy columns; the device gathers and writes.

Freshness contract (``tests/test_torch_live_updates.py``): an event folded
by :meth:`LiveUpdater.apply` is visible to every request scored after it
returns — the candidate's aggregate features (and, after
:meth:`LiveUpdater.refresh_index`, its retrieval rank) move in the very
next request.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.features import aggregation
from the_algorithm_tpu_torch.features.user_signals import SignalType
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import wide_hydrators as wh
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.simclusters import tweet_embeddings as te

# engagement label index (fs.ENGAGEMENT_LABELS order) per UUA-ish action
LABEL_OF_ACTION = {
    "fav": 0, "reply": 1, "retweet": 2, "quote": 3, "click": 4,
    "profile_click": 5, "video_view": 6, "share": 7, "bookmark": 8,
    "dwell": 9, "open_link": 10, "screenshot": 11, "report": 12,
    "negative_feedback": 13, "good_click": 14,
}
SIGNAL_OF_ACTION = {
    "fav": int(SignalType.TWEET_FAVORITE),
    "retweet": int(SignalType.RETWEET),
    "reply": int(SignalType.REPLY),
    "share": int(SignalType.TWEET_SHARE),
    "bookmark": int(SignalType.TWEET_BOOKMARK),
    "click": int(SignalType.TWEET_CLICK),
    "video_view": int(SignalType.TWEET_VIDEO_QUALITY_VIEW),
    "profile_click": int(SignalType.PROFILE_CLICK),
    "report": int(SignalType.TWEET_REPORT),
}
# rsx.SIGNAL_TYPES index per action (engagement-history kinds:
# fav, retweet, reply, share, original_tweet, video_playback)
ENG_OF_ACTION = {"fav": 0, "retweet": 1, "reply": 2, "share": 3, "video_view": 5}


class UpdateBatch(NamedTuple):
    """One event micro-batch (stream order). -1 in an index column = skip
    that store for the event."""

    user_ids: np.ndarray  # [E] int64 raw viewer ids
    tweet_ids: np.ndarray  # [E] int64 raw tweet ids
    author_ids: np.ndarray  # [E] int64 raw author ids
    label_idx: np.ndarray  # [E] int32 → fs.ENGAGEMENT_LABELS
    signal_idx: np.ndarray  # [E] int32 → SignalType (-1 = none)
    eng_idx: np.ndarray  # [E] int32 → rsx.SIGNAL_TYPES (-1 = none)
    timestamps: np.ndarray  # [E] int32, non-decreasing


def batch_from_actions(events: Sequence[Tuple[int, int, int, str, int]]) -> UpdateBatch:
    """[(user, tweet, author, action, ts), ...] → UpdateBatch."""
    E = len(events)
    out = UpdateBatch(
        np.empty(E, np.int64), np.empty(E, np.int64), np.empty(E, np.int64),
        np.empty(E, np.int32), np.empty(E, np.int32), np.empty(E, np.int32),
        np.empty(E, np.int32),
    )
    for i, (u, t, a, action, ts) in enumerate(events):
        out.user_ids[i] = u
        out.tweet_ids[i] = t
        out.author_ids[i] = a
        out.label_idx[i] = LABEL_OF_ACTION.get(action, 0)
        out.signal_idx[i] = SIGNAL_OF_ACTION.get(action, -1)
        out.eng_idx[i] = ENG_OF_ACTION.get(action, -1)
        out.timestamps[i] = ts
    return out


# the serve stores an engagement event touches (key builders get the batch)
_STORE_KEYS = {
    "tweet_agg": lambda b: (b.tweet_ids, None),
    "author_agg": lambda b: (b.author_ids, None),
    "user_author_agg": lambda b: (b.user_ids, b.author_ids),
    "user_agg": lambda b: (b.user_ids, None),
}


def _tweet_key(tweet_ids: np.ndarray) -> np.ndarray:
    """Tweet ids as the rings store them: mod 2³¹, as the JAX package takes them."""
    return (tweet_ids.astype(np.int64) % (1 << 31)).astype(np.int32)


class LiveUpdater:
    """Single-writer streaming updater over a serve engine's device tables.

    ``scorer``: a :class:`~the_algorithm_tpu_torch.mixers.device_hydration.DeviceHydrationScorer`
    (or anything exposing a ``tables`` DeviceWideTables attribute and a
    ``builder`` with the aggregate-store resolvers). ``group`` must match the
    stores' stored layout (defaults to the serve schema's rollup spec).

    Optionally owns the realtime tweet-embedding state feeding the SANN
    serving index (``emb_state`` + ``user_interests``); :meth:`refresh_index`
    rebuilds the cluster→tweet index from it (the ClusterTopKTweetsNode
    rebuild), to be swapped into the retrieval source.
    """

    def __init__(
        self,
        scorer,
        *,
        group: Optional[aggregation.AggregateGroup] = None,
        emb_state: Optional[te.TweetEmbeddingState] = None,
        user_interests: Optional[SparseEmbedding] = None,
        emb_config: Optional[te.TweetEmbeddingConfig] = None,
        num_clusters: Optional[int] = None,
        stats=None,
    ):
        self.scorer = scorer
        self.group = group or wh.make_aggregate_group("live")
        self.stats = stats
        self.events_applied = 0
        # store slot index within DeviceWideTables.agg_values
        order = (*dh.CAND_KEYED_AGG, *dh.VIEWER_KEYED_AGG)
        self._slot = {n: order.index(n) for n in _STORE_KEYS}
        self.emb_state = emb_state
        self.emb_config = emb_config or te.TweetEmbeddingConfig()
        self.num_clusters = num_clusters
        self._user_interests = user_interests

    # -- one micro-batch -----------------------------------------------------

    def apply(self, batch: UpdateBatch) -> Dict[str, int]:
        """Fold one event micro-batch into new tables and swap them in.

        Returns per-subsystem applied-event counts.
        """
        tables = self.scorer.tables  # the snapshot this batch folds into
        resolvers = self.scorer.builder.resolvers
        dev = tables.uss_ids.device
        E = len(batch.user_ids)
        ts_dev = torch.from_numpy(np.asarray(batch.timestamps, np.int32)).to(dev)
        onehot = np.zeros((E, len(self.group.labels)), np.float32)
        onehot[np.arange(E), np.clip(batch.label_idx, 0, None)] = 1.0

        agg_values, agg_last = list(tables.agg_values), list(tables.agg_last_ts)
        store_rows, store_ok = [], []
        counts = {}
        for name, key_of in _STORE_KEYS.items():
            k0, k1 = key_of(batch)
            keys = list(zip(k0.tolist(), k1.tolist())) if k1 is not None else [(int(k),) for k in k0]
            try:
                rows = resolvers[name].resolve(keys)
            except KeyError:
                # store capacity exhausted: fold only events whose key
                # already owns a row (the reference's realtime stores shed
                # the same way under key-space pressure)
                rows = resolvers[name].lookup(keys)
            ok = (rows >= 0) & (rows < agg_values[self._slot[name]].shape[0])
            store_rows.append(np.where(ok, rows, 0).astype(np.int32))
            store_ok.append(ok)
            counts[name] = int(ok.sum())
        # masked events fold a zero label vector into row 0 (no change to its
        # values but the decay), and row 0's last_ts still advances, as in the
        # JAX package
        rows_dev = torch.from_numpy(np.stack(store_rows)).to(dev)
        onehot_dev = torch.from_numpy(np.stack(store_ok)[:, :, None] * onehot[None]).to(dev)
        ones = torch.ones((E, 1), dtype=torch.float32, device=dev)
        for i, name in enumerate(_STORE_KEYS):
            si = self._slot[name]
            new = aggregation.update(self.group, aggregation.AggregateStore(agg_values[si], agg_last[si]),
                                     rows_dev[i], ones, onehot_dev[i], ts_dev)
            agg_values[si], agg_last[si] = new

        # USS rings + RSX engagement history (viewer-keyed, modulo rows)
        tweets = _tweet_key(batch.tweet_ids)
        uss_ids, uss_ts = _ring_push(tables.uss_ids, tables.uss_ts, batch.user_ids % tables.uss_ids.shape[0],
                                     batch.signal_idx, tweets, batch.timestamps)
        eng_ids, eng_type, eng_ts, eng_valid = _eng_push(
            tables.eng_ids, tables.eng_type, tables.eng_ts, tables.eng_valid,
            batch.user_ids % tables.eng_ids.shape[0], batch.eng_idx, tweets, batch.timestamps)

        # realtime tweet embeddings (feeds the SANN index refresh); the JAX
        # package folds every event of the batch, whatever its action
        if self.emb_state is not None and self._user_interests is not None:
            T = self.emb_state.cluster_ids.shape[0]
            U_i = self._user_interests.ids.shape[0]
            self.emb_state = te.apply_fav_events(self.emb_state, self._user_interests, batch.user_ids % U_i,
                                                 batch.tweet_ids % T, batch.timestamps, self.emb_config)

        new = tables._replace(agg_values=tuple(agg_values), agg_last_ts=tuple(agg_last), uss_ids=uss_ids,
                              uss_ts=uss_ts, eng_ids=eng_ids, eng_type=eng_type, eng_ts=eng_ts, eng_valid=eng_valid)
        if tables.agg_packed is not None:  # a new pack, the stores views into it
            new = dh.pack_agg_stores(new)
        self.scorer.tables = new  # the swap: in-flight serves keep their snapshot
        self.events_applied += E
        if self.stats is not None:
            self.stats.counter("live_update_events", E)
        counts["events"] = E
        return counts

    def refresh_index(self, now: int):
        """Rebuild the cluster→tweet serving index from the live embedding
        state (≡ the ClusterTopKTweetsNode refresh). Caller swaps the
        result into its retrieval source."""
        if self.emb_state is None:
            raise RuntimeError("LiveUpdater built without emb_state")
        return te.build_cluster_index(self.emb_state, self.num_clusters, self.emb_config, now)


def _push_rows(tables: Sequence[torch.Tensor], keys: np.ndarray, values: Sequence[np.ndarray]):
    """Copies of the [N, W] ``tables`` with each event's values pushed onto
    row ``keys[e]``, newest first, in stream order; events with key -1 are
    skipped. Equal to pushing the events one at a time (shift the row right
    by one, write slot 0), for repeated keys and for more than W events on
    one key."""
    W = tables[0].shape[1]
    dev = tables[0].device
    ev = np.nonzero(keys >= 0)[0]
    if len(ev) == 0:
        return tuple(t.clone() for t in tables)
    ev = ev[np.argsort(keys[ev], kind="stable")]  # 1. by key, stream order within a key
    k = keys[ev]
    first = np.nonzero(np.r_[True, k[1:] != k[:-1]])[0]
    length = np.diff(np.r_[first, len(k)])  # 2. each run's length
    col = np.arange(W)
    # 3-4. slot c < length holds the run's event at position length-1-c (the
    # newest in slot 0); positions that would land at c >= W are dropped
    newest = first[:, None] + length[:, None] - 1 - col[None, :]
    event = ev[np.clip(newest, first[:, None], None)]
    src = col[None, :] - length[:, None]  # 5. slot c >= length holds old slot c - length
    plan = torch.from_numpy(np.stack([np.broadcast_to(k[first, None], src.shape), src, event]).astype(np.int64))
    rows, src, event = plan.to(dev)
    vals = torch.from_numpy(np.stack([np.asarray(v, np.int32) for v in values])).to(dev)
    rows = rows[:, 0]
    out = []
    for t, v in zip(tables, vals):
        shifted = torch.gather(t[rows], 1, torch.clamp(src, min=0))
        new = t.clone()
        new[rows] = torch.where(src >= 0, shifted, v[event])  # 6. each touched row once
        out.append(new)
    return tuple(out)


def _ring_push(ids, tss, u, s, t, ts):
    """[U, S, W] newest-first USS ring push for host event columns: user
    ``u`` (in range), signal ``s`` (-1 = skip), target ``t``, time ``ts``."""
    U, S, W = ids.shape
    s = np.asarray(s, np.int64)
    keys = np.where(s >= 0, np.asarray(u, np.int64) * S + s, -1)
    new_ids, new_ts = _push_rows((ids.reshape(U * S, W), tss.reshape(U * S, W)), keys, (t, ts))
    return new_ids.reshape(U, S, W), new_ts.reshape(U, S, W)


def _eng_push(eids, etype, ets, evalid, u, kind, t, ts):
    """[U, E] engagement-history push (id, type, ts, valid) newest-first;
    ``kind`` -1 skips the event."""
    kind = np.asarray(kind, np.int64)
    keys = np.where(kind >= 0, np.asarray(u, np.int64), -1)
    return _push_rows((eids, etype, ets, evalid), keys, (t, kind, ts, np.ones_like(kind)))
