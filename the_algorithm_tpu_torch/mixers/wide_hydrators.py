"""Wide columnar home-mixer hydrators — the full-width hydration catalog.

Counterpart of ``the_algorithm_tpu/mixers/wide_hydrators.py``: one class
per reference hydrator *family* (``home-mixer/server/.../
functional_component/feature_hydrator/``), each emitting a columnar block
into the request's
:class:`~the_algorithm_tpu_torch.mixers.feature_schema.ColumnarFeatureStore`.
Together the hydrators of :func:`build_wide_hydrators` fill all 5,831 specs
(6,823 columns) of :data:`feature_schema.WIDE_SCHEMA`; the scorer assembles
the [B, F] model matrix by column stacking.

Where a family reads a device table, it reads it on the device and copies
the block to the host once:

- the TwHIN and embedding-table families share one
  :class:`KeyedTableReader`, which reads each key's tables (viewer, author,
  tweet; same row count) in one :func:`~the_algorithm_tpu_torch.ops.gather.
  multiget` a request: one ``row_gather`` launch per key group on the card;
- GFS runs :func:`graph_features.feature_block`, RSX
  :func:`representation_scorer.engagement_similarity_features` (the
  candidate axis padded to 512 with ids of -1, as in JAX), RealGraph's edge
  model :func:`realgraph.predict_edge_scores`.

Where the JAX package computes on the host in numpy, so does the port: the
sparse projection's ``np.add.at`` (a CUDA ``index_put_(accumulate=True)``
would sum with atomics, in no fixed order), the decayed-aggregate and USS
host mirrors of their stores, and RealGraph's match product over a host
mirror of its table (static while serving). Keys are taken as the JAX
package takes them, numpy's floor-mod included (an id of -1 reads the last
row).

:func:`make_aggregate_group` is the wide-schema rollup spec.
:func:`synthetic_world` draws from one numpy generator in exactly the JAX
package's order, so the same seed gives the same numbers; the folds it runs
on them (aggregate stores, RealGraph, USS) are the port's own. Its host
closures (``doc_fn``, ``tweet_embedding_fn``, ``engagement_fn``,
``interested_in_fn``, ``followers_of_viewer_fn``) are the JAX world's.
"""

from __future__ import annotations

import threading
import weakref
import zlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array, resolve
from the_algorithm_tpu_torch.features import aggregation, graph_features, user_signals
from the_algorithm_tpu_torch.features import representation_scorer as rsx
from the_algorithm_tpu_torch.graph import realgraph
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.ops import gather, sparse
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


def make_aggregate_group(name: str) -> aggregation.AggregateGroup:
    """The wide-schema rollup spec: engagement value × 15 labels ×
    (count, sum, sumsq, max) × 4 half-lives (mean is derived at hydration)."""
    return aggregation.AggregateGroup(
        name=name,
        features=("engagement",),
        labels=fs.ENGAGEMENT_LABELS,
        metrics=("count", "sum", "sumsq", "max"),
        half_lives_s=fs.AGG_HALFLIVES_S,
    )


def _author_ids(candidates) -> np.ndarray:
    return np.asarray(
        [int(c.features.get("author_id", -1)) for c in candidates], np.int64
    )


class EarlybirdDocColumnarHydrator(fs.ColumnarFeatureHydrator):
    """In-index Earlybird doc features, 30 columns per candidate.

    ``doc_fn(ids [B]) -> {name: [B]}`` over :data:`fs.EB_DOC_FEATURES`
    (the earlybird index's per-doc feature read, ``search/earlybird.py``).
    """

    def __init__(self, doc_fn: Callable[[np.ndarray], Mapping[str, np.ndarray]]):
        self._doc_fn = doc_fn

    def hydrate_columns(self, query, ids, candidates, params):
        block = self._doc_fn(ids)
        return {f"eb_{n}": np.asarray(block[n]) for n in fs.EB_DOC_FEATURES}


class RealGraphColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Viewer→author RealGraph edge features.

    Matches each candidate author against the viewer's neighbor row with a
    [B, D] equality mask product over a host mirror of the table, yielding
    per-edge-type decayed counts, days-since-interaction, and the
    p(interaction) model score (``graph/realgraph.py``), which runs where the
    model's params live.
    """

    def __init__(self, table: realgraph.EdgeTable, model_params):
        self._nbrs = host_array(table.neighbor_ids)
        self._counts = host_array(table.counts)
        self._last_ts = host_array(table.last_ts)
        self._params = model_params

    def hydrate_columns(self, query, ids, candidates, params):
        uid = int(query.user_id) % int(self._nbrs.shape[0])
        now = int(getattr(query, "now", 0))
        nbrs = self._nbrs[uid]  # [D]
        # per-user decay only — the whole-table edge_features(table, now)
        # would multiply [U, D, F] per request just to slice one row
        dt = max(now - int(self._last_ts[uid]), 0)
        decay = float(np.exp2(-dt / realgraph.DEFAULT_HALF_LIFE_S))
        decayed = self._counts[uid] * decay  # [D, F]
        authors = _author_ids(candidates)
        match = (authors[:, None] == nbrs[None, :]).astype(np.float32)  # [B, D]
        feats = match @ decayed  # [B, F]
        w = self._params["w"]
        p = host_array(realgraph.predict_edge_scores(
            self._params, torch.from_numpy(feats).to(w.device)))
        days = float(
            max(int(getattr(query, "now", 0)) - int(self._last_ts[uid]), 0)
        ) / 86400.0
        cols: Dict[str, np.ndarray] = {
            f"realgraph_{t}_decayed": feats[:, i]
            for i, t in enumerate(realgraph.INTERACTION_TYPES)
        }
        has_edge = match.sum(axis=1) > 0
        cols["realgraph_days_since"] = np.where(has_edge, days, 0.0).astype(
            np.float32
        )
        cols["realgraph_score"] = feats.sum(axis=1)
        cols["realgraph_p_interaction"] = np.where(has_edge, p, 0.0).astype(
            np.float32
        )
        return cols


KEYS = ("viewer", "author", "tweet")


class KeyedTableReader:
    """The catalog's device tables grouped by key (viewer, author, tweet)
    and row count: each group is read in one
    :func:`~the_algorithm_tpu_torch.ops.gather.multiget` per request (one
    ``row_gather`` launch for up to three tables with 16-byte rows) and its
    block copied to the host once, whichever hydrator asks first; the others
    of the request take it from the request's memo.

    Keys are host numpy rows (the JAX package's floor-mod of each id by the
    group's row count); the memo is keyed on the request's
    :class:`~the_algorithm_tpu_torch.mixers.feature_schema.
    ColumnarFeatureStore` and holds the rows it read, so a request whose
    candidates changed between two hydrators reads again.
    """

    def __init__(self):
        self._groups: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def add(self, key: str, name: str, table) -> Tuple[str, int]:
        """Register ``table`` [N, W] (a tensor on its device; an array goes
        to the CPU) under ``key``; returns its group."""
        assert key in KEYS
        if not isinstance(table, torch.Tensor):
            table = torch.from_numpy(np.ascontiguousarray(table, np.float32))
        group = (key, int(table.shape[0]))
        self._groups.setdefault(group, {})[name] = table.contiguous()
        return group

    def read(self, query, group: Tuple[str, int], rows: np.ndarray) -> Dict[str, np.ndarray]:
        """{name: [len(rows), W]} host rows of every table of ``group``."""
        if isinstance(getattr(query, "features", None), Mapping):
            with self._lock:
                memo = self._memo.setdefault(fs.store_of(query), {})
        else:  # a query without features has no store: nothing to share
            memo = {}
        hit = memo.get(group)
        if hit is not None and np.array_equal(hit[0], rows):
            return hit[1]
        tables = self._groups[group]
        dev = next(iter(tables.values())).device
        got = gather.multiget(tables, torch.from_numpy(rows.astype(np.int32)).to(dev))
        names = list(got)
        block = torch.cat([got[n] for n in names], dim=1).cpu().numpy()  # one copy to the host
        out, col = {}, 0
        for n in names:
            w = got[n].shape[1]
            out[n] = block[:, col:col + w]
            col += w
        memo[group] = (rows.copy(), out)
        return out


def _keyed_rows(key: str, n: int, query, ids, candidates) -> np.ndarray:
    """The rows a ``key``-keyed table of ``n`` rows reads, as JAX takes them."""
    if key == "tweet":
        return ids % n
    if key == "author":
        return _author_ids(candidates) % n
    return np.asarray([int(query.user_id) % n], np.int64)


def _broadcast(key: str, rows: np.ndarray, B: int) -> np.ndarray:
    return np.broadcast_to(rows[0], (B, rows.shape[1])) if key == "viewer" else rows


class TwhinColumnarHydrator(fs.ColumnarFeatureHydrator):
    """TwHIN dense embeddings: viewer (broadcast), author, tweet, plus the
    negative-interaction viewer embedding and the follow-graph author
    embedding (≡ TwhinUser{Engagement,Negative}/TwhinAuthorFollow
    hydrators) — 5×64, read through ``reader`` (its own unless shared)."""

    def __init__(
        self,
        user_table,  # [U, 64]
        author_table,  # [A, 64]
        tweet_table,  # [T, 64]
        user_negative_table=None,  # [U, 64]
        author_follow_table=None,  # [A, 64]
        reader: Optional[KeyedTableReader] = None,
    ):
        self._reader = reader if reader is not None else KeyedTableReader()
        self._cols = [(n, k, self._reader.add(k, n, t)) for n, k, t in (
            ("twhin_user", "viewer", user_table),
            ("twhin_author", "author", author_table),
            ("twhin_tweet", "tweet", tweet_table),
            ("twhin_user_negative", "viewer", user_negative_table),
            ("twhin_author_follow", "author", author_follow_table),
        ) if t is not None]
        self._authors = int(author_table.shape[0])

    def hydrate_columns(self, query, ids, candidates, params):
        B = ids.shape[0]
        cols = {}
        for name, key, group in self._cols:
            if name == "twhin_author_follow":  # JAX keys it by the author row, mod its own rows
                rows = _author_ids(candidates) % self._authors % group[1]
            else:
                rows = _keyed_rows(key, group[1], query, ids, candidates)
            cols[name] = _broadcast(key, self._reader.read(query, group, rows)[name], B)
        return cols


class SparseProjectionColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Sparse SimClusters embedding → fixed-width dense bucket projection:
    ``proj[b] = Σ score over clusters with cluster_id % buckets == b`` — a
    hash-bucketed densification of the (id, score) pairs, viewer- or
    tweet-keyed (the UserSimClusters/TweetSimClusters hydrator families).
    The sum runs on the host with ``np.add.at``, in the JAX package's order."""

    def __init__(self, name: str, emb_fn, key: str = "tweet",
                 buckets: int = 64):
        assert key in ("tweet", "viewer")
        self._name_ = name
        self._emb_fn = emb_fn  # ids [B] -> SparseEmbedding | query -> SparseEmbedding
        self._key = key
        self._buckets = buckets

    @property
    def name(self) -> str:
        return f"SparseProjectionColumnarHydrator[{self._name_}]"

    def hydrate_columns(self, query, ids, candidates, params):
        B = ids.shape[0]
        if self._key == "tweet":
            emb = self._emb_fn(ids)  # [B, K]
            cl = host_array(emb.ids)
            sc = host_array(emb.scores)
        else:
            emb = self._emb_fn(query)  # [K]
            cl = host_array(emb.ids)[None, :]
            sc = host_array(emb.scores)[None, :]
        valid = cl != int(PAD_ID)
        bucket = np.where(valid, cl % self._buckets, 0)
        proj = np.zeros((cl.shape[0], self._buckets), np.float32)
        np.add.at(proj, (np.arange(cl.shape[0])[:, None], bucket),
                  np.where(valid, sc, 0.0))
        if self._key == "viewer":
            proj = np.broadcast_to(proj[0], (B, self._buckets))
        return {self._name_: proj}


class RsxColumnarHydrator(fs.ColumnarFeatureHydrator):
    """RSX block: similarity(candidate, viewer's recent engagements) per
    similarity kind × signal × window × {min,avg,max}, computed where the
    embeddings live and copied to the host as ONE stacked [n_cols, B] block.

    ``tweet_embedding_fn``: ids [B] → SparseEmbedding [B, K];
    ``engagement_fn``: user_id → :class:`rsx.EngagementSet`."""

    _PAD_B = 512  # the JAX package's fixed candidate axis (pad ids -1)

    def __init__(self, tweet_embedding_fn, engagement_fn):
        self._emb = tweet_embedding_fn
        self._eng = engagement_fn
        self._names = rsx.feature_names(kinds=rsx.SIMILARITY_KINDS)

    def hydrate_columns(self, query, ids, candidates, params):
        B = ids.shape[0]
        PB = self._PAD_B
        if B <= PB:
            padded = np.full(PB, -1, np.int64)
            padded[:B] = ids
            cand_emb = self._emb(padded)
        else:
            cand_emb = self._emb(ids)
        engagements = self._eng(query.user_id)
        block = rsx.engagement_similarity_features(
            cand_emb, engagements, int(getattr(query, "now", 0)),
            kinds=rsx.SIMILARITY_KINDS)
        mat = torch.stack([block[n] for n in self._names]).cpu().numpy()
        return {f"rsx_{n}": mat[i, :B]
                for i, n in enumerate(self._names)}


class EmbeddingTableColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Generic [N, K] embedding-table gather, keyed by tweet id, author id,
    or the viewer (broadcast) — covers the large-embedding hydrator family;
    read through ``reader`` (its own unless shared)."""

    def __init__(self, name: str, table, key: str = "tweet",
                 reader: Optional[KeyedTableReader] = None):
        assert key in KEYS
        self._name = name
        self._key = key
        self._reader = reader if reader is not None else KeyedTableReader()
        self._group = self._reader.add(key, name, table)

    @property
    def name(self) -> str:
        return f"EmbeddingTableColumnarHydrator[{self._name}]"

    def hydrate_columns(self, query, ids, candidates, params):
        rows = _keyed_rows(self._key, self._group[1], query, ids, candidates)
        got = self._reader.read(query, self._group, rows)[self._name]
        return {self._name: _broadcast(self._key, got, ids.shape[0])}


_AGG_LABEL_NAMES = fs.ENGAGEMENT_LABELS
_AGG_HL = fs.AGG_HALFLIVES_S
_AGG_HL_NAMES = fs.AGG_HALFLIFE_NAMES



class DecayedAggregatesColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Decayed aggregate rollups read from the aggregation framework.

    ``key`` selects the entity: per-tweet, per-author, per-viewer
    (broadcast), a pair/keyed cross — "viewer_author",
    "viewer_original_author", "viewer_engager", "viewer_mention",
    "viewer_topic"/"viewer_language"/"viewer_media"/"viewer_conversation"
    (candidate-feature second key), "viewer_source" (retrieval-source
    second key), "viewer_list" (query key), "viewer_dow"/"viewer_hour"
    (request-time key), "author_topic" (author × candidate topic), or
    "topic" (global per-topic rollup) — matching the
    TimelinesAggregationConfigDetails keyed groups (+ realtime v2
    variants). Column order inside the store row follows
    :func:`aggregation._layout` for ``features=('engagement',)``:
    ``col = (label*M + metric)*H + hl``.

    Every group exposes the full metric catalog: stored count/sum/sumsq/max
    plus derived mean, per label × half-life.
    """

    _PAIR_FEATURE_KEYS = {
        "viewer_author": "author_id",
        "viewer_original_author": "original_author_id",
        "viewer_engager": "engager_id",
        "viewer_mention": "mentioned_user_id",
        "viewer_topic": "topic_id",
        "viewer_language": "language_id",
        "viewer_media": "media_type",
        "viewer_conversation": "conversation_id",
    }

    def __init__(
        self,
        group: aggregation.AggregateGroup,
        store: aggregation.AggregateStore,
        resolver: aggregation.KeyResolver,
        key: str,
        prefix: str,  # "tweet_agg" | "author_agg" | "user_agg" | pair prefix
    ):
        assert key in ("tweet", "author", "viewer", "viewer_list",
                       "viewer_dow", "viewer_hour", "viewer_source",
                       "author_topic", "topic",
                       *self._PAIR_FEATURE_KEYS)
        self._group = group
        self._store = store
        self._resolver = resolver
        self._key = key
        self._prefix = prefix
        # serving-path read cache: the store is static between trainer
        # refreshes, so the decayed read runs in host numpy (one fetch per
        # store swap, zero per-request device dispatches)
        self._np_values: Optional[np.ndarray] = None
        self._np_last_ts: Optional[np.ndarray] = None
        F, L = len(group.features), len(group.labels)
        self._hl_cols = np.asarray(
            [group.half_lives_s[h]
             for _ in range(F * L * len(group.metrics))
             for h in range(len(group.half_lives_s))], np.float32)

    def refresh_store(self, store: aggregation.AggregateStore) -> None:
        """Swap in an updated store (invalidates the host read cache)."""
        self._store = store
        self._np_values = None
        self._np_last_ts = None

    def _read(self, rows: np.ndarray, now: int) -> np.ndarray:
        """Host-numpy mirror of :func:`aggregation.read` (decay-to-now)."""
        if self._np_values is None:
            self._np_values = host_array(self._store.values)
            self._np_last_ts = host_array(self._store.last_ts)
        dt = (now - self._np_last_ts[rows]).astype(np.float32)
        decay = np.exp2(-dt[:, None] / self._hl_cols[None, :])
        return self._np_values[rows] * decay

    @property
    def name(self) -> str:
        return f"DecayedAggregatesColumnarHydrator[{self._prefix}]"

    @staticmethod
    def source_hash(source) -> int:
        """Stable small id for a retrieval-source name (the second key of
        the user×source cross)."""
        return zlib.crc32(str(source or "").encode()) % 1024

    def _cand_feature(self, candidates, feat, default_feat=None):
        out = []
        for c in candidates:
            v = c.features.get(feat)
            if v is None and default_feat is not None:
                v = c.features.get(default_feat)
            out.append(int(v) if v is not None else -1)
        return out

    def hydrate_columns(self, query, ids, candidates, params):
        """Base-class dict contract: {name: [B] column}. The serve path
        uses :meth:`hydrate` → :meth:`_hydrate_matrix` → ``add_block``
        instead (one matrix, no per-column dict)."""
        matrix = self._hydrate_matrix(query, ids, candidates, params)
        return {n: matrix[:, i] for i, n in enumerate(self.output_names)}

    def _hydrate_matrix(self, query, ids, candidates, params):
        uid = int(getattr(query, "user_id", 0))
        now = int(getattr(query, "now", 0))
        if self._key == "tweet":
            keys = [(int(i),) for i in ids]
        elif self._key == "author":
            keys = [(int(a),) for a in _author_ids(candidates)]
        elif self._key == "viewer":
            keys = [(uid,)]
        elif self._key == "viewer_list":
            keys = [(uid, int(getattr(query, "list_id", -1) or -1))]
        elif self._key == "viewer_dow":
            keys = [(uid, (now // 86400) % 7)]
        elif self._key == "viewer_hour":
            keys = [(uid, (now // 3600) % 24)]
        elif self._key == "viewer_source":
            keys = [(uid, self.source_hash(c.source)) for c in candidates]
        elif self._key == "author_topic":
            topics = self._cand_feature(candidates, "topic_id")
            keys = [(int(a), t) for a, t in
                    zip(_author_ids(candidates), topics)]
        elif self._key == "topic":
            keys = [(t,) for t in self._cand_feature(candidates, "topic_id")]
        else:  # pair keyed on a per-candidate feature
            feat = self._PAIR_FEATURE_KEYS[self._key]
            default = ("author_id" if self._key == "viewer_original_author"
                       else None)
            keys = [(uid, v)
                    for v in self._cand_feature(candidates, feat, default)]
        # read path: never allocate — unknown keys read as zero rows
        rows = self._resolver.lookup(keys)
        known = rows >= 0
        block = self._read(
            np.where(known, rows, 0), int(getattr(query, "now", 0))
        )  # [len(keys), L*M*H]
        block = np.where(known[:, None], block, 0.0)
        if len(keys) == 1 and ids.shape[0] != 1:  # query-keyed → broadcast
            block = np.broadcast_to(block[0], (ids.shape[0], block.shape[1]))
        return self._expose(block)

    def _expose(self, block: np.ndarray) -> np.ndarray:
        """[B, L·M·H] stored block → [B, L·H·5] exposed matrix in
        (label, half-life, count/sum/mean/sumsq/max) order — one vectorized
        reshuffle instead of ~300 per-column slices."""
        B = block.shape[0]
        L, H = len(_AGG_LABEL_NAMES), len(_AGG_HL)
        M = len(self._group.metrics)  # stored (count, sum, sumsq, max)
        cube = block.reshape(B, L, M, H).transpose(0, 1, 3, 2)  # [B,L,H,M]
        count = cube[..., 0]
        ssum = cube[..., 1]
        out = np.empty((B, L, H, 5), np.float32)
        out[..., 0] = count
        out[..., 1] = ssum
        out[..., 2] = ssum / np.maximum(count, 1.0)
        out[..., 3] = cube[..., 2]
        out[..., 4] = cube[..., 3]
        return out.reshape(B, L * H * 5)

    @property
    def output_names(self) -> List[str]:
        if not hasattr(self, "_out_names"):
            self._out_names = [
                f"{self._prefix}_{label}_{metric}_{hl}"
                for label in _AGG_LABEL_NAMES
                for hl in _AGG_HL_NAMES
                for metric in fs.AGG_METRICS
            ]
        return self._out_names

    def hydrate(self, query, candidates, params) -> None:
        """Block-registration fast path (bypasses the per-column dict)."""
        if not candidates:
            return
        ids = np.asarray([c.id for c in candidates], np.int64)
        matrix = self._hydrate_matrix(query, ids, candidates, params)
        fs.store_of(query).add_block(ids, self.output_names, matrix)


class UssSignalCountColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Viewer signal counts per SignalType × window (broadcast) — the USS
    count features over 90d/30d/7d lookbacks (17 × 3 columns)."""

    WINDOWS = {"90d": 90 * 86400, "30d": 30 * 86400, "7d": 7 * 86400}

    def __init__(self, store: user_signals.SignalStore):
        self.refresh_store(store)

    def refresh_store(self, store: user_signals.SignalStore) -> None:
        """Swap in an updated store (re-mirrors the host read cache) —
        mirrors :meth:`DecayedAggregatesColumnarHydrator.refresh_store`."""
        self._store = store
        # serving-path host mirror (see DecayedAggregates read cache)
        self._np_ids = host_array(store.target_ids)
        self._np_ts = host_array(store.timestamps)

    def hydrate_columns(self, query, ids, candidates, params):
        B = ids.shape[0]
        now = int(getattr(query, "now", 0))
        uid = int(query.user_id) % int(self._np_ids.shape[0])
        # one reduction for ALL signal types × windows in host numpy
        # (per-type fetch loops would pay serial round-trips per request)
        t_ids = self._np_ids[uid]  # [S, W]
        t_ts = self._np_ts[uid]
        cutoffs = np.asarray(
            [now - w for w in self.WINDOWS.values()], np.int64)  # [3]
        counts = np.sum(
            (t_ids != int(PAD_ID))[None, :, :]
            & (t_ts[None, :, :] >= cutoffs[:, None, None]),
            axis=-1,
        )  # [3, S]
        cols = {}
        for wi, w_name in enumerate(self.WINDOWS):
            for st in user_signals.SignalType:
                cols[f"uss_{st.name.lower()}_count_{w_name}"] = np.full(
                    B, float(counts[wi, int(st)]), np.float32)
        return cols


class GfsColumnarHydrator(fs.ColumnarFeatureHydrator):
    """GFS two-hop intersections (canonical pairs + normalized) — 8 cols,
    computed where the tables live and fetched as ONE stacked array (single
    device→host copy)."""

    def __init__(self, tables: graph_features.GraphTables):
        self._tables = tables
        self._names = [n for p in graph_features.FEATURE_PAIRS
                       for n in (p, p + "_normalized")]

    _PAD_B = 512  # the JAX package's fixed candidate axis (pad authors 0)

    def hydrate_columns(self, query, ids, candidates, params):
        authors = _author_ids(candidates).clip(min=0) % self._tables.num_users
        B = authors.shape[0]
        if B <= self._PAD_B:
            padded = np.zeros(self._PAD_B, np.int64)
            padded[:B] = authors
            authors = padded
        block = graph_features.feature_block(
            self._tables,
            int(query.user_id) % self._tables.num_users,
            torch.from_numpy(authors.astype(np.int32)).to(self._tables.neighbors.device),
        )
        mat = torch.stack([block[n] for n in self._names]).cpu().numpy()
        return {n: mat[i, :B] for i, n in enumerate(self._names)}


class AuthorMetaColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Author reputation + account meta + viewer↔author follow relation.

    ``meta`` is a [U, 4] table in :data:`fs.AUTHOR_META_FEATURES` order;
    follow relations come from the query's followed set and an optional
    reverse-follow set.
    """

    def __init__(
        self,
        tweepcred,  # [U]
        meta,  # [U, 4]
        followers_of_viewer_fn: Optional[Callable[[int], frozenset]] = None,
    ):
        self._rep = host_array(tweepcred).astype(np.float32)
        self._meta = host_array(meta).astype(np.float32)
        self._followers_fn = followers_of_viewer_fn

    def hydrate_columns(self, query, ids, candidates, params):
        authors = _author_ids(candidates)
        safe = authors.clip(min=0) % self._rep.shape[0]
        ok = authors >= 0
        cols: Dict[str, np.ndarray] = {
            "tweepcred": np.where(ok, self._rep[safe], 0.0).astype(np.float32)
        }
        meta_rows = self._meta[safe % self._meta.shape[0]]
        for j, n in enumerate(fs.AUTHOR_META_FEATURES):
            cols[n] = np.where(ok, meta_rows[:, j], 0.0).astype(np.float32)
        followed = np.asarray(
            sorted(int(a) for a in getattr(query, "followed_authors", ())),
            np.int64,
        )
        cols["viewer_follows_author"] = np.isin(authors, followed).astype(
            np.float32
        )
        if self._followers_fn is not None:
            back = np.asarray(
                sorted(self._followers_fn(int(query.user_id))), np.int64
            )
            cols["author_follows_viewer"] = np.isin(authors, back).astype(
                np.float32
            )
        else:
            cols["author_follows_viewer"] = np.zeros(len(authors), np.float32)
        return cols


class CandidateLiftColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Bridge: lift retrieval-time scalars already on the candidate object
    model (source scores, social proof, context) into columns. One list
    comprehension per *name* (~6), not per candidate-feature pair."""

    def __init__(self, names: Sequence[str] = fs.CONTEXT_FEATURES):
        self._names = tuple(names)

    def hydrate_columns(self, query, ids, candidates, params):
        cols = {}
        for n in self._names:
            cols[n] = np.asarray(
                [float(c.features.get(n) or 0.0) for c in candidates],
                np.float32,
            )
        return cols


class ServingContextColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Request serving context: time-of-day / day-of-week / client one-hots
    plus page/session scalars (broadcast across candidates) — the
    RequestContext / non-ML serving feature block."""

    def hydrate_columns(self, query, ids, candidates, params):
        B = ids.shape[0]
        now = int(getattr(query, "now", 0))
        hour = np.zeros(24, np.float32)
        hour[(now // 3600) % 24] = 1.0
        dow = np.zeros(7, np.float32)
        dow[(now // 86400) % 7] = 1.0
        client = np.zeros(fs.CONTEXT_CLIENTS, np.float32)
        client[int(getattr(query, "client_id", 0) or 0)
               % fs.CONTEXT_CLIENTS] = 1.0
        served = len(getattr(query, "served_tweet_ids", ()) or ())
        refresh = int(getattr(query, "refresh_count", 0) or 0)
        session_age = float(getattr(query, "session_age_s", 0) or 0) / 60.0
        scalars = {
            "ctx_is_first_page": float(
                getattr(query, "since_id", None) is None
                and getattr(query, "max_id", None) is None and served == 0),
            "ctx_refresh_count_log": float(np.log1p(refresh)),
            "ctx_session_age_minutes_log": float(np.log1p(session_age)),
            "ctx_served_depth": float(served),
        }
        cols = {
            "ctx_hour_of_day": np.broadcast_to(hour, (B, 24)),
            "ctx_day_of_week": np.broadcast_to(dow, (B, 7)),
            "ctx_client": np.broadcast_to(client, (B, fs.CONTEXT_CLIENTS)),
        }
        for n, v in scalars.items():
            cols[n] = np.full(B, v, np.float32)
        return cols


class SourceOneHotColumnarHydrator(fs.ColumnarFeatureHydrator):
    """Candidate retrieval-source one-hot over the catalog's source names —
    the source-attribution block the heavy ranker conditions on."""

    def __init__(self, source_names: Optional[Sequence[str]] = None):
        names = (tuple(source_names) if source_names is not None
                 else tuple(fs.candidate_source_names()))
        self._index = {n: i for i, n in enumerate(names)}
        self._n = len(names)

    def hydrate_columns(self, query, ids, candidates, params):
        out = np.zeros((ids.shape[0], self._n), np.float32)
        for i, c in enumerate(candidates):
            j = self._index.get(str(c.source))
            if j is not None:
                out[i, j] = 1.0
        return {"source_onehot": out}


# -- catalog assembly ----------------------------------------------------------


PAIR_KEY_OF = {
    "user_author_agg": "viewer_author",
    "user_author_oon_agg": "viewer_author",
    "user_engager_agg": "viewer_engager",
    "user_mention_agg": "viewer_mention",
    "user_original_author_agg": "viewer_original_author",
    "user_topic_agg": "viewer_topic",
    "user_list_agg": "viewer_list",
    "user_dow_agg": "viewer_dow",
    "user_hour_agg": "viewer_hour",
    # round-3 keyed crosses
    "author_topic_agg": "author_topic",
    "user_source_agg": "viewer_source",
    "user_language_agg": "viewer_language",
    "user_media_agg": "viewer_media",
    "user_conversation_agg": "viewer_conversation",
    "topic_agg": "topic",
}


def build_wide_hydrators(
    *,
    doc_fn,
    realgraph_table,
    realgraph_params,
    twhin_user,
    twhin_author,
    twhin_tweet,
    tweet_embedding_fn,
    engagement_fn,
    user_interests_table,
    author_agg_table,
    media_cluster_table,
    text_embedding_table,
    tweet_agg: Tuple[aggregation.AggregateStore, aggregation.KeyResolver],
    author_agg: Tuple[aggregation.AggregateStore, aggregation.KeyResolver],
    user_agg: Tuple[aggregation.AggregateStore, aggregation.KeyResolver],
    signal_store,
    gfs_tables,
    tweepcred,
    author_meta,
    followers_of_viewer_fn=None,
    pair_aggs: Optional[Mapping[str, Tuple]] = None,
    twhin_user_negative=None,
    twhin_author_follow=None,
    interested_in_fn=None,  # query -> SparseEmbedding (viewer InterestedIn)
    source_names: Optional[Sequence[str]] = None,
) -> List[fs.ColumnarFeatureHydrator]:
    """All hydrators needed to populate the full WIDE_SCHEMA.

    ``pair_aggs``: prefix → (store, resolver) for the keyed crosses
    (:data:`feature_schema.PAIR_AGG_PREFIXES` +
    :data:`feature_schema.EXTRA_AGG_PREFIXES` + "user_author_agg").
    The TwHIN and embedding-table hydrators share one
    :class:`KeyedTableReader`: with the world's tables, one ``row_gather``
    launch for each of the viewer, author and tweet groups a request.
    """
    reader = KeyedTableReader()
    pair_hydrators: List[fs.ColumnarFeatureHydrator] = []
    if pair_aggs:
        for prefix, (store, resolver) in pair_aggs.items():
            pair_hydrators.append(DecayedAggregatesColumnarHydrator(
                make_aggregate_group(prefix), store, resolver,
                key=PAIR_KEY_OF[prefix], prefix=prefix,
            ))
    out = pair_hydrators + [
        EarlybirdDocColumnarHydrator(doc_fn),
        RealGraphColumnarHydrator(realgraph_table, realgraph_params),
        TwhinColumnarHydrator(
            twhin_user, twhin_author, twhin_tweet,
            user_negative_table=twhin_user_negative,
            author_follow_table=twhin_author_follow,
            reader=reader,
        ),
        RsxColumnarHydrator(tweet_embedding_fn, engagement_fn),
        SparseProjectionColumnarHydrator(
            "tweet_simclusters_proj", tweet_embedding_fn, key="tweet"
        ),
        EmbeddingTableColumnarHydrator(
            "user_interests_emb", user_interests_table, key="viewer",
            reader=reader,
        ),
        EmbeddingTableColumnarHydrator(
            "author_agg_emb", author_agg_table, key="author", reader=reader,
        ),
        EmbeddingTableColumnarHydrator(
            "media_clip_clusters", media_cluster_table, key="tweet",
            reader=reader,
        ),
        EmbeddingTableColumnarHydrator(
            "text_emb", text_embedding_table, key="tweet", reader=reader,
        ),
        DecayedAggregatesColumnarHydrator(
            make_aggregate_group("tweet_agg"), tweet_agg[0], tweet_agg[1],
            key="tweet", prefix="tweet_agg",
        ),
        DecayedAggregatesColumnarHydrator(
            make_aggregate_group("author_agg"), author_agg[0], author_agg[1],
            key="author", prefix="author_agg",
        ),
        DecayedAggregatesColumnarHydrator(
            make_aggregate_group("user_agg"), user_agg[0], user_agg[1],
            key="viewer", prefix="user_agg",
        ),
        UssSignalCountColumnarHydrator(signal_store),
        GfsColumnarHydrator(gfs_tables),
        AuthorMetaColumnarHydrator(
            tweepcred, author_meta, followers_of_viewer_fn
        ),
        CandidateLiftColumnarHydrator(),
        ServingContextColumnarHydrator(),
        SourceOneHotColumnarHydrator(source_names),
    ]
    if interested_in_fn is not None:
        out.append(SparseProjectionColumnarHydrator(
            "user_simclusters_proj", interested_in_fn, key="viewer"
        ))
    return out


def synthetic_world(
    seed: int = 0,
    *,
    num_users: int = 64,
    num_authors: int = 64,
    num_tweets: int = 1 << 14,
    realgraph_degree: int = 16,
    num_clusters: int = 256,
    clusters_per_tweet: int = 8,
    engagement_width: int = 16,
    gfs_degree: int = 8,
    now: int = 10_000_000,
    device=None,
) -> Dict:
    """The JAX package's ``synthetic_world(..., include_device_spec=True)``:
    every table seeded deterministically, as tensors on ``device`` (default:
    the card), the JAX world's host closures for :func:`build_wide_hydrators`
    (``doc_fn`` and ``followers_of_viewer_fn`` in numpy; the sparse tweet and
    interest embeddings and the engagement sets computed in numpy as there,
    then placed on ``device``), and its ``"device_spec"`` entry (the doc
    table, the engagement history and the torch twins of the host formulas;
    pop it before ``build_wide_hydrators(**world)``).
    """
    dev = resolve(device, "synthetic_world")
    rng = np.random.default_rng(seed)

    def on(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    # earlybird doc features: deterministic, no rng draws
    n_doc = len(fs.EB_DOC_FEATURES)
    doc_table = np.sin(
        0.001 * np.arange(num_tweets, dtype=np.float64)[:, None]
        * np.arange(1, n_doc + 1, dtype=np.float64)[None, :]
    ).astype(np.float32)

    def doc_fn(ids: np.ndarray) -> Dict[str, np.ndarray]:
        ids = np.asarray(ids, np.int64) % num_tweets
        return {n: doc_table[ids, j] for j, n in enumerate(fs.EB_DOC_FEATURES)}

    # realgraph: every user interacts with a few authors
    n_ev = num_users * 4
    src = rng.integers(0, num_users, n_ev).astype(np.int32)
    dst = rng.integers(0, num_authors, n_ev).astype(np.int32)
    itype = rng.integers(0, len(realgraph.INTERACTION_TYPES), n_ev).astype(np.int32)
    ts = np.sort(rng.integers(now - 30 * 86400, now, n_ev)).astype(np.int32)
    rg_table = realgraph.apply_interactions(realgraph.init_table(num_users, realgraph_degree, dev),
                                            src, dst, itype, ts)
    rg_params = {
        "w": on(rng.normal(0, 0.1, len(realgraph.INTERACTION_TYPES)), np.float32),
        "b": torch.zeros((), dtype=torch.float32, device=dev),
    }

    def tweet_embedding_fn(ids: np.ndarray) -> sparse.SparseEmbedding:
        # numpy int64 products and floor-mod, as the JAX world's (an id of -1
        # maps to a valid cluster)
        ids = np.asarray(ids, np.int64)
        K = clusters_per_tweet
        cl = (ids[:, None] * np.arange(1, K + 1)[None, :] * 2654435761) % num_clusters
        sc = 1.0 / (1.0 + np.arange(K))[None, :] * np.ones((ids.shape[0], 1))
        return sparse.make(on(cl, np.int32), on(sc, np.float32), K)

    eng_ids = rng.integers(0, num_tweets, (num_users, engagement_width))
    eng_types = rng.integers(0, len(rsx.SIGNAL_TYPES), (num_users, engagement_width))
    eng_ts = rng.integers(now - 6 * 86400, now, (num_users, engagement_width))

    def engagement_fn(user_id: int) -> rsx.EngagementSet:
        u = int(user_id) % num_users
        return rsx.EngagementSet(
            embeddings=tweet_embedding_fn(eng_ids[u]),
            signal_type=on(eng_types[u], np.int32),
            timestamp=on(eng_ts[u], np.int32),
            valid=torch.ones(engagement_width, dtype=torch.bool, device=dev),
        )

    def table(n, k):
        return on(rng.normal(0, 1, (n, k)), np.float32)

    def agg_fixture(prefix: str, n_keys: int, key_fn=None):
        group = make_aggregate_group(prefix)
        store = aggregation.init_store(group, capacity=n_keys + 8, device=dev)
        resolver = aggregation.KeyResolver(capacity=n_keys + 8)
        B = n_keys * 2
        if key_fn is None:
            keys = [(int(k),) for k in rng.integers(0, n_keys, B)]
        else:
            keys = [key_fn(i) for i in range(B)]
        rows = resolver.resolve(keys)
        fv = rng.random((B, 1)).astype(np.float32)
        lv = (rng.random((B, len(fs.ENGAGEMENT_LABELS))) < 0.3).astype(np.float32)
        ets = np.sort(rng.integers(now - 10 * 86400, now, B)).astype(np.int32)
        store = aggregation.update(group, store, on(rows), on(fv), on(lv), on(ets))
        return store, resolver

    sig_store = user_signals.init_store(num_users, width=8, device=dev)
    n_sig = num_users * 3
    sig_store = user_signals.record(
        sig_store,
        rng.integers(0, num_users, n_sig),
        rng.integers(0, len(user_signals.SignalType), n_sig),
        rng.integers(0, num_tweets, n_sig),
        np.sort(rng.integers(now - 80 * 86400, now, n_sig)),
    )

    E = len(graph_features.EdgeType)
    nbrs = np.full((E, num_users, gfs_degree), PAD_ID, np.int32)
    for e in range(E):
        for u in range(num_users):
            deg = int(rng.integers(1, gfs_degree))
            nbrs[e, u, :deg] = np.sort(rng.choice(num_users, size=deg, replace=False))
    gfs_tables = graph_features.GraphTables(on(nbrs))

    meta = np.stack(
        [
            np.log1p(rng.integers(0, 1_000_000, num_authors)),
            np.log1p(rng.integers(0, 5_000, num_authors)),
            rng.integers(0, 5000, num_authors).astype(np.float32),
            (rng.random(num_authors) < 0.1).astype(np.float32),
        ],
        axis=1,
    ).astype(np.float32)

    # pair/keyed crosses: bounded key pools so fixtures stay small
    def _pair_pool(second_max):
        pool = [(int(rng.integers(0, num_users)), int(rng.integers(0, second_max))) for _ in range(24)]
        return lambda i: pool[i % len(pool)]

    def _single_pool(second_max):
        pool = [(int(rng.integers(0, second_max)),) for _ in range(24)]
        return lambda i: pool[i % len(pool)]

    # the dict literals below draw in the JAX package's order: each entry's
    # key pool, then its fold; then the tables of the world dict in order
    pair_aggs = {
        "user_author_agg": agg_fixture("user_author_agg", 32, _pair_pool(num_authors)),
        "user_author_oon_agg": agg_fixture("user_author_oon_agg", 32, _pair_pool(num_authors)),
        "user_engager_agg": agg_fixture("user_engager_agg", 32, _pair_pool(num_users)),
        "user_mention_agg": agg_fixture("user_mention_agg", 32, _pair_pool(num_users)),
        "user_original_author_agg": agg_fixture("user_original_author_agg", 32, _pair_pool(num_authors)),
        "user_topic_agg": agg_fixture("user_topic_agg", 32, _pair_pool(16)),
        "user_list_agg": agg_fixture("user_list_agg", 32, _pair_pool(4)),
        "user_dow_agg": agg_fixture("user_dow_agg", 32, _pair_pool(7)),
        "user_hour_agg": agg_fixture("user_hour_agg", 32, _pair_pool(24)),
        "author_topic_agg": agg_fixture(
            "author_topic_agg", 32,
            (lambda pool: lambda i: pool[i % len(pool)])([
                (int(rng.integers(0, num_authors)), int(rng.integers(0, 16))) for _ in range(24)])),
        "user_source_agg": agg_fixture("user_source_agg", 32, _pair_pool(1024)),
        "user_language_agg": agg_fixture("user_language_agg", 32, _pair_pool(8)),
        "user_media_agg": agg_fixture("user_media_agg", 32, _pair_pool(4)),
        "user_conversation_agg": agg_fixture("user_conversation_agg", 32, _pair_pool(num_tweets)),
        "topic_agg": agg_fixture("topic_agg", 32, _single_pool(16)),
    }

    def interested_in_fn(query) -> sparse.SparseEmbedding:
        # the viewer's InterestedIn row: the tweet embedding of its user id
        emb = tweet_embedding_fn(np.asarray([int(getattr(query, "user_id", 0)) % num_users]))
        return sparse.SparseEmbedding(emb.ids[0], emb.scores[0])

    K, C = clusters_per_tweet, num_clusters

    def tweet_emb_device(ids: torch.Tensor):
        """The synthetic tweet embedding, (cluster ids, scores) [..., K]: the
        JAX package's ``tweet_emb_device``, products in int32 as there (a
        PAD id's product wraps there and here alike). Clusters are unsorted
        and may repeat."""
        k = torch.arange(1, K + 1, dtype=torch.int32, device=ids.device)
        prod = torch.remainder(ids.to(torch.int32)[..., None] * k, C)
        cl = torch.remainder(prod * (2654435761 % C), C)
        sc = (1.0 / (1.0 + torch.arange(K, dtype=torch.float32, device=ids.device))).expand(prod.shape)
        return cl, sc

    def author_follows_viewer_dev(uid: torch.Tensor, authors: torch.Tensor) -> torch.Tensor:
        # twin of the host fixture's followers = range(0, num_authors, 7)
        return (authors >= 0) & (torch.remainder(authors, 7) == 0)

    device_spec = dict(
        doc_table=on(doc_table),
        eng_ids=on(eng_ids, np.int32),
        eng_types=on(eng_types, np.int32),
        eng_ts=on(eng_ts, np.int32),
        tweet_emb_device=tweet_emb_device,
        author_follows_viewer_device=author_follows_viewer_dev,
    )

    return dict(
        doc_fn=doc_fn,
        pair_aggs=pair_aggs,
        realgraph_table=rg_table,
        realgraph_params=rg_params,
        twhin_user=table(num_users, 64),
        twhin_author=table(num_authors, 64),
        twhin_tweet=table(num_tweets, 64),
        twhin_user_negative=table(num_users, 64),
        twhin_author_follow=table(num_authors, 64),
        user_interests_table=table(num_users, 128),
        author_agg_table=table(num_authors, 128),
        media_cluster_table=table(num_tweets, 64),
        text_embedding_table=table(num_tweets, 128),
        tweet_agg=agg_fixture("tweet_agg", min(num_tweets, 512)),
        author_agg=agg_fixture("author_agg", num_authors),
        user_agg=agg_fixture("user_agg", num_users),
        signal_store=sig_store,
        gfs_tables=gfs_tables,
        tweepcred=on(rng.integers(0, 100, num_authors), np.float32),
        author_meta=on(meta),
        followers_of_viewer_fn=lambda uid: frozenset(range(0, num_authors, 7)),
        tweet_embedding_fn=tweet_embedding_fn,
        engagement_fn=engagement_fn,
        interested_in_fn=interested_in_fn,
        device_spec=device_spec,
    )
