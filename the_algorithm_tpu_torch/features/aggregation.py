"""Timelines aggregation framework: grouped decayed-counter features.

Counterpart of ``the_algorithm_tpu/features/aggregation.py``
(``timelines/data_processing/ml_util/aggregation_framework/``): an
``AggregateGroup`` is (features × labels × metrics × half-lives); each group
is a [capacity, n_outputs] float32 table plus per-row last-update
timestamps on a device. :func:`update` folds an event batch with scatters
(decay folded in), :func:`read` decays to ``now``. Key → row assignment is
the host's :class:`KeyResolver` (the memcache-key layer).

Scatters with repeated rows: JAX's ``.at[].set`` of identical rows is an
indexed assignment; ``.at[].add`` is ``index_put_(accumulate=True)`` (summed
in another order); ``.at[].max``/``.min`` are ``scatter_reduce_`` with
``amax``/``amin`` over the old values.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve

METRICS = ("count", "sum", "sumsq", "max", "latest", "last_reset")
SET_METRICS = ("latest", "last_reset")  # the batch's last qualifying event wins


@dataclasses.dataclass(frozen=True)
class AggregateGroup:
    """≡ ``AggregateGroup.scala``: the cross-product spec."""

    name: str
    features: Tuple[str, ...]  # continuous inputs (e.g. "fav_count")
    labels: Tuple[str, ...]  # binary conditions (e.g. "is_favorited"); "any" = unconditioned
    metrics: Tuple[str, ...] = ("count", "sum")
    half_lives_s: Tuple[float, ...] = (50 * 86400.0,)  # 50-day default

    def output_names(self) -> List[str]:
        """≡ TypedAggregateGroup feature naming."""
        return [f"{self.name}.{f}.{l}.{m}.{_hl_name(hl)}"
                for f, l, m, hl in itertools.product(self.features, self.labels, self.metrics, self.half_lives_s)]

    @property
    def n_outputs(self) -> int:
        return len(self.features) * len(self.labels) * len(self.metrics) * len(self.half_lives_s)


def _hl_name(hl: float) -> str:
    return f"{int(hl // 86400)}d" if hl >= 86400 else f"{int(hl)}s"


class AggregateStore(NamedTuple):
    values: torch.Tensor  # [capacity, n_outputs] float32
    last_ts: torch.Tensor  # [capacity] int32


def init_store(group: AggregateGroup, capacity: int, device=None) -> AggregateStore:
    """An empty store on ``device`` (default: the card)."""
    dev = resolve(device, "AggregateStore")
    return AggregateStore(torch.zeros((capacity, group.n_outputs), dtype=torch.float32, device=dev),
                          torch.zeros((capacity,), dtype=torch.int32, device=dev))


def _layout(group: AggregateGroup):
    """index math: output column for (f_idx, l_idx, m_idx, h_idx)."""
    nl, nm, nh = len(group.labels), len(group.metrics), len(group.half_lives_s)

    def col(f, l, m, h):
        return ((f * nl + l) * nm + m) * nh + h

    return col


def _metric_mask(group: AggregateGroup, pred, device) -> torch.Tensor:
    """[n_outputs] bool: the columns whose metric satisfies ``pred``."""
    F, L, H = len(group.features), len(group.labels), len(group.half_lives_s)
    flags = np.asarray([pred(m) for m in group.metrics])
    return torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(flags[None, None, :, None], (F, L, len(flags), H)).reshape(-1))).to(device)


def _hl_cols(group: AggregateGroup, device) -> torch.Tensor:
    """[n_outputs] float32: each column's half-life."""
    return torch.tensor(list(group.half_lives_s) * (group.n_outputs // len(group.half_lives_s)),
                        dtype=torch.float32, device=device)


def update(
    group: AggregateGroup,
    store: AggregateStore,
    row_ids: torch.Tensor,  # [B] int pre-resolved key rows
    feature_values: torch.Tensor,  # [B, F]
    label_values: torch.Tensor,  # [B, L] in {0,1}
    timestamps: torch.Tensor,  # [B] int32 (non-decreasing)
) -> AggregateStore:
    """Fold an event batch into the store (decay at each touched row); returns
    a new store.

    Decays each touched row to the batch max timestamp then adds the batch's
    contributions (events within the batch are treated as simultaneous at
    batch time — the realtime Heron job's micro-batching semantics).
    """
    dev = store.values.device
    row_ids = row_ids.to(dev, torch.int64)
    feature_values = feature_values.to(dev, torch.float32)
    label_values = label_values.to(dev, torch.float32)
    timestamps = timestamps.to(dev, torch.int32)
    now = timestamps.max()
    B = row_ids.shape[0]
    F, L = len(group.features), len(group.labels)
    M, H = len(group.metrics), len(group.half_lives_s)

    # per-(feature, metric) event values [B, F, M], gated per label and
    # broadcast over half-lives (col = ((f*L + l)*M + m)*H + h, as _layout)
    base_cols = []
    for metric in group.metrics:
        if metric == "count":
            base_cols.append(torch.ones_like(feature_values))
        elif metric in ("sum", "max", "latest"):
            base_cols.append(feature_values)
        elif metric == "sumsq":
            base_cols.append(feature_values * feature_values)
        elif metric == "last_reset":
            # value := the event timestamp (≡ LastResetMetric: when the label last fired)
            base_cols.append(timestamps.float()[:, None].expand_as(feature_values))
        else:
            raise ValueError(f"unsupported metric {metric}")
    base = torch.stack(base_cols, dim=-1)  # [B, F, M]
    gated = torch.einsum("bfm,bl->bflm", base, label_values)  # [B, F, L, M]
    contrib = gated[..., None].expand(B, F, L, M, H).reshape(B, group.n_outputs)
    is_max = _metric_mask(group, lambda m: m == "max", dev)
    is_set = _metric_mask(group, lambda m: m in SET_METRICS, dev)

    dt = (now - store.last_ts[row_ids]).float()  # [B]
    decay = torch.exp2(-dt[:, None] / _hl_cols(group, dev)[None, :])
    decay = torch.where(is_set[None, :], 1.0, decay)  # set metrics don't decay
    old_rows = store.values[row_ids] * decay  # equal for equal rows
    add_contrib = torch.where(is_max[None, :] | is_set[None, :], 0.0, contrib)
    max_contrib = torch.where(is_max[None, :], contrib, -torch.inf)

    values = store.values.clone()
    values[row_ids] = old_rows
    values.index_put_((row_ids,), add_contrib, accumulate=True)
    idx = row_ids[:, None].expand(B, group.n_outputs)
    values.scatter_reduce_(0, idx, max_contrib, reduce="amax")

    if any(m in SET_METRICS for m in group.metrics):
        # winner per (row, label): the last event in the batch whose label
        # fired for that row (a scatter-max of batch position); REPLACE as
        # clear-then-max: drive the fired set-columns to -inf, then max in
        # exactly the winner's value
        pos = torch.arange(B, dtype=torch.int32, device=dev)
        fired = label_values > 0  # [B, L]
        pos_gated = torch.where(fired, pos[:, None], -1)  # [B, L]
        winner = torch.full((values.shape[0], L), -1, dtype=torch.int32, device=dev)
        winner.scatter_reduce_(0, row_ids[:, None].expand(B, L), pos_gated, reduce="amax")
        is_winner = (pos_gated >= 0) & (pos_gated == winner[row_ids])  # [B, L]

        def per_label(mask):  # [B, L] → [B, n_outputs] on the set columns
            return mask[:, None, :, None, None].expand(B, F, L, M, H).reshape(B, -1) & is_set[None, :]

        values.scatter_reduce_(0, idx, torch.where(per_label(fired), -torch.inf, torch.inf), reduce="amin")
        values.scatter_reduce_(0, idx, torch.where(per_label(is_winner), contrib, -torch.inf), reduce="amax")
    last_ts = store.last_ts.clone()
    last_ts[row_ids] = now
    return AggregateStore(values, last_ts)


def read(group: AggregateGroup, store: AggregateStore, row_ids: torch.Tensor, now) -> torch.Tensor:
    """[B, n_outputs] decayed to ``now`` — the DataRecord hydration read; the
    set-semantics columns read undecayed."""
    dev = store.values.device
    dt = (now - store.last_ts[row_ids]).float()
    decay = torch.exp2(-dt[:, None] / _hl_cols(group, dev)[None, :])
    decay = torch.where(_metric_mask(group, lambda m: m in SET_METRICS, dev)[None, :], 1.0, decay)
    return store.values[row_ids] * decay


class KeyResolver:
    """Host-side key→row assignment (the group-by / memcache-key layer); a
    copy of the JAX package's."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._map: Dict[Tuple, int] = {}

    def resolve(self, keys: Sequence[Tuple]) -> np.ndarray:
        """Write-path resolution: unknown keys allocate a new row."""
        out = np.empty(len(keys), np.int32)
        for i, k in enumerate(keys):
            if k not in self._map:
                if len(self._map) >= self.capacity:
                    raise KeyError("aggregate store capacity exhausted")
                self._map[k] = len(self._map)
            out[i] = self._map[k]
        return out

    def lookup(self, keys: Sequence[Tuple]) -> np.ndarray:
        """Read-path resolution: unknown keys → -1, NO allocation (serving
        reads must not consume store rows)."""
        out = np.empty(len(keys), np.int32)
        for i, k in enumerate(keys):
            out[i] = self._map.get(k, -1)
        return out

    @staticmethod
    def _encode(k0: np.ndarray, k1: Optional[np.ndarray]) -> np.ndarray:
        k0 = np.asarray(k0, np.int64)
        if k1 is None:
            return k0
        # pairs pack as k0·2³² + (k1 mod 2³²) — unique for int32-domain keys
        return k0 * (1 << 32) + (np.asarray(k1, np.int64) & 0xFFFFFFFF)

    def lookup_vec(self, k0: np.ndarray, k1: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized read-path lookup for 1- or 2-int key columns: a sorted
        encoded index (rebuilt lazily when the map grows) and one
        ``searchsorted`` per column."""
        if getattr(self, "_enc_n", -1) != len(self._map):
            items = list(self._map.items())
            codes = np.empty(len(items), np.int64)
            rows = np.empty(len(items), np.int32)
            for i, (k, r) in enumerate(items):
                codes[i] = k[0] if len(k) == 1 else k[0] * (1 << 32) + (k[1] & 0xFFFFFFFF)
                rows[i] = r
            order = np.argsort(codes)
            self._enc_codes = codes[order]
            self._enc_rows = rows[order]
            self._enc_n = len(items)
        want = self._encode(k0, k1)
        if self._enc_n == 0:
            return np.full(want.shape[0], -1, np.int32)
        pos = np.clip(np.searchsorted(self._enc_codes, want), 0, self._enc_n - 1)
        hit = self._enc_codes[pos] == want
        return np.where(hit, self._enc_rows[pos], -1).astype(np.int32)
