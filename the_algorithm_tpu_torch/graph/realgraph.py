"""RealGraph: user-user interaction-strength model.

Counterpart of ``the_algorithm_tpu/graph/realgraph.py``
(``src/scala/com/twitter/interaction_graph/``): 9 directed edge-interaction
types rolled up with exponential decay into a fixed-width edge table per
user, and a logistic p(interaction) model over the edge features — the
follow-graph edge weight of the home feature hydrators.

:func:`apply_interactions` is the JAX package's sequential ``lax.scan`` over
the event stream (decay the source row, find-or-insert the destination
slot, evicting the weakest edge when full, bump the count). On the card one
op per event would cost about a million launches for bench.py's 65,536
events, so the port folds the stream on the host in numpy, in stream order
and in float32 as the scan does, and uploads the table once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

INTERACTION_TYPES = (
    "fav", "retweet", "reply", "mention", "dm", "profile_view",
    "tweet_click", "link_click", "follow",
)
DEFAULT_HALF_LIFE_S = 14 * 86400.0  # two-week decay rollup


class EdgeTable(NamedTuple):
    """Directed edges user→neighbor with decayed interaction counts.

    [U, D] neighbors (PAD_ID padded), [U, D, F] decayed counts valid at
    ``last_ts[u]``.
    """

    neighbor_ids: torch.Tensor  # [U, D] int32
    counts: torch.Tensor  # [U, D, F] float32
    last_ts: torch.Tensor  # [U] int32


def init_table(num_users: int, degree: int, device=None) -> EdgeTable:
    """An empty table on ``device`` (default: the card)."""
    dev = resolve(device, "EdgeTable")
    F = len(INTERACTION_TYPES)
    return EdgeTable(torch.full((num_users, degree), PAD_ID, dtype=torch.int32, device=dev),
                     torch.zeros((num_users, degree, F), dtype=torch.float32, device=dev),
                     torch.zeros((num_users,), dtype=torch.int32, device=dev))


def apply_interactions(
    table: EdgeTable,
    src,  # [B] int32
    dst,  # [B] int32
    interaction_type,  # [B] int32 index into INTERACTION_TYPES
    timestamps,  # [B] int32 non-decreasing
    half_life_s: float = DEFAULT_HALF_LIFE_S,
) -> EdgeTable:
    """Fold an interaction batch (the agg_direct_interactions job), event by
    event in stream order on the host; returns a new table on the table's
    device. Slot choice as the JAX scan: an existing match, else the first
    empty slot, else the first of the weakest edges (least decayed total)."""
    nbrs = table.neighbor_ids.cpu().numpy().copy()
    cnts = table.counts.cpu().numpy().copy()
    last = table.last_ts.cpu().numpy().copy()
    hl = np.float32(half_life_s)
    events = (np.asarray(a, np.int64).reshape(-1).tolist() for a in (src, dst, interaction_type, timestamps))
    for s, d, it, ts in zip(*events):
        row_n, row_c = nbrs[s], cnts[s]
        row_c *= np.exp2(-np.float32(max(ts - int(last[s]), 0)) / hl)
        hit = np.flatnonzero(row_n == d)
        if hit.size:
            slot = int(hit[0])
        else:
            empty = np.flatnonzero(row_n == PAD_ID)
            slot = int(empty[0]) if empty.size else int(np.argmin(row_c.sum(axis=-1, dtype=np.float32)))
            row_c[slot] = 0.0
            row_n[slot] = d
        row_c[slot, it] += np.float32(1.0)
        last[s] = ts
    dev = table.neighbor_ids.device
    return EdgeTable(*(torch.from_numpy(a).to(dev) for a in (nbrs, cnts, last)))


def edge_features(table: EdgeTable, now, half_life_s: float = DEFAULT_HALF_LIFE_S) -> torch.Tensor:
    """[U, D, F] decayed-to-now features."""
    decay = torch.exp2(-torch.clamp(now - table.last_ts, min=0).float() / half_life_s)
    return table.counts * decay[:, None, None]


def predict_edge_scores(params: Dict[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
    """[..., F] features → p(interaction) in (0,1): the RealGraph weight."""
    return torch.sigmoid(torch.log1p(features) @ params["w"] + params["b"])
