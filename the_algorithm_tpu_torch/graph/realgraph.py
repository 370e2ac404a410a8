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

The p(interaction) edge model (the BQML boosted tree's role): :func:`init_model`,
:func:`loss_fn` (trained by autograd through any of the port's optimizers)
and :func:`top_edges`, a user's strongest edges by model score — the UTEG
seed-set source — whose row reads are one ``row_gather`` launch and whose
top-K keeps ``lax.top_k``'s order among equal scores. :func:`params_from_jax`
carries the JAX package's ``{"w", "b"}`` over.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
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


# -- p(interaction) edge model (the BQML boosted-tree role) ------------------


def init_model(generator: Optional[torch.Generator] = None, device=None) -> Dict[str, torch.Tensor]:
    """``{"w": 0.01·N(0, 1) [F], "b": 0}`` on ``device`` (default: the
    card), drawn from ``generator`` (JAX draws from a PRNG key: other
    numbers; :func:`params_from_jax` carries JAX's over). Both require
    grad."""
    dev = resolve(device, "RealGraph model")
    w = torch.empty(len(INTERACTION_TYPES), device=dev).normal_(0.0, 1.0, generator=generator) * 0.01
    return {"w": w.requires_grad_(), "b": torch.zeros((), device=dev, requires_grad=True)}


def params_from_jax(params: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"w", "b"}`` (numpy or JAX arrays) → this
    module's f32 tensors on ``device`` (default: the card), requiring grad."""
    dev = resolve(device, "RealGraph model")
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=dev).requires_grad_() for k in ("w", "b")}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: f32 numpy arrays."""
    return {k: params[k].detach().to("cpu", torch.float32).numpy() for k in ("w", "b")}


def _logits(params: Mapping[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
    return torch.log1p(features) @ params["w"] + params["b"]


def predict_edge_scores(params: Dict[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
    """[..., F] features → p(interaction) in (0,1): the RealGraph weight."""
    return torch.sigmoid(_logits(params, features))


def loss_fn(params: Mapping[str, torch.Tensor], features: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss of the edge model: ``features`` [B, F], ``labels``
    [B] did-interact-in-next-window."""
    logits = _logits(params, features)
    return torch.mean(-labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits))


def top_edges(table: EdgeTable, params: Mapping[str, torch.Tensor], user_id, now, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A user's strongest edges by model score — the UTEG seed-set source.

    ``user_id`` is one id (→ ids [k], scores [k]) or a [B] batch (→ [B, k]),
    read at JAX's row (a negative id wraps, an id past the table clamps).
    The user's neighbour, count and timestamp rows come in one
    ``row_gather`` launch; the top-K is ``lax.top_k``'s order (score, then
    slot); a padded slot's −inf comes back as PAD_ID with score 0.
    """
    U, D = table.neighbor_ids.shape
    if k > D:  # as lax.top_k
        raise ValueError(f"top_k of k={k} over {D} edges")
    Fn = table.counts.shape[-1]
    dev = table.neighbor_ids.device
    ids = torch.as_tensor(user_id, device=dev)
    single = ids.dim() == 0
    rows = jax_rows(ids.reshape(-1), U).to(torch.int32)
    nbrs, counts, last = row_gather(rows, table.neighbor_ids, table.counts.reshape(U, D * Fn),
                                    table.last_ts.reshape(U, 1))
    now = torch.as_tensor(now, device=dev)
    decay = torch.exp2(-torch.clamp(now - last, min=0).float() / DEFAULT_HALF_LIFE_S)  # [B, 1]
    feats = counts.reshape(-1, D, Fn) * decay[:, :, None]
    scores = torch.where(nbrs != PAD_ID, predict_edge_scores(params, feats), float("-inf"))
    top_s, idx = retrieval.top_k(scores.float(), k)
    finite = torch.isfinite(top_s)
    out_ids = torch.where(finite, torch.gather(nbrs, 1, idx), PAD_ID)
    out_s = torch.where(finite, top_s, 0.0)
    return (out_ids[0], out_s[0]) if single else (out_ids, out_s)
