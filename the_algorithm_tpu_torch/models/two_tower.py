"""TwHIN-style two-tower embeddings with in-batch negatives: the dense
user/item retrieval model.

Counterpart of ``the_algorithm_tpu/models/two_tower.py``: the user and item
towers over id-embedding tables, the in-batch sampled softmax that trains
them, and the exact dense top-K (``tweet-mixer/.../twhin_ann/
TwHINANNCandidateSource.scala``, the VecDB/HNSW capability served as a
brute-force product). Every table read goes through
:func:`~the_algorithm_tpu_torch.ops.gather.table_read`: a ``row_gather``
launch at the row JAX's gather reads (a negative id wraps, an id past the
end clamps), and under autograd a dense [N, D] table gradient from the D-wide
run collapse (an id outside the table gets none, as in JAX). Tables are
trainable; serving reads them under ``torch.no_grad()`` or frozen.

On a mesh (``training/trainer.py`` with :data:`PARTITION_RULES`) the tables
hold this rank's row block, ``P('model', None)``:

  - by default the forward reads ``table[ids]`` across the blocks
    (``sharded_table.lookup``: JAX's index rule and gradient) for this
    rank's 'data' block of the batch;
  - with ``explicit_lookup`` the forward takes this rank's block of the
    joint ('data', 'model') batch (:attr:`TwoTower.batch_axes`) and reads
    through the all-to-all row exchange (``sharded_table.lookup_collective``
    under ``get_mesh()``, which raises without one): ids are clipped, and
    their gradient trains the clipped row, as in JAX.

The in-batch loss then spans the global batch, as GSPMD's does: it gathers
the item embeddings and ids over the batch's axes (:func:`in_batch_softmax_loss`).
The serving methods (:meth:`TwoTower.user_embeddings`, ``item_embeddings``)
read whole tables: a served model is built from an export's global arrays.

:func:`params_from_flax` turns the JAX package's flax params into this
module's ``state_dict``; :func:`params_to_flax` is its inverse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.core.mesh import JOINT_AXES, gather_rows, get_mesh
from the_algorithm_tpu_torch.core.partition import P, current_batch_split
from the_algorithm_tpu_torch.models.masknet import _lecun_normal_
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.gather import table_read
from the_algorithm_tpu_torch.parallel.sharded_table import ShardedTable, lookup, lookup_collective

TABLE_STD = 0.02  # flax nn.initializers.normal(0.02)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    num_users: int
    num_items: int
    embed_dim: int = 128
    tower_hidden: Tuple[int, ...] = (128,)
    temperature: float = 0.05
    dtype: str = "float32"
    # explicit all-to-all row exchange for the table gathers (see
    # parallel/sharded_table.lookup_collective); batch % devices == 0.
    explicit_lookup: bool = False


# ``table[ids]`` as JAX's gather reads it, ids of any shape → ids.shape + (D,):
# one row_gather launch, and the table's gradient when autograd records
table_rows = table_read


def read_rows(table: torch.Tensor, num_rows: int, ids: torch.Tensor, explicit: bool) -> torch.Tensor:
    """A training forward's table read: a whole [num_rows, D] table through
    :func:`table_rows`; this rank's row block of it across the mesh
    (``get_mesh()``): the row exchange when ``explicit``, else the sum of
    the blocks' reads, each with its JAX path's gradient."""
    if explicit:
        return lookup_collective(ShardedTable(table, num_rows), ids, get_mesh())
    if table.shape[0] == num_rows:
        return table_rows(table, ids)
    return lookup(get_mesh(), ShardedTable(table, num_rows), ids)


def init_table(rows: int, dim: int, device, generator: Optional[torch.Generator]) -> nn.Parameter:
    """A trainable [rows, dim] f32 table drawn as flax's ``normal(0.02)``
    draws it."""
    t = torch.empty(rows, dim, device=device)
    t.normal_(0.0, TABLE_STD, generator=generator)
    return nn.Parameter(t)


class Tower(nn.Module):
    """ReLU MLP, then ``x · rsqrt(Σx² + 1e-12)`` (not ``F.normalize``): the
    JAX tower's normalisation, whose gradient stays finite at a zero row."""

    def __init__(self, in_dim: int, hidden: Tuple[int, ...], out_dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = (in_dim,) + tuple(hidden)
        self.dense = nn.ModuleList(nn.Linear(widths[i], widths[i + 1], device=device) for i in range(len(hidden)))
        self.out = nn.Linear(widths[-1], out_dim, device=device)
        for lin in [*self.dense, self.out]:  # flax defaults: lecun-normal kernels, zero biases
            _lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.dense:
            x = F.relu(lin(x))
        x = self.out(x)
        return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


class TwoTower(nn.Module):
    """User and item towers over id-embedding tables. Built on the card
    unless ``device`` names another."""

    FLAX_COLLECTION = "params"  # its JAX names: core/partition.flax_layout

    def __init__(self, config: TwoTowerConfig, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve(device, "TwoTower")
        self.config = cfg = config
        self.user_table = init_table(cfg.num_users, cfg.embed_dim, dev, generator)
        self.item_table = init_table(cfg.num_items, cfg.embed_dim, dev, generator)
        self.user_tower = Tower(cfg.embed_dim, cfg.tower_hidden, cfg.embed_dim, device=dev, generator=generator)
        self.item_tower = Tower(cfg.embed_dim, cfg.tower_hidden, cfg.embed_dim, device=dev, generator=generator)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes a training batch is split over."""
        return JOINT_AXES if self.config.explicit_lookup else JOINT_AXES[:1]

    def forward(self, user_ids: torch.Tensor, item_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(user embeddings, item embeddings), each ``ids.shape + (D,)``;
        on a mesh, of this rank's block of the batch (:func:`read_rows`)."""
        cfg = self.config
        u = read_rows(self.user_table, cfg.num_users, user_ids, cfg.explicit_lookup)
        v = read_rows(self.item_table, cfg.num_items, item_ids, cfg.explicit_lookup)
        return self.user_tower(u), self.item_tower(v)

    def user_embeddings(self, user_ids: torch.Tensor) -> torch.Tensor:
        return self.user_tower(table_rows(self.user_table, user_ids))

    def item_embeddings(self, item_ids: torch.Tensor) -> torch.Tensor:
        return self.item_tower(table_rows(self.item_table, item_ids))


def in_batch_softmax_loss(u: torch.Tensor, v: torch.Tensor, temperature: float,
                          item_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sampled softmax where the batch is the negative pool: logits[i, j] =
    ⟨u_i, v_j⟩/τ in f32, label the diagonal. With ``item_ids``, an item that
    is another example's positive too is masked out of that example's
    negatives (accidental hits) with −1e9, not −inf (−inf poisons the
    softmax's gradient). The mean over the batch of −log softmax at the
    diagonal.

    Under a sharded ``Trainer`` (``core/partition.batch_split``) ``u``, ``v``
    and ``item_ids`` are this rank's block of the batch, and the negatives
    are the global batch's, as in JAX: ``v`` and the ids are gathered over
    the batch's axes (the gather's backward sums each block's cotangents
    over the ranks), and the result is the mean over this rank's rows, whose
    mean over the ranks (the Trainer's) is the global batch's loss."""
    split = current_batch_split()
    offset = 0
    if split is not None:
        mesh, axes = split
        offset = mesh.position(axes) * v.shape[0]
        v = gather_rows(v, mesh, axes)
        if item_ids is not None:
            item_ids = gather_rows(torch.as_tensor(item_ids, device=v.device), mesh, axes)
    logits = torch.matmul(u.float(), v.float().T) / temperature
    b, B = logits.shape
    if item_ids is not None:
        item_ids = torch.as_tensor(item_ids, device=logits.device)
        if split is None:
            eye = torch.eye(B, dtype=torch.bool, device=logits.device)
        else:  # row i's own column is offset + i
            rows = torch.arange(b, device=logits.device)
            eye = rows[:, None] + offset == torch.arange(B, device=logits.device)[None, :]
        off_diag_dup = (item_ids[offset:offset + b, None] == item_ids[None, :]) & ~eye
        logits = logits.masked_fill(off_diag_dup, -1e9)
    return -torch.log_softmax(logits, dim=-1).diagonal(offset).mean()


def retrieve_top_k(query: torch.Tensor, items: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force cosine top-K: query [Q, D] against items [N, D] →
    (row ids [Q, k] int32, scores [Q, k] f32), in ``lax.top_k``'s order.
    The product is f32 (TF32 off on the card); like ``lax.top_k``, a k
    larger than N raises."""
    if k > items.shape[0]:
        raise ValueError(f"top_k of k={k} over {items.shape[0]} items")
    scores = torch.matmul(query.float(), items.float().T)
    top_scores, top_ids = retrieval.top_k(scores, k)
    return top_ids.to(torch.int32), top_scores


PARTITION_RULES = [
    (r"user_table", P("model", None)),
    (r"item_table", P("model", None)),
    (r".*", P()),
]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _tower_from_flax(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    sd, j = {}, 0
    while f"dense_{j}" in p:
        sd[f"{prefix}.dense.{j}.weight"] = _t(p[f"dense_{j}"]["kernel"]).T.contiguous()
        sd[f"{prefix}.dense.{j}.bias"] = _t(p[f"dense_{j}"]["bias"])
        j += 1
    sd[f"{prefix}.out.weight"] = _t(p["out"]["kernel"]).T.contiguous()
    sd[f"{prefix}.out.bias"] = _t(p["out"]["bias"])
    return sd


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax params ``params/{user_table, item_table,
    user_tower/{dense_i, out}, item_tower/{dense_i, out}}`` (with or without
    the top-level ``"params"`` key) → this module's ``state_dict``. A flax
    ``Dense`` kernel is [in, out]; a torch ``Linear`` weight is [out, in]."""
    p = tree.get("params", tree)
    sd = {"user_table": _t(p["user_table"]), "item_table": _t(p["item_table"])}
    sd.update(_tower_from_flax(p["user_tower"], "user_tower"))
    sd.update(_tower_from_flax(p["item_tower"], "item_tower"))
    return sd


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The inverse of :func:`params_from_flax`: ``{"params": {...}}`` of f32
    numpy arrays, kernels back to [in, out]."""

    def a(name: str, transpose: bool = False) -> np.ndarray:
        x = state_dict[name].detach().to("cpu", torch.float32)
        return (x.T if transpose else x).contiguous().numpy()

    def tower(prefix: str) -> Dict:
        out, j = {}, 0
        while f"{prefix}.dense.{j}.weight" in state_dict:
            out[f"dense_{j}"] = {"kernel": a(f"{prefix}.dense.{j}.weight", True), "bias": a(f"{prefix}.dense.{j}.bias")}
            j += 1
        out["out"] = {"kernel": a(f"{prefix}.out.weight", True), "bias": a(f"{prefix}.out.bias")}
        return out

    return {"params": {"user_table": a("user_table"), "item_table": a("item_table"),
                       "user_tower": tower("user_tower"), "item_tower": tower("item_tower")}}
