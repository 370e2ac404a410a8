"""TwHIN: heterogeneous-network knowledge-graph embeddings.

Counterpart of ``the_algorithm_tpu/models/twhin.py``: a TransE-style model
over a multi-relation engagement graph (el-Kishky et al. 2022,
arXiv:2202.05387), score(u, r, v) = ⟨e_u + t_r, e_v⟩ with per-relation
translation vectors, trained with in-batch negatives (:func:`twhin_loss`).
Every table read goes through :func:`~the_algorithm_tpu_torch.models.
two_tower.table_rows` (``row_gather`` with JAX's index rule, and under
autograd the D-wide run collapse's dense table gradient); the user, item and
relation tables are all trainable.

On a mesh the user and item tables hold this rank's row block
(:data:`PARTITION_RULES`) and are read as two-tower's are
(``two_tower.read_rows``: across the blocks, or with ``explicit_lookup``
through the row exchange for this rank's block of the joint batch); the
small relation table stays whole on every rank and keeps ``table_rows``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.core.mesh import JOINT_AXES
from the_algorithm_tpu_torch.core.partition import P
from the_algorithm_tpu_torch.models.two_tower import _t, in_batch_softmax_loss, init_table, read_rows, table_rows

RELATIONS = (
    "follows", "favorites", "replies", "retweets", "mentions", "clicks",
)


@dataclasses.dataclass(frozen=True)
class TwhinConfig:
    num_users: int
    num_items: int  # tweets/entities on the right side
    embed_dim: int = 128
    num_relations: int = len(RELATIONS)
    temperature: float = 1.0
    # explicit all-to-all row exchange for the big-table gathers (the
    # PS-multiget analog; requires batch % mesh devices == 0 and table rows
    # % model shards == 0). Default reads across the blocks.
    explicit_lookup: bool = False


class Twhin(nn.Module):
    """User, item and relation tables. Built on the card unless ``device``
    names another."""

    FLAX_COLLECTION = "params"  # its JAX names: core/partition.flax_layout

    def __init__(self, config: TwhinConfig, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve(device, "Twhin")
        self.config = cfg = config
        self.user_table = init_table(cfg.num_users, cfg.embed_dim, dev, generator)
        self.item_table = init_table(cfg.num_items, cfg.embed_dim, dev, generator)
        self.relation_table = init_table(cfg.num_relations, cfg.embed_dim, dev, generator)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes a training batch is split over."""
        return JOINT_AXES if self.config.explicit_lookup else JOINT_AXES[:1]

    def forward(self, user_ids: torch.Tensor, relation_ids: torch.Tensor,
                item_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(translated user embeddings e_u + t_r, item embeddings e_v), each
        [B, D]; on a mesh, of this rank's block of the batch."""
        cfg = self.config
        u = read_rows(self.user_table, cfg.num_users, user_ids, cfg.explicit_lookup)
        v = read_rows(self.item_table, cfg.num_items, item_ids, cfg.explicit_lookup)
        return u + table_rows(self.relation_table, relation_ids), v

    def translate(self, user_ids: torch.Tensor, relation_ids: torch.Tensor) -> torch.Tensor:
        """e_u + t_r for serving: two whole-table reads, one ``row_gather``
        launch each."""
        return table_rows(self.user_table, user_ids) + table_rows(self.relation_table, relation_ids)

    def translate(self, user_ids: torch.Tensor, relation_ids: torch.Tensor) -> torch.Tensor:
        """e_u + t_r: two table reads, one ``row_gather`` launch each."""
        return table_rows(self.user_table, user_ids) + table_rows(self.relation_table, relation_ids)


def twhin_loss(u_translated: torch.Tensor, v: torch.Tensor, item_ids: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
    """In-batch sampled softmax over ⟨e_u + t_r, e_v⟩ logits, an item that
    is another example's positive masked out of its negatives (−1e9)."""
    return in_batch_softmax_loss(u_translated, v, temperature, item_ids)


def entity_embeddings(model: Twhin, table: str = "item_table") -> torch.Tensor:
    """Export a table for ANN serving (consumed by ``TwHINANNEngine``)."""
    return getattr(model, table).detach()


PARTITION_RULES = [
    (r"user_table", P("model", None)),
    (r"item_table", P("model", None)),
    (r".*", P()),  # relation table is tiny → replicated
]


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax params ``params/{user_table, item_table,
    relation_table}`` (with or without the ``"params"`` key) → this
    module's ``state_dict``."""
    p = tree.get("params", tree)
    return {name: _t(p[name]) for name in ("user_table", "item_table", "relation_table")}
