"""TwHIN: heterogeneous-network knowledge-graph embeddings.

Counterpart of ``the_algorithm_tpu/models/twhin.py``: a TransE-style model
over a multi-relation engagement graph (el-Kishky et al. 2022,
arXiv:2202.05387), score(u, r, v) = ⟨e_u + t_r, e_v⟩ with per-relation
translation vectors, trained with in-batch negatives (:func:`twhin_loss`).
Every table read goes through :func:`~the_algorithm_tpu_torch.models.
two_tower.table_rows` (``row_gather`` with JAX's index rule, and under
autograd the D-wide run collapse's dense table gradient); the user, item and
relation tables are all trainable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.models.two_tower import _t, in_batch_softmax_loss, init_table, table_rows

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
    # the JAX package's all-to-all row exchange (a mesh); not on one device
    explicit_lookup: bool = False


class Twhin(nn.Module):
    """User, item and relation tables. Built on the card unless ``device``
    names another."""

    def __init__(self, config: TwhinConfig, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.explicit_lookup:
            raise NotImplementedError("explicit_lookup needs a device mesh; the port runs on one device")
        dev = resolve(device, "Twhin")
        self.config = cfg = config
        self.user_table = init_table(cfg.num_users, cfg.embed_dim, dev, generator)
        self.item_table = init_table(cfg.num_items, cfg.embed_dim, dev, generator)
        self.relation_table = init_table(cfg.num_relations, cfg.embed_dim, dev, generator)

    def forward(self, user_ids: torch.Tensor, relation_ids: torch.Tensor,
                item_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(translated user embeddings e_u + t_r, item embeddings e_v), each [B, D]."""
        return self.translate(user_ids, relation_ids), table_rows(self.item_table, item_ids)

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


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax params ``params/{user_table, item_table,
    relation_table}`` (with or without the ``"params"`` key) → this
    module's ``state_dict``."""
    p = tree.get("params", tree)
    return {name: _t(p[name]) for name in ("user_table", "item_table", "relation_table")}
