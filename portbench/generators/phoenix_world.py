"""The Phoenix cell's inputs and weights, drawn on the device from one
generator seeded by ``--seed``.

Weights: every parameter of the model, in the order of its sorted names,
drawn in place by its name and shape (flax-style scales; the configuration
file's ``assumed``). Requests: each batch's left-padded histories and its
candidates.
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple, Tuple

import torch

NON_PAD_ACTIONS = 22  # ActionName 1..22 (0 is PAD)
MAX_AGE_S = 14 * 86400
CORRECTION_BIAS = 0.05  # e_score_correction_bias uniform in [-0.05, 0.05]


def fill_weights(named: Iterable[Tuple[str, torch.Tensor]], gen: torch.Generator) -> None:
    """Draw every parameter in place: tables (``*.embedding``) normal of
    variance 1/width; the routers' correction bias uniform in ±0.05; other
    matrices normal of variance 1/fan_in (the last axis); biases 0; norm and
    LayerNorm weights 1."""
    with torch.no_grad():
        for name, p in sorted(named, key=lambda kv: kv[0]):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "embedding" or p.dim() >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=gen)
            elif leaf == "e_score_correction_bias":
                p.uniform_(-CORRECTION_BIAS, CORRECTION_BIAS, generator=gen)
            elif leaf == "bias":
                p.zero_()
            else:
                p.fill_(1.0)


class Batch(NamedTuple):
    action_ids: torch.Tensor  # [B, L] int32, 0 on padding
    author_hashes: torch.Tensor  # [B, L] int32
    age_s: torch.Tensor  # [B, L] int32
    valid: torch.Tensor  # [B, L] bool, left padding
    cand_authors: torch.Tensor  # [B, C] int32
    cand_bools: torch.Tensor  # [B, C, NB] f32 in {0, 1}
    cand_valid: torch.Tensor  # [B, C] bool


def draw_batch(B: int, L: int, C: int, min_valid: int, buckets: int, n_bool: int, gen: torch.Generator,
               device) -> Batch:
    """B requests: valid history lengths uniform in [min_valid, L], left
    padded; actions, authors and ages uniform; C valid candidates each."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    n = ints(min_valid, L + 1, (B,))
    valid = torch.arange(L, device=device)[None, :] >= (L - n)[:, None]
    actions = ints(1, NON_PAD_ACTIONS + 1, (B, L)) * valid
    authors = ints(0, buckets, (B, L))
    ages = ints(0, MAX_AGE_S, (B, L))
    c_authors = ints(0, buckets, (B, C))
    c_bools = ints(0, 2, (B, C, n_bool)).float()
    return Batch(actions.to(torch.int32), authors, ages, valid, c_authors, c_bools,
                 torch.ones((B, C), dtype=torch.bool, device=device))
