"""The comparisons that decide ``correct``: each number the program's
output is judged by, worked out against the plain reference. Every number is
a gap (0 when the two agree), held to the cell's limit in
``limits/<cell>.json``."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import sann as ref_sann


def sann(prog_ids: torch.Tensor, prog_scores: torch.Tensor, cands: ref_sann.Candidates,
         ref_scores: torch.Tensor) -> Dict[str, float]:
    """A block of served lists against the reference's candidates.

    ``prog_ids`` / ``prog_scores`` [Qb, X] as served; ``cands`` every
    candidate of those queries (float64); ``ref_scores`` [Qb, X] the
    reference's own best X. Returns ``score_err``, the largest relative gap
    between a served score and the reference's cosine of that tweet for that
    query (infinite for a tweet that is no candidate of it, a repeated one
    or a missing slot), and ``rank_gap``, the widest share by which a served
    tweet's reference cosine lies below the reference's X-th best."""
    Qb, X = prog_ids.shape
    ids = prog_ids.long()
    keys = torch.arange(Qb, device=ids.device)[:, None] * (ref_sann.PAD_ID + 1) + ids
    pos = torch.searchsorted(cands.keys, keys.reshape(-1)).clamp(max=cands.keys.numel() - 1)
    found = (cands.keys[pos] == keys.reshape(-1)).reshape(Qb, X) & (ids != ref_sann.PAD_ID)
    ref_of = torch.where(found, cands.scores[pos].reshape(Qb, X), torch.nan)
    err = ((prog_scores.double() - ref_of).abs() / ref_of.abs()).nan_to_num(nan=math.inf)
    repeated = (torch.sort(ids, dim=1).values.diff(dim=1) == 0).any(dim=1)
    kth = ref_scores[:, -1:].double()
    below = (kth - ref_of.nan_to_num(nan=-math.inf)).clamp(min=0).amax(dim=1) / kth[:, 0].abs()
    below = torch.where(repeated, math.inf, below)
    return {"score_err": float(err.max()), "rank_gap": float(below.max())}


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of several blocks' readings, number by number."""
    return {k: max(r[k] for r in readings) for k in readings[0]}
