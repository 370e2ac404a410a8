"""The comparison that decides the Phoenix cell's ``correct``: the
program's logits and served answers against the plain f32 reference
(``reference/phoenix_moonlight.py``), over valid candidates and actions.
Every number is a gap (0 when the two agree), held to the cell's limit."""

from __future__ import annotations

from typing import Dict

import torch


def phoenix(prog_logits: torch.Tensor, answers: torch.Tensor, ref: Dict, cand_valid: torch.Tensor) -> Dict[str, float]:
    """``prog_logits`` [B, C, A] of the program's run whose routes the
    reference followed, ``answers`` [B, C, A] the probabilities the program
    served, ``ref`` the reference's readings. Returns ``logit_err``, the
    largest |program − reference| logit over the RMS of the reference's
    logits; ``answer_err``, the largest |served − sigmoid(reference)|
    probability; ``route_far``, the valid tokens the program routed to an
    expert beyond the reference's tolerance (summed over routed layers)."""
    ref_logits = ref["logits"].float()
    v = cand_valid[..., None].expand_as(ref_logits).to(ref_logits.device)
    rms = ref_logits[v].pow(2).mean().sqrt()
    gap = (prog_logits.float().to(ref_logits.device) - ref_logits).abs()[v]
    served = (answers.float().to(ref_logits.device) - torch.sigmoid(ref_logits)).abs()[v]
    return {"logit_err": float(gap.max() / rms), "answer_err": float(served.max()),
            "route_far": float(ref["route_far"])}
