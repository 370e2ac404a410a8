"""Representation Scorer (RSX): engagement-similarity ML features.

Counterpart of ``the_algorithm_tpu/features/representation_scorer.py``
(``representation-scorer/.../twistlyfeatures/Scorer.scala:113-157``): for a
(user, candidate tweet) pair, the similarity between the candidate's
SimClusters embedding and the embeddings of the user's recent engagement
tweets per signal type and time window, aggregated as avg/max/min. One
pairwise matrix of candidates [C] × engagements [E] per similarity kind,
masked per signal and window, reduced.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from the_algorithm_tpu_torch.ops import sparse
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding

SIGNAL_TYPES = (
    "fav", "retweet", "reply", "share", "original_tweet", "video_playback",
)
WINDOWS_S = {"7d": 7 * 86400, "1d": 86400}


class EngagementSet(NamedTuple):
    """A user's recent engagement tweets (fixed width E, padded).

    ``signal_type``: index into SIGNAL_TYPES; ``timestamp``: event seconds.
    """

    embeddings: SparseEmbedding  # [E, K]
    signal_type: torch.Tensor  # [E] int32
    timestamp: torch.Tensor  # [E] int32
    valid: torch.Tensor  # [E] bool


# similarity kinds computed per (signal, window) block; "cosine" keeps the
# bare legacy names, the others prefix with the kind
SIMILARITY_KINDS = ("cosine", "dot", "log_cosine", "euclidean")
KIND_FNS = {
    "cosine": sparse.cosine,
    "dot": sparse.dot,
    "log_cosine": sparse.log_norm_cosine,
    "euclidean": sparse.euclidean,
}


def feature_names(kinds: Tuple[str, ...] = ("cosine",)) -> Tuple[str, ...]:
    """Column order of :func:`engagement_similarity_features`."""
    out = []
    for kind in kinds:
        prefix = "" if kind == "cosine" else f"{kind}_"
        for w_name in WINDOWS_S:
            for s_name in SIGNAL_TYPES:
                for agg in ("avg", "max", "min"):
                    out.append(f"{prefix}{s_name}_{w_name}_{agg}")
    return tuple(out)


def masked_aggregates(sim: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(avg, max, min) of ``sim`` [..., E] over the engagements ``m`` [..., E]
    selects, 0 where it selects none."""
    count = m.float().sum(-1)
    has = count > 0
    avg = torch.where(has, torch.where(m, sim, 0.0).sum(-1) / torch.clamp(count, min=1.0), 0.0)
    mx = torch.where(has, torch.where(m, sim, -torch.inf).amax(-1), 0.0)
    mn = torch.where(has, torch.where(m, sim, torch.inf).amin(-1), 0.0)
    return avg, mx, mn


def engagement_similarity_features(
    candidates: SparseEmbedding,  # [C, K]
    engagements: EngagementSet,
    now,
    kinds: Tuple[str, ...] = ("cosine",),
) -> Dict[str, torch.Tensor]:
    """→ {f"[{kind}_]{signal}_{window}_{agg}": [C]} feature block."""
    out: Dict[str, torch.Tensor] = {}
    age = now - engagements.timestamp
    for kind in kinds:
        sim = sparse.pairwise_matrix(KIND_FNS[kind], candidates, engagements.embeddings)  # [C, E]
        prefix = "" if kind == "cosine" else f"{kind}_"
        for w_name, w_secs in WINDOWS_S.items():
            in_window = engagements.valid & (age <= w_secs)
            for s_idx, s_name in enumerate(SIGNAL_TYPES):
                m = in_window & (engagements.signal_type == s_idx)  # [E]
                avg, mx, mn = masked_aggregates(sim, m[None, :])
                out[f"{prefix}{s_name}_{w_name}_avg"] = avg
                out[f"{prefix}{s_name}_{w_name}_max"] = mx
                out[f"{prefix}{s_name}_{w_name}_min"] = mn
    return out
