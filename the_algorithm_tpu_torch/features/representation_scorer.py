"""Representation Scorer (RSX): engagement-similarity ML features.

Counterpart of ``the_algorithm_tpu/features/representation_scorer.py``
(``representation-scorer/.../twistlyfeatures/Scorer.scala:113-157``): for a
(user, candidate tweet) pair, the similarity between the candidate's
SimClusters embedding and the embeddings of the user's recent engagement
tweets per signal type and time window, aggregated as avg/max/min. One
pairwise matrix of candidates [C] × engagements [E] per similarity kind,
masked per signal and window, reduced. The score-store pieces
(:class:`PairScoreStore`, :func:`weighted_sum_score`) stand beside it, as
in the JAX module.
"""

from __future__ import annotations

import dataclasses
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


# -- generic pairwise score store (simclusters_v2/score facade analog) -------


@dataclasses.dataclass(frozen=True)
class PairScoreStore:
    """≡ ``SimClustersEmbeddingPairScoreStore.build*Store``
    (``simclusters_v2/score/SimClustersEmbeddingPairScoreStore.scala:39-139``):
    one callable per similarity kind over embedding pairs of any batch shape."""

    kind: str  # dot | cosine | log_cosine | exp_cosine | jaccard | euclidean | manhattan

    def __call__(self, a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
        fn = {
            "dot": sparse.dot,
            "cosine": sparse.cosine,
            "log_cosine": sparse.log_norm_cosine,
            "exp_cosine": sparse.exp_scaled_cosine,
            "jaccard": sparse.fuzzy_jaccard,
            "euclidean": sparse.euclidean,
            "manhattan": sparse.manhattan,
        }[self.kind]
        return fn(a, b)


def weighted_sum_score(scores: Dict[str, torch.Tensor], weights: Dict[str, float]) -> torch.Tensor:
    """≡ ``score/WeightedSumAggregatedScoreStore.scala``: a linear blend of
    pair scores, summed in ``weights``' order."""
    total = None
    for k, w in weights.items():
        term = scores[k] * w
        total = term if total is None else total + term
    return total
