"""Follow Recommendations Service (FRS): who-to-follow flows.

Counterpart of ``the_algorithm_tpu/mixers/follow_recommendations.py``
(``follow-recommendations-service/``): per-display-location
``RecommendationFlow``s — candidate sources → predicates → ranker →
truncation. The two device sources read the adjacency through one
``row_gather`` launch a hop (both tables of a hop together) and dedup their
flat entries with one ``run_collapse_sorted`` launch: the JAX package
collapses a flat 1-D array, the kernel a [Q, W] row block, so the entries
go in as one row of Q = 1. The top-K keeps ``lax.top_k``'s order
(:func:`~the_algorithm_tpu_torch.ops.retrieval.top_k`). Results stay on the
adjacency's device; the caller brings them to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.retrieval import _dedup_sum, top_k
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.pipeline.component import Candidate
from the_algorithm_tpu_torch.simclusters.known_for import Graph


def hop_rows(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The int32 row each id of a hop reads: PAD_ID reads row 0 (its
    entries are masked), any other id the row JAX's gather reads."""
    return jax_rows(torch.where(ids != PAD_ID, ids, 0), num_rows).to(torch.int32)


def top_unique(ids: torch.Tensor, weights: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """dedup-sum → top-k over PAD-padded id/weight arrays of any shape, as
    one flat row: (ids [k'], scores [k']) with k' = min(k, ids.numel());
    empty slots are PAD_ID / -inf."""
    uniq, scores = _dedup_sum(ids.reshape(1, -1).contiguous(), weights.reshape(1, -1).contiguous())
    masked = torch.where(uniq != PAD_ID, scores, -torch.inf)
    top, idx = top_k(masked, min(k, masked.shape[-1]))
    return torch.where(torch.isfinite(top), torch.gather(uniq, 1, idx), PAD_ID)[0], top[0]


def similar_producers_candidates(
    sims: Graph,  # producer-producer similarity graph
    followed: torch.Tensor,  # [S] producers the user follows (PAD padded)
    max_results: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """"Producers similar to who you follow": expand follows through the
    sims graph, sum similarity over seeds (dedup), top-K."""
    valid = followed != PAD_ID
    nbr, nbr_w = row_gather(hop_rows(followed, sims.num_nodes), sims.nbr_ids, sims.nbr_weights)  # [S, D]
    w = torch.where(valid[:, None], nbr_w, 0.0)
    flat_ids = torch.where(valid[:, None] & (nbr != PAD_ID), nbr, PAD_ID)
    return top_unique(flat_ids, w, max_results)


def triangular_closure_candidates(
    follow_adj: torch.Tensor,  # [U, D] user→producer follows (PAD padded)
    followed: torch.Tensor,  # [S] the user's follows (as user ids into follow_adj)
    max_results: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-hop closure: accounts followed by accounts you follow, scored by
    #paths."""
    valid = followed != PAD_ID
    (second,) = row_gather(hop_rows(followed, follow_adj.shape[0]), follow_adj)  # [S, D]
    ok2 = valid[:, None] & (second != PAD_ID)
    return top_unique(torch.where(ok2, second, PAD_ID), ok2.float(), max_results)


@dataclasses.dataclass
class RecommendationFlow:
    """≡ FRS ``RecommendationFlow``: sources → predicates → rank → truncate."""

    sources: Sequence[Callable[[object], List[Candidate]]]
    predicates: Sequence[Callable[[object, Candidate], bool]]
    ranker: Optional[Callable[[object, List[Candidate]], None]] = None
    max_results: int = 20

    def run(self, request) -> List[Candidate]:
        candidates: List[Candidate] = []
        seen = set()
        for source in self.sources:
            for c in source(request):
                if c.id not in seen:
                    seen.add(c.id)
                    candidates.append(c)
        candidates = [
            c
            for c in candidates
            if all(p(request, c) for p in self.predicates)
        ]
        if self.ranker is not None:
            self.ranker(request, candidates)
        candidates.sort(key=lambda c: -(c.score or 0.0))
        return candidates[: self.max_results]


# standard predicates (≡ common/.../predicates/)


def not_already_followed(request, candidate: Candidate) -> bool:
    return candidate.id not in getattr(request, "followed_set", set())


def not_blocked(request, candidate: Candidate) -> bool:
    return candidate.id not in getattr(request, "blocked_set", set())


def not_self(request, candidate: Candidate) -> bool:
    return candidate.id != getattr(request, "user_id", None)
