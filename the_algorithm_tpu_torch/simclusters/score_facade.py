"""Score facade: ScoreId → score store composition.

Counterpart of ``the_algorithm_tpu/simclusters/score_facade.py``
(``simclusters_v2/score/{ScoreFacadeStore,WeightedSumAggregatedScoreStore,
Score}.scala``): one entry point that resolves pairwise scores (a
similarity applied to two embeddings fetched by id from RMS) and aggregate
scores (weighted sums of pairwise ones). A request for B pairs is two RMS
multigets and one broadcast call of the similarity over the [B, K] pairs
(``sparse.batched``, where the JAX package ``vmap``s).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.ops import sparse
from the_algorithm_tpu_torch.ops.sparse import SparseEmbedding
from the_algorithm_tpu_torch.simclusters.representation_manager import EmbeddingId, RepresentationManager

# ≡ thrift ScoringAlgorithm values handled by ScoreFacadeStore
PAIR_ALGORITHMS = {
    "PairEmbeddingDotProduct": sparse.dot,
    "PairEmbeddingCosineSimilarity": sparse.cosine,
    "PairEmbeddingLogCosineSimilarity": sparse.log_norm_cosine,
    "PairEmbeddingExpScaledCosineSimilarity": sparse.exp_scaled_cosine,
    "PairEmbeddingJaccardSimilarity": sparse.fuzzy_jaccard,
    "PairEmbeddingEuclideanDistance": sparse.euclidean,
    "PairEmbeddingManhattanDistance": sparse.manhattan,
}


@dataclasses.dataclass(frozen=True)
class PairScoreId:
    """≡ ``SimClustersEmbeddingPairScoreId`` (score.thrift): algorithm ×
    (embedding id, entity) × (embedding id, entity)."""

    algorithm: str
    a_embedding: EmbeddingId
    a_id: int
    b_embedding: EmbeddingId
    b_id: int


@dataclasses.dataclass(frozen=True)
class WeightedSumSpec:
    """≡ ``WeightedSumAggregatedScoreStore.scala``: a named linear blend of
    pairwise algorithms over the same entity pair."""

    name: str
    terms: Tuple[Tuple[str, float], ...]  # (pair algorithm, weight)


class ScoreFacadeStore:
    """≡ ``ScoreFacadeStore.scala``: one ``get`` for every score kind."""

    def __init__(self, rms: RepresentationManager):
        self.rms = rms
        self._aggregates: Dict[str, WeightedSumSpec] = {}

    def register_aggregate(self, spec: WeightedSumSpec) -> None:
        for alg, _ in spec.terms:
            if alg not in PAIR_ALGORITHMS:
                raise KeyError(f"unknown pair algorithm {alg}")
        self._aggregates[spec.name] = spec

    def _pairs(self, a_embedding, a_ids, b_embedding, b_ids) -> Tuple[SparseEmbedding, SparseEmbedding]:
        return self.rms.multiget(a_embedding, np.asarray(a_ids)), self.rms.multiget(b_embedding, np.asarray(b_ids))

    def pair_scores(
        self,
        algorithm: str,
        a_embedding: EmbeddingId,
        a_ids: Sequence[int],
        b_embedding: EmbeddingId,
        b_ids: Sequence[int],
    ) -> torch.Tensor:
        """[B] scores of B pairs: two multigets and one batched call."""
        return sparse.batched(PAIR_ALGORITHMS[algorithm])(*self._pairs(a_embedding, a_ids, b_embedding, b_ids))

    def get(self, score_id: PairScoreId) -> float:
        out = self.pair_scores(score_id.algorithm, score_id.a_embedding, [score_id.a_id],
                               score_id.b_embedding, [score_id.b_id])
        return float(out[0])

    def aggregate_scores(
        self,
        name: str,
        a_embedding: EmbeddingId,
        a_ids: Sequence[int],
        b_embedding: EmbeddingId,
        b_ids: Sequence[int],
    ) -> torch.Tensor:
        """[B] weighted sums of pairwise scores. The embeddings are fetched
        once and every term reuses them."""
        spec = self._aggregates[name]
        a, b = self._pairs(a_embedding, a_ids, b_embedding, b_ids)
        total = torch.zeros((), dtype=torch.float32, device=a.scores.device)
        for alg, w in spec.terms:
            total = total + w * sparse.batched(PAIR_ALGORITHMS[alg])(a, b)
        return total
