"""Topic Social Proof (TSPS): tweet → topic assignment with relevance.

Counterpart of ``the_algorithm_tpu/mixers/topic_social_proof.py``
(``topic-social-proof/``): the cosine relevance between a tweet's
SimClusters embedding and each topic's, filtered by the user's
not-interested list (and, in the batch form, per-topic allow-lists and
quality floors) at a relevance threshold, top-M in ``lax.top_k``'s order.

JAX's double ``vmap`` of ``sparse.cosine`` builds a [B, T, K, K] match
tensor; the batch form here computes the same cosines ``TSPS_CHUNK_BYTES``
of match tensor at a time (rows of B are independent, so the answer does
not depend on the chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from the_algorithm_tpu_torch.ops import sparse
from the_algorithm_tpu_torch.ops.retrieval import top_k
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding

TSPS_CHUNK_BYTES = 1 << 29  # the match tensor one chunk of tweets may build


@dataclasses.dataclass(frozen=True)
class TopicSocialProofConfig:
    min_relevance: float = 0.05  # cosine threshold for assignment
    max_topics_per_tweet: int = 3


def _cosines(tweets: SparseEmbedding, topics: SparseEmbedding) -> torch.Tensor:
    """[B, K] tweets against [T, K] topics → [B, T] cosines, in chunks of B."""
    B, K = tweets.ids.shape
    T, Kt = topics.ids.shape
    step = max(1, TSPS_CHUNK_BYTES // max(1, T * K * Kt * 4))
    return torch.cat([
        sparse.pairwise_matrix(sparse.cosine, SparseEmbedding(tweets.ids[i:i + step], tweets.scores[i:i + step]),
                               topics)
        for i in range(0, B, step)
    ]) if B else torch.zeros((0, T), dtype=torch.float32, device=tweets.ids.device)


def _ranked(scores: torch.Tensor, ok: torch.Tensor, followed_topics: Optional[torch.Tensor],
            config: TopicSocialProofConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T] scores and their gate → (topic_ids, relevance, followed), [B, M]."""
    masked = torch.where(ok, scores, -torch.inf)
    k = min(config.max_topics_per_tweet, scores.shape[-1])
    top_scores, idx = top_k(masked, k)
    found = torch.isfinite(top_scores)
    out_ids = torch.where(found, idx.to(torch.int32), PAD_ID)
    out_scores = torch.where(found, top_scores, 0.0)
    if followed_topics is not None:
        followed = (out_ids[..., None] == followed_topics).any(-1) & (out_ids != PAD_ID)
    else:
        followed = torch.zeros(out_ids.shape, dtype=torch.bool, device=out_ids.device)
    return out_ids, out_scores, followed


def _banned(n_topics: int, not_interested_topics: torch.Tensor) -> torch.Tensor:
    topic_ids = torch.arange(n_topics, dtype=torch.int32, device=not_interested_topics.device)
    return (topic_ids[:, None] == not_interested_topics[None, :]).any(1)


def topic_social_proof(
    tweet_embedding: SparseEmbedding,  # [K]
    topic_embeddings: SparseEmbedding,  # [T, K] batched topic table
    *,
    followed_topics: Optional[torch.Tensor] = None,  # [F] topic ids (PAD pad)
    not_interested_topics: Optional[torch.Tensor] = None,
    config: TopicSocialProofConfig = TopicSocialProofConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (topic_ids [M], relevance [M], followed_mask [M]).

    Topics below min_relevance or in the user's not-interested list drop;
    ``followed_mask`` marks topics the user follows.
    """
    scores = _cosines(SparseEmbedding(tweet_embedding.ids[None], tweet_embedding.scores[None]), topic_embeddings)
    ok = scores >= config.min_relevance
    if not_interested_topics is not None:
        ok &= ~_banned(scores.shape[1], not_interested_topics)[None, :]
    ids, rel, followed = _ranked(scores, ok, followed_topics, config)
    return ids[0], rel[0], followed[0]


def topic_social_proof_batch(
    tweet_embeddings: SparseEmbedding,  # [B, K] batched tweets
    topic_embeddings: SparseEmbedding,  # [T, K]
    *,
    followed_topics: Optional[torch.Tensor] = None,
    not_interested_topics: Optional[torch.Tensor] = None,
    topic_allowed: Optional[torch.Tensor] = None,  # [T] bool (language/locale)
    quality_scores: Optional[torch.Tensor] = None,  # [T] per-topic skit quality
    min_quality: float = 0.0,
    config: TopicSocialProofConfig = TopicSocialProofConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The service endpoint shape: a tweet batch against the topic table
    (per-language allow-lists and skit-quality gating).

    → (topic_ids [B, M], relevance [B, M], followed_mask [B, M]).
    """
    scores = _cosines(tweet_embeddings, topic_embeddings)  # [B, T]
    ok = scores >= config.min_relevance
    if topic_allowed is not None:
        ok &= topic_allowed[None, :]
    if quality_scores is not None:
        ok &= (quality_scores >= min_quality)[None, :]
    if not_interested_topics is not None:
        ok &= ~_banned(scores.shape[1], not_interested_topics)[None, :]
    return _ranked(scores, ok, followed_topics, config)
