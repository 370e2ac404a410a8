"""Entity / topic SimClusters embeddings from fav-weighted InterestedIn sums.

Counterpart of ``the_algorithm_tpu/simclusters/entity_embeddings.py``
(``scalding/embedding/EntityToSimClustersEmbeddingsJob.scala``, the topic
variant ``tfg/FavTfgBasedTopicEmbeddings.scala`` and the locale variants):
an entity's embedding is the normalized sum of the fav-weighted InterestedIn
vectors of the users engaging with it, truncated to its top-K clusters
(topKClustersPerEntity = 50).

The join is one ``row_gather`` launch of both InterestedIn tables; the sum
into the dense [entities, C] accumulator is ``segment.scatter_sum`` (one
sort and one run collapse, each slot written once), which raises past 2³¹
slots, where the JAX package's int32 ``e · C + c`` wraps (ROADMAP §3, beside
fault 11a); the top-K is ``retrieval.top_k``. The reverse index's
``.at[].max`` is ``scatter_reduce_`` with ``amax``.
"""

from __future__ import annotations

import torch

from the_algorithm_tpu_torch.ops import segment
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.retrieval import top_k
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding


def _sparse_top(dense: torch.Tensor, k: int) -> SparseEmbedding:
    scores, ids = top_k(dense, k)
    keep = scores > 0
    return SparseEmbedding(torch.where(keep, ids.to(torch.int32), PAD_ID), torch.where(keep, scores, 0.0))


def entity_embeddings_from_engagements(
    entity_ids: torch.Tensor,  # [B] int — the entity each event engaged
    user_ids: torch.Tensor,  # [B] int — the engaging user
    event_weights: torch.Tensor,  # [B] float32 — fav weight (1.0 for favs)
    user_interests: SparseEmbedding,  # [U, K] InterestedIn table
    *,
    num_entities: int,
    num_clusters: int,
    top_k: int = 50,  # topKClustersPerEntity
    l2_normalize: bool = True,
) -> SparseEmbedding:
    """[num_entities, top_k] sparse entity embeddings. Events whose entity
    lies outside [0, num_entities) add nothing."""
    U = user_interests.ids.shape[0]
    rows = jax_rows(user_ids, U).to(torch.int32)
    i_ids, i_scores = row_gather(rows, user_interests.ids.to(torch.int32).contiguous(),
                                 user_interests.scores.to(torch.float32).contiguous())
    valid = i_ids != PAD_ID
    contrib = torch.where(valid, i_scores * event_weights.to(torch.float32)[:, None], 0.0)
    inside = (entity_ids >= 0) & (entity_ids < num_entities)
    flat = torch.where(inside[:, None], entity_ids.to(torch.int64)[:, None] * num_clusters
                       + torch.where(valid, i_ids, 0).to(torch.int64), -1)
    (dense,) = segment.scatter_sum(flat, contrib, size=num_entities * num_clusters)
    dense = dense.view(num_entities, num_clusters)
    if l2_normalize:
        norm = torch.sqrt(torch.sum(dense * dense, dim=1, keepdim=True))
        dense = dense / torch.clamp(norm, min=1e-30)
    return _sparse_top(dense, min(top_k, num_clusters))


# -- locale variants ------------------------------------------------------------
#
# ≡ ``scalding/embedding/Locale*`` (LocaleEntitySimClustersEmbeddingV2Job): one
# embedding per (entity, locale), aggregated only from engagements in that
# language; (entity, locale) composite rows feed the same program.


def locale_entity_embeddings(
    entity_ids: torch.Tensor,  # [B]
    locale_ids: torch.Tensor,  # [B] int the engagement's language
    user_ids: torch.Tensor,  # [B]
    event_weights: torch.Tensor,  # [B]
    user_interests: SparseEmbedding,
    *,
    num_entities: int,
    num_locales: int,
    num_clusters: int,
    top_k: int = 50,
    l2_normalize: bool = True,
) -> SparseEmbedding:
    """[E·L, top_k]: row ``e * num_locales + l`` is entity e in locale l
    (:func:`locale_row` addresses it)."""
    composite = entity_ids * num_locales + locale_ids
    return entity_embeddings_from_engagements(
        composite, user_ids, event_weights, user_interests,
        num_entities=num_entities * num_locales, num_clusters=num_clusters, top_k=top_k,
        l2_normalize=l2_normalize,
    )


def locale_row(entity_id: int, locale_id: int, num_locales: int) -> int:
    return int(entity_id) * int(num_locales) + int(locale_id)


def fav_tfg_topic_embeddings(
    topic_ids: torch.Tensor,  # [B] topic of the faved tweet
    locale_ids: torch.Tensor,  # [B]
    user_ids: torch.Tensor,  # [B] faver
    fav_counts: torch.Tensor,  # [B] fav weight of the event
    user_interests: SparseEmbedding,
    *,
    num_topics: int,
    num_locales: int,
    num_clusters: int,
    top_k: int = 50,
) -> SparseEmbedding:
    """≡ ``tfg/FavTfgBasedTopicEmbeddings.scala``: topic embeddings from fav
    events on topic-tagged tweets, log-fav weighted, per locale."""
    weights = torch.log1p(torch.clamp(fav_counts.to(torch.float32), min=0.0))
    return locale_entity_embeddings(
        topic_ids, locale_ids, user_ids, weights, user_interests,
        num_entities=num_topics, num_locales=num_locales, num_clusters=num_clusters, top_k=top_k,
    )


def reverse_cluster_index(
    embeddings: SparseEmbedding,  # [E, K] entity embeddings
    *,
    num_clusters: int,
    top_m: int,
) -> SparseEmbedding:
    """cluster → top-M entities by embedding score: the serving-side reverse
    index every embedding job also writes."""
    E, K = embeddings.ids.shape
    valid = embeddings.ids != PAD_ID
    flat_c = torch.where(valid, embeddings.ids, 0).to(torch.int64).reshape(-1)
    flat_s = torch.where(valid, embeddings.scores, 0.0).reshape(-1)
    flat_e = torch.arange(E, device=flat_c.device)[:, None].expand(E, K).reshape(-1)
    dense = torch.zeros(num_clusters * E, dtype=torch.float32, device=flat_c.device)
    dense.scatter_reduce_(0, flat_c * E + flat_e, flat_s, reduce="amax", include_self=True)
    return _sparse_top(dense.view(num_clusters, E), min(top_m, E))
