"""SimClusters-ANN "service": config + batched query path + sharded execution.

Counterpart of ``the_algorithm_tpu/simclusters/ann.py``
(``SimClustersANNCandidateSource.scala:35-95``): truncate the source
embedding to maxScanClusters, multiget the cluster rows, score, filter,
top-X. Prod parameters (``simclusters-ann/README.md:7,23-33``): N=50 scan
clusters, M=400 tweets/cluster, X=200 results.

The sharded forms run on every rank of a mesh (``core/mesh.py``) over a
cluster-row-sharded index (:func:`shard_index`: this rank's block of rows):
the index-sharded fan-out (:func:`get_tweet_candidates_sharded`), the
query-sharded one over the row-exchange multiget
(:func:`get_tweet_candidates_query_sharded`) and the query × index hybrid
(:func:`get_tweet_candidates_hybrid`). Each shard's accumulate is the
single-device scan's (one row_gather launch, one run_collapse launch) over
the clusters it owns; the merge re-accumulates the gathered partials by
tweet id through ``retrieval._dedup_sum`` (one more run_collapse launch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from the_algorithm_tpu_torch.core.mesh import MODEL_AXIS, Mesh, shard_rows
from the_algorithm_tpu_torch.core.metrics import span
from the_algorithm_tpu_torch.ops import retrieval, sparse
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex, PerQuery, ScoringAlgorithm, top_k
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding


@dataclasses.dataclass(frozen=True)
class SimClustersANNConfig:
    """≡ thrift ``SimClustersANNConfig`` (simClustersAnn.thrift:18-28)."""

    max_scan_clusters: int = 50  # N
    max_top_tweets_per_cluster: int = 400  # M
    max_num_results: int = 200  # X
    min_score: float = 0.0
    scoring_algorithm: ScoringAlgorithm = ScoringAlgorithm.COSINE
    max_tweet_candidate_age_hours: int = 48
    min_tweet_candidate_age_hours: int = 0


def _query(
    index: ClusterTweetIndex,
    sources: SparseEmbedding,
    config: SimClustersANNConfig,
    now: Optional[PerQuery],
    exclude_tweet_id: Optional[PerQuery],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of the SANN tier, in a ``sann.query`` span."""
    with span("sann.query"):
        src = sparse.truncate(sources, config.max_scan_clusters)
        earliest, latest = _window(config, now)
        return retrieval.approximate_cosine_similarity(
            index,
            src,
            max_results=config.max_num_results,
            algorithm=config.scoring_algorithm,
            min_score=config.min_score,
            max_top_tweets_per_cluster=config.max_top_tweets_per_cluster,
            exclude_tweet_id=exclude_tweet_id,
            earliest_ts=earliest,
            latest_ts=latest,
        )


def get_tweet_candidates(
    index: ClusterTweetIndex,
    source_embedding: SparseEmbedding,  # [N]
    config: SimClustersANNConfig,
    *,
    now: Optional[int] = None,
    exclude_tweet_id: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-query path (``SimClustersANNCandidateSource.get:35-64``) → ([X], [X])."""
    one = SparseEmbedding(source_embedding.ids[None], source_embedding.scores[None])
    ids, scores = _query(index, one, config, now, exclude_tweet_id)
    return ids[0], scores[0]


def get_tweet_candidates_batch(
    index: ClusterTweetIndex,
    sources: SparseEmbedding,  # [Q, N]
    config: SimClustersANNConfig,
    *,
    now: Optional[PerQuery] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched query path → (tweet_ids [Q, X], scores [Q, X]).

    ``now`` (seconds, in the index timestamps' epoch) turns on the age
    window [now - max_age, now - min_age]: one value for all queries, or a
    [Q] tensor.
    """
    return _query(index, sources, config, now, None)


# -- sharded execution -------------------------------------------------------


def shard_index(mesh: Mesh, index: ClusterTweetIndex) -> ClusterTweetIndex:
    """This rank's block of a (global) index, cluster-row-sharded over the
    'model' axis, on the mesh's device. The cluster count must divide."""
    return ClusterTweetIndex(*(shard_rows(t, mesh, pad=False, what="clusters") for t in index))


def fetch_cluster_rows(mesh: Mesh, index: ClusterTweetIndex, cluster_ids: torch.Tensor) -> ClusterTweetIndex:
    """The literal multiget: cluster→top-tweet rows by id, sharded.

    ``index``: this rank's block of a cluster-row-sharded index;
    ``cluster_ids``: this rank's [B/E] block of the requests. The three
    index tables share one routing pass and one row_gather launch on each
    owner (≡ ``clusterTweetCandidatesStore.multiGet``,
    ``SimClustersANNCandidateSource.scala:79``). Returns this rank's rows.
    """
    from the_algorithm_tpu_torch.parallel import sharded_table

    out = sharded_table.multiget_all_to_all(
        mesh, {"tweet_ids": index.tweet_ids, "scores": index.scores, "timestamps": index.timestamps},
        cluster_ids)
    return ClusterTweetIndex(out["tweet_ids"], out["scores"], out["timestamps"])


def _window(config: SimClustersANNConfig, now: Optional[PerQuery]):
    if now is None:
        return None, None
    return (now - config.max_tweet_candidate_age_hours * 3600,
            now - config.min_tweet_candidate_age_hours * 3600)


def _top_results(uniq, dot, norm, src: SparseEmbedding,
                 config: SimClustersANNConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``retrieval.top_results`` under the config's X, algorithm and minimum score."""
    return retrieval.top_results(uniq, dot, norm, src, max_results=config.max_num_results,
                                 algorithm=config.scoring_algorithm, min_score=config.min_score)


def _owned_partials(mesh: Mesh, index: ClusterTweetIndex, src: SparseEmbedding, config: SimClustersANNConfig,
                    now: Optional[int], partials_per_shard: Optional[int]):
    """Each query's raw (tweet id, Σ dot, Σ norm²) partials over the
    clusters this shard owns, cut to the top-R by dot (R =
    ``partials_per_shard`` or N·M, which keeps every partial)."""
    rps = index.num_clusters
    M = min(config.max_top_tweets_per_cluster, index.tweets_per_cluster)
    R = partials_per_shard or config.max_scan_clusters * M
    local_cid = src.ids - mesh.coord(MODEL_AXIS) * rps
    own = (src.ids != PAD_ID) & (local_cid >= 0) & (local_cid < rps)
    earliest, latest = _window(config, now)
    uniq, dot, norm = retrieval.accumulate_candidates(
        index, SparseEmbedding(torch.where(own, local_cid, PAD_ID), torch.where(own, src.scores, 0.0)),
        max_top_tweets_per_cluster=config.max_top_tweets_per_cluster, earliest_ts=earliest, latest_ts=latest)
    if R >= uniq.shape[-1]:  # the exact default: the cut keeps every partial
        return uniq, dot, norm
    _, idx = top_k(torch.where(uniq != PAD_ID, dot, -torch.inf), R)
    return tuple(torch.take_along_dim(x, idx, dim=-1) for x in (uniq, dot, norm))


def _merge(uniq, dot, norm, src: SparseEmbedding, config: SimClustersANNConfig):
    """Re-accumulate the gathered partials by tweet id, then top-X."""
    uniq2, dot2, norm2 = retrieval._dedup_sum(uniq, dot, norm)
    return _top_results(uniq2, dot2, norm2, src, config)


def get_tweet_candidates_sharded(
    mesh: Mesh,
    index: ClusterTweetIndex,  # this rank's cluster-row block
    sources: SparseEmbedding,  # [Q, N], the same on every rank
    config: SimClustersANNConfig,
    *,
    now: Optional[int] = None,
    partials_per_shard: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index-sharded query — the Earlybird-root fan-out.

    Each shard accumulates raw (tweetId, Σ dot, Σ norm²) partials over the
    cluster rows it owns; the partials are gathered over 'model'; the merge
    re-accumulates them by tweet id, so a tweet whose clusters span shards
    scores as on one device; then normalize / filter / top-X. Returns ids
    and scores [Q, X], the same on every rank. Exact at the default
    ``partials_per_shard`` (N·M); a smaller value drops the candidates
    outside some owning shard's top-R partial dots, as the JAX package's.
    Every shard scans every query: the block the hybrid form composes, not
    a serving path (it collapses as the mesh grows).
    """
    src = SparseEmbedding(sources.ids[:, :config.max_scan_clusters], sources.scores[:, :config.max_scan_clusters])
    uniq, dot, norm = _owned_partials(mesh, index, src, config, now, partials_per_shard)  # [Q, R]
    gathered = (mesh.all_gather(x, MODEL_AXIS, dim=1) for x in (uniq, dot, norm))
    return _merge(*gathered, src, config)


def get_tweet_candidates_query_sharded(
    mesh: Mesh,
    index: ClusterTweetIndex,  # this rank's cluster-row block
    sources: SparseEmbedding,  # this rank's [Q/E, N] block of the queries
    config: SimClustersANNConfig,
    *,
    now: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-sharded fan-out: each rank serves its Q/E queries end to end,
    fetching the cluster rows they need from their owners with the
    row-exchange multiget (``sharded_table.route_and_gather``), then
    accumulates, normalizes and takes the top-X locally. Returns this
    rank's [Q/E, X] ids and scores, equal to the batch path's rows."""
    from the_algorithm_tpu_torch.parallel import sharded_table

    rps = index.num_clusters
    N = config.max_scan_clusters
    M = min(config.max_top_tweets_per_cluster, index.tweets_per_cluster)
    # the single-device truncation (cluster order included), so the sums
    # accumulate in the batch path's order
    src = sparse.truncate(sources, N)
    Ql = src.ids.shape[0]
    flat = torch.where(src.valid_mask(), src.ids, 0).reshape(-1)  # [Ql·N]
    tables = [t if M == t.shape[1] else t[:, :M].contiguous() for t in index]
    rows, _ = sharded_table.route_and_gather(tables, flat, rows_per_shard=rps, mesh=mesh)
    earliest, latest = _window(config, now)
    uniq, dot, norm = retrieval.accumulate_from_rows(
        *(r.reshape(Ql, N, M) for r in rows), src, earliest_ts=earliest, latest_ts=latest)
    return _top_results(uniq, dot, norm, src, config)


def get_tweet_candidates_hybrid(
    mesh: Mesh,
    index: ClusterTweetIndex,  # this rank's cluster-row block
    sources: SparseEmbedding,  # this rank's [Q/D, N] block over 'data'
    config: SimClustersANNConfig,
    *,
    now: Optional[int] = None,
    partials_per_shard: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query × index hybrid sharding: queries over 'data', cluster rows
    over 'model'. Each rank scans its query block against its index block
    (compute-at-owner, no row exchange); the partials of a query are
    gathered over 'model' only, in ONE collective (dot and norm bitcast
    into int32 lanes beside the ids), and re-merged by tweet id. Returns
    this rank's [Q/D, X] ids and scores (the same across 'model')."""
    src = SparseEmbedding(sources.ids[:, :config.max_scan_clusters], sources.scores[:, :config.max_scan_clusters])
    uniq, dot, norm = _owned_partials(mesh, index, src, config, now, partials_per_shard)  # [Ql, R]
    packed = torch.stack([uniq, dot.view(torch.int32), norm.view(torch.int32)], dim=-1)
    g = mesh.all_gather(packed, MODEL_AXIS, dim=1)  # [Ql, E·R, 3]
    return _merge(g[..., 0].contiguous(), g[..., 1].contiguous().view(torch.float32),
                  g[..., 2].contiguous().view(torch.float32), src, config)
