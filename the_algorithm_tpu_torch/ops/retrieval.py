"""Approximate-cosine top-K retrieval over a cluster→tweet index.

Counterpart of ``the_algorithm_tpu/ops/retrieval.py``, written batched: every
function takes Q queries at once (``[Q, N]`` source embeddings, ``[Q, ...]``
results), so one call is what ``jax.vmap`` of the JAX single-query function
computes. The scan per query: fetch its N cluster rows (one
:func:`~the_algorithm_tpu_torch.ops.gather.row_gather` launch for the three
index tables) → multiply → dedup by tweet id (stable sort, one
:func:`~the_algorithm_tpu_torch.ops.id_sort.sort_by_id` launch, then
:func:`~the_algorithm_tpu_torch.ops.seg_scan.run_collapse_sorted`) →
normalize → mask → top-X.

Each stage runs in a :func:`~the_algorithm_tpu_torch.core.metrics.span`
(``retrieval.multiget``, ``.scan``, ``.sort``, ``.collapse``, ``.score``,
``.top_k``), so an operator's ``torch.profiler`` trace puts every device
operation of a batch under the stage that launched it.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from the_algorithm_tpu_torch.core.metrics import span
from the_algorithm_tpu_torch.ops import id_sort, sparse
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.seg_scan import run_collapse_sorted
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding

# a per-query value: a Python number for all queries, or a [Q] tensor
PerQuery = Union[int, float, torch.Tensor]


class ScoringAlgorithm(enum.Enum):
    """≡ thrift ``ScoringAlgorithm`` (simclusters-ann/thrift/.../simClustersAnn.thrift)."""

    DOT_PRODUCT = "dot_product"
    COSINE = "cosine"
    LOG_COSINE = "log_cosine"
    COSINE_NO_SOURCE_NORM = "cosine_no_source_norm"


class ClusterTweetIndex(NamedTuple):
    """Top-M tweets per cluster: ``tweet_ids[c]`` score-descending, PAD_ID empty."""

    tweet_ids: torch.Tensor  # [C, M] int32, PAD_ID = empty
    scores: torch.Tensor  # [C, M] float32
    timestamps: torch.Tensor  # [C, M] int32 (0 if unused)

    @property
    def num_clusters(self) -> int:
        return self.tweet_ids.shape[0]

    @property
    def tweets_per_cluster(self) -> int:
        return self.tweet_ids.shape[1]


def sort_by_id(ids: torch.Tensor, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Stable sort of each [Q, W] row by id, carrying the value arrays along:
    one kernel launch on the card where the row fits one CTA
    (:func:`~the_algorithm_tpu_torch.ops.id_sort.sort_by_id`)."""
    with span("retrieval.sort"):
        return id_sort.sort_by_id(ids, *values)


# rows up to this wide sort in one in-place pass each on the card, which beats
# torch.topk there; wider rows are segment-sorted, several times slower than
# the top-K below (chip_smoke.py times both sides at each path's shape)
SMALL_SORT = 4096


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last dim, descending, equal values
    lower index first: the order of ``lax.top_k``, which ``torch.topk`` does
    not promise. ``x`` is float32 without NaN, or int32. Returns (values,
    int64 indices).

    Rows up to :data:`SMALL_SORT` wide: a stable descending sort, cut at k.
    Wider rows: ``torch.topk`` picks the k largest, and every entry above
    the k-th value is among them, so only the entries equal to it may be the
    wrong ones; the pick is put in order (value, then index) and its entries
    equal to the k-th value are replaced by the lowest-index entries of
    ``x`` with that value.
    """
    if x.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"top_k ranks float32 or int32, got {x.dtype}")
    if x.shape[-1] <= SMALL_SORT:
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]
    vals, idx = torch.topk(x, k, dim=-1)
    kth = vals[..., -1:]
    above = (vals > kth).sum(-1, keepdim=True)  # every entry of x above the k-th value is picked
    # the pick in order: one small sort of distinct keys
    order = torch.sort(_order_key(vals, idx, x.shape[-1]), dim=-1, descending=True).indices
    vals, idx = torch.gather(vals, -1, order), torch.gather(idx, -1, order)
    # slot s >= above holds the (s - above + 1)-th entry of x equal to the k-th
    # value; the running count of those entries along each row comes from one
    # scan of the flattened rows (a row-wise cumsum is several times slower
    # on the card) less the count before the row
    eq = x == kth
    flat = torch.cumsum(eq.reshape(-1), dim=0, dtype=torch.int32).view(eq.shape)
    seen = flat - (flat[..., :1] - eq[..., :1].to(torch.int32))
    slot = torch.arange(k, device=x.device, dtype=torch.int32)
    want = torch.clamp(slot - above.to(torch.int32) + 1, min=1)
    ties = torch.searchsorted(seen, want)
    return vals, torch.where(slot >= above, ties, idx)


def _order_key(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """A distinct int64 key per (value, index) that sorts as ``lax.top_k``
    ranks: the value's order-preserving 32-bit image above the reversed
    index."""
    if vals.dtype == torch.float32:
        bits = vals.view(torch.int32)
        image = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # negative floats count down
    else:
        image = vals
    return image.to(torch.int64) * (1 << 32) + (n - 1 - idx)


def _dedup_sum(ids: torch.Tensor, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sort each [Q, W] row by id and collapse equal runs by summation.

    Returns (rep_ids, *summed): one slot per distinct id holds it, every
    other slot holds PAD_ID / 0. Callers must not depend on which slot.
    """
    ordered = sort_by_id(ids, *values)
    with span("retrieval.collapse"):
        return run_collapse_sorted(*ordered)


def _per_query(x: PerQuery, ndim: int) -> PerQuery:
    """A [Q] tensor viewed to broadcast against [Q, ...] of ``ndim`` dims."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape((-1,) + (1,) * (ndim - 1))
    return x


def scan_entries(
    rows_ids: torch.Tensor,  # [Q, N, M] cluster rows already fetched
    rows_scores: torch.Tensor,  # [Q, N, M]
    rows_ts: torch.Tensor,  # [Q, N, M]
    source: SparseEmbedding,  # [Q, N]
    *,
    exclude_tweet_id: Optional[PerQuery] = None,
    earliest_ts: Optional[PerQuery] = None,
    latest_ts: Optional[PerQuery] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's entries before dedup, flat per query: (tweet ids, tweetScore ·
    srcScore, tweetScore²), each [Q, N·M]; filtered entries are PAD_ID / 0."""
    with span("retrieval.scan"):
        valid = (rows_ids != PAD_ID) & source.valid_mask()[..., None]
        if exclude_tweet_id is not None:
            valid &= rows_ids != _per_query(exclude_tweet_id, 3)
        if earliest_ts is not None:
            valid &= rows_ts >= _per_query(earliest_ts, 3)
        if latest_ts is not None:
            valid &= rows_ts <= _per_query(latest_ts, 3)
        contrib = torch.where(valid, rows_scores * source.scores[..., None], 0.0)
        norm_part = torch.where(valid, rows_scores * rows_scores, 0.0)
        flat_ids = torch.where(valid, rows_ids, PAD_ID)
        Q = rows_ids.shape[0]
        return flat_ids.reshape(Q, -1), contrib.reshape(Q, -1), norm_part.reshape(Q, -1)


def accumulate_from_rows(
    rows_ids: torch.Tensor,
    rows_scores: torch.Tensor,
    rows_ts: torch.Tensor,
    source: SparseEmbedding,
    *,
    exclude_tweet_id: Optional[PerQuery] = None,
    earliest_ts: Optional[PerQuery] = None,
    latest_ts: Optional[PerQuery] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The accumulation over rows fetched elsewhere: deduped
    (tweet_ids, Σ tweetScore·srcScore, Σ tweetScore²), each [Q, N·M]."""
    entries = scan_entries(
        rows_ids, rows_scores, rows_ts, source,
        exclude_tweet_id=exclude_tweet_id, earliest_ts=earliest_ts, latest_ts=latest_ts,
    )
    return _dedup_sum(*entries)


def fetch_rows(
    index: ClusterTweetIndex, source: SparseEmbedding, max_top_tweets_per_cluster: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The multiget: the source clusters' index rows, [Q, N, M] each.

    One :func:`row_gather` launch fetches all three tables. With a cap below
    the index's M the whole rows are fetched and then sliced, as in the JAX
    package. A source id outside [0, C) that is not PAD_ID reads the row the
    JAX package's gather reads: a negative id counts from the end (+C), and
    the result is clamped to [0, C-1]; such a slot keeps its score.
    """
    with span("retrieval.multiget"):
        safe_cluster = jax_rows(torch.where(source.valid_mask(), source.ids, 0), index.num_clusters)
        rows = row_gather(safe_cluster, index.tweet_ids, index.scores, index.timestamps)
        M = index.tweets_per_cluster
        if max_top_tweets_per_cluster is not None and max_top_tweets_per_cluster < M:
            rows = tuple(r[..., :max_top_tweets_per_cluster] for r in rows)
        return rows


def accumulate_candidates(
    index: ClusterTweetIndex,
    source: SparseEmbedding,
    *,
    max_top_tweets_per_cluster: Optional[int] = None,
    exclude_tweet_id: Optional[PerQuery] = None,
    earliest_ts: Optional[PerQuery] = None,
    latest_ts: Optional[PerQuery] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The accumulation half of the scan: deduped (tweet_ids, Σ dot, Σ norm²)."""
    rows = fetch_rows(index, source, max_top_tweets_per_cluster)
    return accumulate_from_rows(
        *rows, source,
        exclude_tweet_id=exclude_tweet_id, earliest_ts=earliest_ts, latest_ts=latest_ts,
    )


def normalize_scores(
    sum_contrib: torch.Tensor,  # [Q, W]
    sum_norm: torch.Tensor,  # [Q, W]
    source_l2_norm: torch.Tensor,  # [Q]
    source_log_norm: torch.Tensor,  # [Q]
    algorithm: ScoringAlgorithm,
) -> torch.Tensor:
    """≡ ApproximateCosineSimilarity.scala:105-121 per-algorithm scaling."""
    eps = 1e-30
    l2 = source_l2_norm[..., None]
    log = source_log_norm[..., None]
    if algorithm == ScoringAlgorithm.DOT_PRODUCT:
        return sum_contrib
    if algorithm == ScoringAlgorithm.COSINE:
        return sum_contrib / torch.clamp(l2 * torch.sqrt(sum_norm), min=eps)
    if algorithm == ScoringAlgorithm.LOG_COSINE:
        return sum_contrib / torch.clamp(log * torch.log1p(sum_norm), min=eps)
    if algorithm == ScoringAlgorithm.COSINE_NO_SOURCE_NORM:
        return sum_contrib / torch.clamp(torch.sqrt(sum_norm), min=eps)
    raise ValueError(f"unknown algorithm {algorithm}")


def top_results(
    uniq_ids: torch.Tensor,  # [Q, W] deduped tweet ids, PAD_ID empty
    sum_contrib: torch.Tensor,  # [Q, W]
    sum_norm: torch.Tensor,  # [Q, W]
    source: SparseEmbedding,  # [Q, N]
    *,
    max_results: int,
    algorithm: ScoringAlgorithm,
    min_score: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize, filter and take the top-X of accumulated candidates: ids
    [Q, X] (PAD_ID where none) and scores [Q, X] (-inf where none), X wide
    even when the scan has fewer slots."""
    with span("retrieval.score"):
        score = normalize_scores(
            sum_contrib, sum_norm, sparse.l2_norm(source), sparse.log_norm(source), algorithm
        )
        score = torch.where((uniq_ids != PAD_ID) & (score >= min_score), score, -torch.inf)
    with span("retrieval.top_k"):
        k = min(max_results, score.shape[-1])
        top_scores, top_idx = top_k(score, k)
        top_ids = torch.where(
            torch.isfinite(top_scores), torch.take_along_dim(uniq_ids, top_idx, dim=-1), PAD_ID
        )
        if k < max_results:  # keep the static output width the caller asked for
            pad = (top_ids.shape[0], max_results - k)
            top_ids = torch.cat([top_ids, top_ids.new_full(pad, PAD_ID)], dim=-1)
            top_scores = torch.cat([top_scores, top_scores.new_full(pad, -torch.inf)], dim=-1)
        return top_ids, top_scores


def approximate_cosine_similarity(
    index: ClusterTweetIndex,
    source: SparseEmbedding,
    *,
    max_results: int,
    algorithm: ScoringAlgorithm = ScoringAlgorithm.COSINE,
    min_score: float = 0.0,
    max_top_tweets_per_cluster: Optional[int] = None,
    exclude_tweet_id: Optional[PerQuery] = None,
    earliest_ts: Optional[PerQuery] = None,
    latest_ts: Optional[PerQuery] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched retrieval: [Q, N] sources → (tweet_ids [Q, X], scores [Q, X]).

    The counterpart of both ``approximate_cosine_similarity`` and its
    ``_batch`` form in the JAX package. Empty result slots have id PAD_ID and
    score -inf; the output keeps the requested width X even when the scan
    has fewer slots.
    """
    accumulated = accumulate_candidates(
        index, source,
        max_top_tweets_per_cluster=max_top_tweets_per_cluster,
        exclude_tweet_id=exclude_tweet_id, earliest_ts=earliest_ts, latest_ts=latest_ts,
    )
    return top_results(*accumulated, source, max_results=max_results, algorithm=algorithm, min_score=min_score)


def approximate_cosine_similarity_batch(
    index: ClusterTweetIndex, sources: SparseEmbedding, **kwargs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's name for the batched call, ``jax.vmap`` of its
    single-query form over [Q, N] sources: here the same call as
    :func:`approximate_cosine_similarity`, which takes Q queries already."""
    return approximate_cosine_similarity(index, sources, **kwargs)


# -- numpy reference (golden-parity oracle) ----------------------------------


def approximate_cosine_similarity_reference(
    index_ids: np.ndarray,
    index_scores: np.ndarray,
    index_ts: np.ndarray,
    src_ids: np.ndarray,
    src_scores: np.ndarray,
    *,
    max_results: int,
    algorithm: ScoringAlgorithm = ScoringAlgorithm.COSINE,
    min_score: float = 0.0,
    earliest_ts: Optional[int] = None,
    latest_ts: Optional[int] = None,
):
    """Literal hashmap transcription of the JVM loop (test oracle only).

    A copy of the JAX package's oracle, so that a machine without JAX can
    hold the port against it; a test asserts that both give the same lists.
    """
    scores_map: dict = {}
    norm_map: dict = {}
    for cid, cscore in zip(src_ids, src_scores):
        if cid == PAD_ID or cid < 0 or cid >= index_ids.shape[0]:
            continue
        for tid, tscore, ts in zip(index_ids[cid], index_scores[cid], index_ts[cid]):
            if tid == PAD_ID:
                continue
            if earliest_ts is not None and ts < earliest_ts:
                continue
            if latest_ts is not None and ts > latest_ts:
                continue
            scores_map[tid] = scores_map.get(tid, 0.0) + float(tscore) * float(cscore)
            norm_map[tid] = norm_map.get(tid, 0.0) + float(tscore) ** 2
    src_l2 = float(np.sqrt(np.sum(np.asarray(src_scores, np.float64) ** 2)))
    src_log = float(np.log1p(np.sum(np.asarray(src_scores, np.float64) ** 2)))
    out = []
    for tid, s in scores_map.items():
        if algorithm == ScoringAlgorithm.DOT_PRODUCT:
            v = s
        elif algorithm == ScoringAlgorithm.COSINE:
            v = s / src_l2 / np.sqrt(norm_map[tid])
        elif algorithm == ScoringAlgorithm.LOG_COSINE:
            v = s / src_log / np.log1p(norm_map[tid])
        else:
            v = s / np.sqrt(norm_map[tid])
        if v >= min_score:
            out.append((tid, v))
    out.sort(key=lambda kv: -kv[1])
    return out[:max_results]


# -- exact full-corpus scan ---------------------------------------------------


def exact_cosine_scan(
    corpus_ids: torch.Tensor,  # [T, K] cluster ids per tweet (PAD padded)
    corpus_scores: torch.Tensor,  # [T, K]
    sources: SparseEmbedding,  # [Q, N] sparse query embeddings
    *,
    num_clusters: int,
    max_results: int,
    block: int = 65536,
    compute_dtype: torch.dtype = torch.float32,
    approx_block_topk: bool = False,
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact full-corpus cosine top-K → (corpus rows [Q, X], scores [Q, X]).

    Densify each query over the clusters once, then score the corpus
    ``block`` rows at a time (a gather of the transposed query table and a
    K-sum) and fold each block's top-X into a running top-X. T must be a
    multiple of ``block``. Rows whose score is not finite come back as -1.

    Cluster ids outside [0, C) that are not PAD_ID follow the JAX package:
    the densifying scatter wraps a negative source id by +C and drops one
    still outside [0, C); the corpus gather reads :func:`jax_rows`' row.

    ``compute_dtype=torch.bfloat16`` rounds the transposed query table and
    the corpus scores to bf16, as the JAX package does; the inverse norms
    come from the unrounded f32 scores. The gather moves bf16, and the
    K-sum runs in f32 (JAX: ``preferred_element_type=f32``): bf16 products
    are exact in f32, so only the summation order differs from JAX.

    ``approx_block_topk`` stands for the JAX package's ``lax.approx_max_k``
    per block, which torch lacks; JAX on the CPU returns ``top_k``'s indices
    for it, and the port ranks every block exactly (:func:`top_k`, tie order
    kept). ``recall_target`` is accepted for the same signature and unused.
    """
    del approx_block_topk, recall_target  # every block is ranked exactly
    Q = sources.ids.shape[0]
    T, K = corpus_ids.shape
    if T % block != 0:
        raise ValueError(f"corpus length {T} not a multiple of {block}")
    X = min(max_results, block)
    dev = corpus_ids.device
    C = num_clusters
    src = torch.where(sources.ids < 0, sources.ids + C, sources.ids)
    keep = (sources.ids != PAD_ID) & (src >= 0) & (src < C)
    q_dense = torch.zeros((Q, C), dtype=torch.float32, device=dev)
    q_dense.scatter_add_(1, torch.where(keep, src, 0).long(), torch.where(keep, sources.scores, 0.0))
    q_norm = torch.sqrt(torch.sum(q_dense * q_dense, dim=1, keepdim=True))
    q_dense_t = (q_dense / torch.clamp(q_norm, min=1e-9)).T.to(compute_dtype).contiguous()  # [C, Q]

    valid_t = corpus_ids != PAD_ID
    safe_ids = jax_rows(torch.where(valid_t, corpus_ids, 0), C)
    t_scores = torch.where(valid_t, corpus_scores, 0.0)
    inv_norm = 1.0 / torch.clamp(torch.sqrt(torch.sum(t_scores * t_scores, dim=1)), min=1e-9)
    # bf16: the rounded scores, carried back to f32 for the K-sum
    t_scores = t_scores.to(compute_dtype).float()
    live_row = valid_t.any(dim=1)

    top_scores = torch.full((Q, X), -torch.inf, dtype=torch.float32, device=dev)
    top_rows = torch.full((Q, X), -1, dtype=torch.int32, device=dev)
    for start in range(0, T, block):
        sl = slice(start, start + block)
        qw = q_dense_t.index_select(0, safe_ids[sl].reshape(-1)).reshape(block, K, Q)
        # an f32 product: bmm of bf16 inputs would round every score to bf16
        s = torch.bmm(t_scores[sl].unsqueeze(1), qw.float()).squeeze(1).T  # [Q, block]
        s = s * inv_norm[sl][None, :]
        s = torch.where(live_row[sl][None, :], s, -torch.inf)
        bs, bi = top_k(s, X)
        br = (bi + start).to(torch.int32)
        ks, ki = top_k(torch.cat([top_scores, bs], dim=1), X)
        top_rows = torch.take_along_dim(torch.cat([top_rows, br], dim=1), ki, dim=1)
        top_scores = ks
    if X < max_results:
        pad = (Q, max_results - X)
        top_scores = torch.cat([top_scores, top_scores.new_full(pad, -torch.inf)], dim=1)
        top_rows = torch.cat([top_rows, top_rows.new_full(pad, -1)], dim=1)
    top_rows = torch.where(torch.isfinite(top_scores), top_rows, -1)
    return top_rows, top_scores
