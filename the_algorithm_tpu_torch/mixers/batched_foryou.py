"""Batched For You serving: R concurrent requests share each device pass.

Counterpart of ``the_algorithm_tpu/mixers/batched_foryou.py``. The engine
phase-batches the whole product:

  Phase A (device): batched retrieval — SANN rows, the earlybird in-network
           scan, the UTEG traversal, each ONE batch for all R requests.
  Phase B (host):   columnar merge → dedup → filters (numpy; no
           per-candidate Python objects).
  Phase C (device): wide hydration + MaskNet for all R requests in one pass
           (:class:`~the_algorithm_tpu_torch.mixers.device_hydration.DeviceHydrationScorer`).
  Phase D (device or host): weighted heads → author-diversity rescore →
           top-K (on the device with ``select_top_k``, else vectorized numpy).

The step order and semantics mirror ``RecommendationPipeline.run``: dedup is
first-wins in pipeline order, global filters run between hydration and
scoring, author diversity decays repeat authors multiplicatively.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.decider import Decider
from the_algorithm_tpu_torch.graph import uteg
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.mixers.home_products import EXACT_RETRIEVAL_TIER
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.pipeline.component import Candidate
from the_algorithm_tpu_torch.search import earlybird as eb


class CandidateColumns:
    """Columnar per-request candidate set (the object-model bypass).

    ``cols`` maps feature name → [B] numpy array; ``ids`` is the id column.
    """

    __slots__ = ("ids", "scores", "cols")

    def __init__(self, ids: np.ndarray, scores: np.ndarray, cols: Optional[Dict[str, np.ndarray]] = None):
        self.ids = np.asarray(ids, np.int64)
        self.scores = np.asarray(scores, np.float32)
        self.cols = cols or {}

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    @staticmethod
    def concat(parts: Sequence["CandidateColumns"]) -> "CandidateColumns":
        parts = [p for p in parts if len(p)]
        if not parts:
            return CandidateColumns(np.empty(0, np.int64), np.empty(0, np.float32))
        names = set()
        for p in parts:
            names.update(p.cols)
        cols = {}
        for n in names:
            # a missing column fills as HostRequestBuilder.build does: 0.0
            # for numeric flag/count features (is_in_network, social_proof,
            # …), the -1 "absent" sentinel only for id-like columns
            fill = -1 if (n.endswith("_id") or n == "id") else 0.0
            cols[n] = np.concatenate([
                np.asarray(p.cols[n]) if n in p.cols else np.full(len(p), fill) for p in parts])
        return CandidateColumns(np.concatenate([p.ids for p in parts]),
                                np.concatenate([p.scores for p in parts]), cols)

    def take(self, idx: np.ndarray) -> "CandidateColumns":
        return CandidateColumns(self.ids[idx], self.scores[idx], {n: np.asarray(v)[idx] for n, v in self.cols.items()})


def dedup_first_wins(c: CandidateColumns) -> CandidateColumns:
    """Keep the first occurrence of each id (pipeline-order precedence —
    the PickFirstCandidateMerger / DedupSelector semantics)."""
    _, first = np.unique(c.ids, return_index=True)
    return c.take(np.sort(first))


class BatchCandidateSource:
    """Retrieves for R queries in one call → one CandidateColumns each.

    Sources with a device pass split into ``dispatch`` (enqueue on the
    device, no wait) and ``collect`` (the host fetch), so the engine can
    enqueue ALL legs before fetching any.
    """

    name = "BatchCandidateSource"

    def get_batch(self, queries: Sequence, params) -> List[CandidateColumns]:
        return self.collect(self.dispatch(queries, params))

    def dispatch(self, queries: Sequence, params):
        return queries

    def collect(self, handle) -> List[CandidateColumns]:
        raise NotImplementedError


@dataclasses.dataclass
class ColumnsLift:
    """Vectorized candidate metadata attachment — the tweetypie-hydration
    role of the bench's per-candidate ``lift`` closure, as columns."""

    num_authors: int
    now: int

    def __call__(self, c: CandidateColumns) -> CandidateColumns:
        ids = c.ids
        c.cols.setdefault("author_id", ids % self.num_authors)
        c.cols.setdefault("created_ts", self.now - (ids % (40 * 3600)))
        c.cols.setdefault("topic_id", ids % 16)
        c.cols.setdefault("language_id", ids % 8)
        c.cols.setdefault("media_type", ids % 4)
        c.cols.setdefault("conversation_id", ids // 2)
        c.cols.setdefault("retrieval_score", c.scores)
        return c


class BatchedForYouEngine:
    """The For You product, phase-batched over R requests."""

    def __init__(
        self,
        *,
        batch_sources: Sequence[BatchCandidateSource],
        scorer: dh.DeviceHydrationScorer,
        head_names: Sequence[str],
        lift: Optional[Callable[[CandidateColumns], CandidateColumns]] = None,
        max_age_s: int = 48 * 3600,
        diversity_decay: float = 0.5,
        diversity_floor: float = 0.25,
        source_names: Optional[Sequence[str]] = None,
    ):
        self.batch_sources = list(batch_sources)
        self.scorer = scorer
        self.head_names = list(head_names)
        self.lift = lift
        self.max_age_s = max_age_s
        self.diversity_decay = diversity_decay
        self.diversity_floor = diversity_floor
        names = tuple(source_names) if source_names is not None else tuple(fs.candidate_source_names())
        self.source_index = {n: i for i, n in enumerate(names)}

    # -- phases ---------------------------------------------------------------

    def _retrieve(self, queries, params) -> List[CandidateColumns]:
        per_query: List[List[CandidateColumns]] = [[] for _ in queries]
        # enqueue every leg's device work before fetching any result
        handles = []
        for src in self.batch_sources:
            if type(src).dispatch is not BatchCandidateSource.dispatch:
                handles.append(("dc", src.dispatch(queries, params)))
            else:
                handles.append(("gb", None))
        for src, (mode, handle) in zip(self.batch_sources, handles):
            got = src.collect(handle) if mode == "dc" else src.get_batch(queries, params)
            sidx = self.source_index.get(src.name, -1)
            shash = dh.source_hash(src.name)
            for qi, c in enumerate(got):
                c.cols["source_idx"] = np.full(len(c), sidx, np.int32)
                c.cols["source_hash"] = np.full(len(c), shash, np.int64)
                if src.name in ("EarlybirdInNetwork", "FollowingEarlybird"):
                    c.cols["is_in_network"] = np.ones(len(c), np.float32)
                per_query[qi].append(c)
        return [dedup_first_wins(CandidateColumns.concat(parts)) for parts in per_query]

    def _filter(self, query, c: CandidateColumns) -> CandidateColumns:
        keep = np.ones(len(c), bool)
        seen = getattr(query, "seen_tweet_ids", None)
        if seen:
            keep &= ~np.isin(c.ids, np.fromiter(seen, np.int64, count=len(seen)))
        ts = c.cols.get("created_ts")
        if ts is not None:
            keep &= (int(getattr(query, "now", 0)) - ts) <= self.max_age_s
        return c.take(np.nonzero(keep)[0])

    def _rescore_select(self, query, c: CandidateColumns, combined: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(order, final_scores): author-diversity decay + sort + truncate."""
        order = np.argsort(-combined, kind="stable")
        authors = np.asarray(c.cols.get("author_id", np.full(len(c), -1)), np.int64)[order]
        # occurrence index of each author within the ranked list
        sort_by_author = np.argsort(authors, kind="stable")
        sorted_a = authors[sort_by_author]
        new_grp = np.concatenate([[True], sorted_a[1:] != sorted_a[:-1]])
        grp_start = np.maximum.accumulate(np.where(new_grp, np.arange(len(sorted_a)), 0))
        occ_sorted = np.arange(len(sorted_a)) - grp_start
        occ = np.empty(len(sorted_a), np.int64)
        occ[sort_by_author] = occ_sorted
        factor = np.maximum(self.diversity_decay ** occ, self.diversity_floor)
        factor = np.where(authors >= 0, factor, 1.0)
        rescored = combined[order] * factor
        final = np.argsort(-rescored, kind="stable")
        k = int(getattr(query, "max_results", 50))
        return order[final[:k]], rescored[final[:k]]

    def columns(self, queries: Sequence, params=None):
        """Phases A and B: (merged candidates, the scorer's columnar batch
        [(query, cols, n), ...]) for R queries."""
        merged = self._retrieve(queries, params)
        if self.lift is not None:
            merged = [self.lift(c) for c in merged]
        merged = [self._filter(q, c) for q, c in zip(queries, merged)]
        score_batch = []
        for q, c in zip(queries, merged):
            cols = dict(c.cols)
            cols["ids"] = c.ids
            score_batch.append((q, cols, len(c)))
        return merged, score_batch

    # -- the batched serve ----------------------------------------------------

    def serve_batch(self, queries: Sequence, params=None) -> List[List[Candidate]]:
        """R queries → R ranked candidate lists. Returns object-model
        Candidates only for the final top-K.

        The batch pads to the next power of two (duplicating the last
        query), as the JAX package's does, so a serving front's ragged batch
        sizes run at a handful of shapes."""
        n = len(queries)
        padded_n = max(1, 1 << (n - 1).bit_length())
        if padded_n > n:
            queries = list(queries) + [queries[-1]] * (padded_n - n)
        return self._serve_batch(queries, params)[:n]

    def _serve_batch(self, queries: Sequence, params=None):
        merged, score_batch = self.columns(queries, params)
        if getattr(self.scorer, "select_top_k", None) is not None:
            # device-side selection: only K rows per request come back
            return [self._selected(q, c, sel) for q, c, sel in
                    zip(queries, merged, self.scorer.select_columnar(score_batch))]
        out: List[List[Candidate]] = []
        for q, c, (probs, combined) in zip(queries, merged, self.scorer.score_columnar(score_batch)):
            B = min(len(c), probs.shape[0])
            order, scores = self._rescore_select(q, c.take(np.arange(B)), combined[:B])
            cands = []
            for i, s in zip(order, scores):
                feats = {n: v[i].item() for n, v in c.cols.items() if n not in ("source_idx", "source_hash")}
                for j, h in enumerate(self.head_names):
                    feats[f"predicted_{h}"] = float(probs[i, j])
                cands.append(Candidate(id=int(c.ids[i]), score=float(s), features=feats))
            out.append(cands)
        return out

    def _selected(self, q, c: CandidateColumns, selected) -> List[Candidate]:
        """One request's device-selected (ids, scores, probs) as Candidates,
        each with its merged columns (matched by id) and head scores."""
        ids, scores, probs = selected
        k = int(getattr(q, "max_results", self.scorer.select_top_k))
        ids_k = np.asarray(ids[:k], np.int64)
        scores_k = np.asarray(scores[:k], np.float64).tolist()
        probs_k = np.asarray(probs[:k], np.float64)
        # vectorized id→row match: sort the merged ids once, searchsorted the K selected
        order = np.argsort(c.ids, kind="stable")
        sids = c.ids[order]
        if len(sids):
            pos_c = np.minimum(np.searchsorted(sids, ids_k), len(sids) - 1)
            jrow = np.where(sids[pos_c] == ids_k, order[pos_c], -1)
        else:
            jrow = np.full(len(ids_k), -1)
        safe = np.maximum(jrow, 0)
        col_vals = {n: np.asarray(v)[safe].tolist() for n, v in c.cols.items()
                    if n not in ("source_idx", "source_hash")}
        head_vals = {f"predicted_{h}": probs_k[:, hi].tolist() for hi, h in enumerate(self.head_names)}
        cands = []
        for r, (i, s) in enumerate(zip(ids_k.tolist(), scores_k)):
            feats = {n: vals[r] for n, vals in col_vals.items()} if jrow[r] >= 0 else {}
            for hn, vals in head_vals.items():
                feats[hn] = vals[r]
            cands.append(Candidate(id=i, score=s, features=feats))
        return cands


# -- batched retrieval legs ----------------------------------------------------


class PrecomputedBatchSource(BatchCandidateSource):
    """SANN rows already retrieved by the batched prod-shape scan (the bench
    measures that scan separately and shares its output)."""

    def __init__(self, ids: np.ndarray, scores: np.ndarray, name: str = "simclusters_interested_in"):
        self._ids = np.asarray(ids)
        self._scores = np.asarray(scores)
        self.name = name

    def collect(self, queries):
        out = []
        for q in queries:
            u = int(q.user_id) % self._ids.shape[0]
            ids = self._ids[u]
            ok = ids != PAD_ID
            out.append(CandidateColumns(ids[ok], self._scores[u][ok]))
        return out


class EarlybirdBatchSource(BatchCandidateSource):
    """In-network earlybird scan for R users in one batch on the index's
    device (``earlybird.search_in_network_batch``: corpus scoring once,
    per-user follow mask and top-K)."""

    name = "EarlybirdInNetwork"

    def __init__(self, index: eb.EarlybirdIndex, now: int, max_results: int = 700, follow_width: int = 64):
        self._index = index
        self._k = max_results
        self._fw = follow_width
        # the in-network leg IS the from:follows operator query; the batch
        # resolves the follow set per request row
        op_kw = eb.parse_query("from:follows")
        if op_kw.pop("from_follows") is not True:
            raise ValueError("from:follows did not parse to the follow filter")
        self._query = eb.SearchQuery(require_all=True, min_ts=0, max_ts=now, **op_kw).to(index.author.device)

    def dispatch(self, queries, params):
        follows = np.full((len(queries), self._fw), PAD_ID, np.int32)
        for i, q in enumerate(queries):
            fl = sorted(int(a) for a in getattr(q, "followed_authors", ()))[: self._fw]
            follows[i, :len(fl)] = fl
        ids, scores = eb.search_in_network_batch(
            self._index, self._query, torch.from_numpy(follows).to(self._index.author.device), max_results=self._k)
        return torch.stack([ids, scores.view(torch.int32)], dim=-1)  # one fetch

    def collect(self, handle):
        packed = handle.cpu().numpy()
        ids = packed[..., 0]
        scores = packed[..., 1].view(np.float32)
        out = []
        for i in range(ids.shape[0]):
            ok = ids[i] != PAD_ID
            out.append(CandidateColumns(ids[i][ok], scores[i][ok]))
        return out


class UtegBatchSource(BatchCandidateSource):
    """UTEG engagement traversal for R users in one batch on the graph's
    device (``uteg.recommend``: one row_gather and one run_collapse launch)."""

    name = "DirectUteg"

    def __init__(self, graph: uteg.EngagementGraph, seeds_fn: Callable[[int], np.ndarray],
                 max_results: int = 400, n_seeds: int = 8):
        self._graph = graph
        self._seeds_fn = seeds_fn
        self._k = max_results
        self._n_seeds = n_seeds

    def dispatch(self, queries, params):
        seeds = np.stack([np.asarray(self._seeds_fn(int(q.user_id)))[: self._n_seeds]
                          for q in queries]).astype(np.int32)
        dev = self._graph.tweet_ids.device
        seeds_t = torch.from_numpy(seeds).to(dev)
        ids, scores, proof = uteg.recommend(self._graph, seeds_t, torch.ones(seeds_t.shape, device=dev),
                                            max_results=self._k, min_social_proof=1)
        return torch.stack([ids, scores.view(torch.int32), proof.to(torch.int32)], dim=-1)  # one fetch

    def collect(self, handle):
        packed = handle.cpu().numpy()
        ids = packed[..., 0]
        scores = packed[..., 1].view(np.float32)
        proof = packed[..., 2]
        out = []
        for i in range(ids.shape[0]):
            ok = ids[i] != PAD_ID
            c = CandidateColumns(ids[i][ok], scores[i][ok])
            c.cols["social_proof"] = proof[i][ok].astype(np.float32)
            out.append(c)
        return out


class ExactScanBatchSource(BatchCandidateSource):
    """Full-corpus exact cosine retrieval as a product source
    (:func:`~the_algorithm_tpu_torch.ops.retrieval.exact_cosine_scan`), on
    the corpus tensors' device.

    ``turbo`` is the at-scale tier's operating point: the bf16 gather and
    the JAX package's approximate per-block collectors (ranked exactly
    here; its recall is measured against the f32 scan, not assumed).
    """

    name = "simclusters_interested_in"  # serves the same SANN slot

    def __init__(self, corpus_ids: torch.Tensor, corpus_scores: torch.Tensor,
                 embedding_fn: Callable[[int], Tuple[np.ndarray, np.ndarray]], num_clusters: int,
                 max_results: int = 200, row_to_id: Optional[np.ndarray] = None, block: int = 65536,
                 turbo: bool = False, recall_target: float = 0.99):
        self._ids = corpus_ids
        self._scores = corpus_scores
        self._emb = embedding_fn  # user_id -> (cl [N], sc [N]) numpy arrays
        self._row_to_id = row_to_id
        self._device = corpus_ids.device
        self._scan_kw = dict(num_clusters=num_clusters, max_results=max_results, block=block,
                             compute_dtype=torch.bfloat16 if turbo else torch.float32,
                             approx_block_topk=turbo, recall_target=recall_target)

    def dispatch(self, queries, params):
        n = len(queries)
        cls, scs = zip(*(self._emb(int(q.user_id)) for q in queries))
        cls, scs = np.stack(cls), np.stack(scs)
        # pad the query batch to a power of two with copies of the first
        # query: a serving front's ragged tier counts then give a handful of
        # scan shapes (the scan's cost barely depends on Q)
        padded = max(1, 1 << (n - 1).bit_length())
        if padded > n:
            cls = np.concatenate([cls, np.repeat(cls[:1], padded - n, 0)])
            scs = np.concatenate([scs, np.repeat(scs[:1], padded - n, 0)])
        src = SparseEmbedding(torch.from_numpy(np.asarray(cls, np.int32)).to(self._device),
                              torch.from_numpy(np.asarray(scs, np.float32)).to(self._device))
        rows, scores = retrieval.exact_cosine_scan(self._ids, self._scores, src, **self._scan_kw)
        return torch.stack([rows, scores.view(torch.int32)], dim=-1), n  # one fetch

    def collect(self, handle):
        packed, n = handle
        packed = packed.cpu().numpy()[:n]
        rows = packed[..., 0]
        scores = packed[..., 1].view(np.float32)
        out = []
        for i in range(rows.shape[0]):
            ids = rows[i]
            if self._row_to_id is not None:
                ids = self._row_to_id[ids]
            ok = scores[i] > -np.inf
            out.append(CandidateColumns(ids[ok], scores[i][ok]))
        return out


class TieredSannBatchSource(BatchCandidateSource):
    """Quality-tier routing for the SANN leg ≡ the configapi experiment
    bucketing pattern: requests whose user falls in the sticky decider
    bucket (``exact_retrieval_tier`` availability dial) retrieve through the
    EXACT full-corpus scan; the rest use the approximate cluster-index rows.
    Per-request override: the ``exact_retrieval_tier`` Param of the
    request's ``params`` (ambient ``param_scope`` layers included).
    """

    name = "simclusters_interested_in"
    FEATURE = "exact_retrieval_tier"

    def __init__(self, approx: BatchCandidateSource, exact: ExactScanBatchSource, decider: Decider):
        self._approx = approx
        self._exact = exact
        self._decider = decider

    def _in_tier(self, q, params) -> bool:
        if params is not None:
            forced = params(EXACT_RETRIEVAL_TIER)
            if forced is not None:
                return bool(forced)
        return self._decider.is_available_for_id(self.FEATURE, int(q.user_id))

    def dispatch(self, queries, params):
        tiers = [self._in_tier(q, params) for q in queries]
        exact_q = [q for q, t in zip(queries, tiers) if t]
        approx_q = [q for q, t in zip(queries, tiers) if not t]
        h_exact = self._exact.dispatch(exact_q, params) if exact_q else None
        return tiers, h_exact, approx_q

    def collect(self, handle):
        tiers, h_exact, approx_q = handle
        exact_cols = self._exact.collect(h_exact) if h_exact is not None else []
        approx_cols = self._approx.get_batch(approx_q, None) if approx_q else []
        out, ei, ai = [], 0, 0
        for t in tiers:  # stream order restored
            if t:
                c = exact_cols[ei]
                c.cols["exact_tier"] = np.ones(len(c), np.float32)
                out.append(c)
                ei += 1
            else:
                out.append(approx_cols[ai])
                ai += 1
        return out
