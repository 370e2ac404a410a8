"""Earlybird SuperRoot: multi-tier query routing + cross-tier merge.

Counterpart of ``the_algorithm_tpu/search/root.py``
(``src/java/com/twitter/search/earlybird_root/``): the root routes each
query to the tiers whose time spans overlap it — realtime (~7 days),
protected, full archive — merges per-tier top-K, and early-terminates
(skips older tiers) when the newer tier already fills the request.
Pagination via a ``max_ts`` cursor.

Each tier is an :class:`~the_algorithm_tpu_torch.search.earlybird.EarlybirdIndex`;
routing and merge are small host steps around the per-tier scans. A tier
that carries a ``mesh`` is partitioned over it: its ``index`` is this
rank's block (``earlybird.shard_index``), every rank of the mesh runs the
root together, and the partition fan-out goes through
``earlybird.search_sharded``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.search import earlybird as eb


@dataclasses.dataclass
class Tier:
    """One index tier with its covered time span (≡ TierConfig)."""

    name: str  # "realtime" | "protected" | "full_archive" | ...
    index: eb.EarlybirdIndex
    min_ts: int  # oldest tweet this tier serves
    max_ts: int  # newest (archive tiers end where realtime begins)
    mesh: Optional[object] = None  # set → partition fan-out via search_sharded

    def overlaps(self, q_min: int, q_max: int) -> bool:
        return q_min <= self.max_ts and q_max >= self.min_ts


@dataclasses.dataclass
class SuperRootConfig:
    """≡ the root's early-termination policy: stop descending to older
    tiers once ``min_full_results`` hits are in hand."""

    min_full_results: Optional[int] = None  # default: max_results
    max_tiers: Optional[int] = None


class TierResult(NamedTuple):
    tier: str
    ids: np.ndarray
    scores: np.ndarray


class SuperRoot:
    """Route → per-tier scan → merge (newest tier first)."""

    def __init__(self, tiers: Sequence[Tier],
                 config: SuperRootConfig = SuperRootConfig()):
        # newest first (realtime before archive — the root's tier order)
        self.tiers = sorted(tiers, key=lambda t: -t.max_ts)
        self.config = config

    def route(self, query: eb.SearchQuery) -> List[Tier]:
        q_min, q_max = int(query.min_ts), int(query.max_ts)
        out = [t for t in self.tiers if t.overlaps(q_min, q_max)]
        if self.config.max_tiers is not None:
            out = out[: self.config.max_tiers]
        return out

    def search(
        self,
        query: eb.SearchQuery,
        *,
        max_results: int,
        relevance: Optional[eb.RelevanceParams] = None,
        model_score_fn=None,
    ) -> Tuple[np.ndarray, np.ndarray, List[TierResult]]:
        """(ids [X], scores [X], per-tier results), on the host. Dedup keeps
        the highest-scored copy of a tweet across tiers."""
        need = self.config.min_full_results or max_results
        per_tier: List[TierResult] = []
        found: set = set()  # UNIQUE ids — duplicate slots must not
        # inflate the early-termination count (a re-consumed ingest batch
        # would otherwise stop descent while the merge under-fills)
        for tier in self.route(query):
            scan = eb.search if tier.mesh is None else functools.partial(eb.search_sharded, tier.mesh)
            ids, scores = scan(
                tier.index, query.to(tier.index.tokens.device), max_results=max_results,
                relevance=relevance, model_score_fn=model_score_fn,
            )
            ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
            valid = ids != int(PAD_ID)
            per_tier.append(TierResult(tier.name, ids[valid], scores[valid]))
            found.update(int(i) for i in ids[valid])
            if len(found) >= need:  # early termination: skip older tiers
                break

        all_ids = (np.concatenate([r.ids for r in per_tier])
                   if per_tier else np.empty(0, np.int32))
        all_scores = (np.concatenate([r.scores for r in per_tier])
                      if per_tier else np.empty(0, np.float32))
        if all_ids.size == 0:
            return (np.empty(0, np.int32), np.empty(0, np.float32), per_tier)
        # dedup by max score (a tweet can sit in realtime AND a fresh flush)
        order = np.lexsort((-all_scores, all_ids))
        sid, ssc = all_ids[order], all_scores[order]
        first = np.concatenate([[True], sid[1:] != sid[:-1]])
        uid, usc = sid[first], ssc[first]
        top = np.argsort(-usc)[:max_results]
        return uid[top], usc[top], per_tier

    def paginate(
        self,
        query: eb.SearchQuery,
        *,
        page_size: int,
        max_pages: int = 10,
        **kw,
    ):
        """Cursor pagination: each page re-issues the query with ``max_ts``
        at the oldest served timestamp, dropping already-served ids — so
        ties at second granularity are exhausted before the cursor advances
        past them (a bare ``oldest-1`` cursor would silently skip unserved
        tweets sharing the boundary timestamp)."""
        cursor = int(query.max_ts)
        served: set = set()
        for _ in range(max_pages):
            q = query._replace(max_ts=cursor)
            # over-fetch by the served count at this timestamp so ties
            # surface past the dedup
            ids, scores, _ = self.search(
                q, max_results=page_size + len(served), **kw
            )
            fresh = [j for j, i in enumerate(ids) if int(i) not in served]
            ids, scores = ids[fresh][:page_size], scores[fresh][:page_size]
            if ids.size == 0:
                return
            served.update(int(i) for i in ids)
            yield ids, scores
            oldest = self._oldest_ts(ids)
            if oldest is None or oldest < int(query.min_ts):
                return
            cursor = oldest

    def _oldest_ts(self, ids: np.ndarray) -> Optional[int]:
        best: Optional[int] = None
        want = set(int(i) for i in ids)
        for tier in self.tiers:
            tids = tier.index.tweet_ids.cpu().numpy()
            ts = tier.index.created_ts.cpu().numpy()
            mask = np.isin(tids, list(want))
            t = int(ts[mask].min()) if mask.any() else None
            if tier.mesh is not None:  # the oldest over every partition of the tier
                from the_algorithm_tpu_torch.core.mesh import MODEL_AXIS

                none = np.iinfo(np.int64).max
                t = int(tier.mesh.pmin(torch.tensor([none if t is None else t], device=tier.mesh.device),
                                       MODEL_AXIS))
                t = None if t == none else t
            if t is not None:
                best = t if best is None else min(best, t)
        return best
