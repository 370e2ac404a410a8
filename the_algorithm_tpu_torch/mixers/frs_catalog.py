"""FRS candidate-source catalog, predicate library, and display-location flows.

Counterpart of ``the_algorithm_tpu/mixers/frs_catalog.py``
(``follow-recommendations-service/common/.../candidate_sources/``,
``predicates/`` and ``server/.../flows/``): the 13 source classes, the
SALSA walk and the sims expansion, the predicates, the ML ranker, the
promoted interleave and the per-display-location :class:`FlowCatalog`.

The device sources read their adjacency through ``row_gather`` (one launch
a hop, both tables of a hop together) and dedup their flat entries with one
``run_collapse_sorted`` launch over a single row (Q = 1): the SALSA walk at
bench.py's For You width (64 seeds × 256 followers × 64 follows) collapses
one row of 1,048,576 slots. ``RealGraphSource`` and ``UserUserGraphSource``
call the port's ``graph/realgraph.top_edges`` and
``graph/graphjet.recommend_users`` on the graph's own device. Device
results reach the host through :func:`~the_algorithm_tpu_torch.core.device.host_array`
(``np.asarray`` of a CUDA tensor raises), as do a predict function's.

Source ↔ reference directory:

- :func:`salsa_candidates`            ↔ ``salsa/`` + ``two_hop_random_walk/``
- :func:`sims_expansion_candidates`   ↔ ``sims_expansion/``
- :class:`RecentEngagementSource`     ↔ ``recent_engagement/``
- :class:`RealGraphSource`            ↔ ``real_graph/``
- :class:`PopGeoSource`               ↔ ``geo/`` + ``top_organic_follows_accounts/``
- :class:`StpSource`                  ↔ ``stp/``
- :class:`PpmiLocaleSource`           ↔ ``ppmi_locale_follow/``
- :class:`UserUserGraphSource`        ↔ ``user_user_graph/``
- sims / triangular loops             ↔ ``sims/`` ``triangular_loops/``
  (``follow_recommendations.py``)
- promoted accounts                   ↔ ``promoted_accounts/`` + ``ads`` flow
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.graph import graphjet, realgraph
from the_algorithm_tpu_torch.mixers.follow_recommendations import (  # noqa: F401  (the JAX module's names)
    RecommendationFlow,
    hop_rows,
    not_already_followed,
    not_blocked,
    not_self,
    similar_producers_candidates,
    top_unique,
    triangular_closure_candidates,
)
from the_algorithm_tpu_torch.ops.gather import row_gather
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidateSource


def salsa_candidates(
    follow_adj: torch.Tensor,  # [U, D] user → followed producers
    follower_adj: torch.Tensor,  # [P, D1] producer → followers
    seeds: torch.Tensor,  # [S] the viewer's followed producers (PAD padded)
    max_results: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-backward-forward bipartite walk (the SALSA / two-hop-random-
    walk family): follows → co-followers → *their* follows, scored by
    path-count mass with per-hop degree normalization. Two row_gather
    launches (one a hop) and one dedup-sum."""
    s_valid = seeds != PAD_ID
    # hop 1 (backward): followers of each seed producer  [S, D1]
    (cofollowers,) = row_gather(hop_rows(seeds, follower_adj.shape[0]), follower_adj)
    c_valid = s_valid[:, None] & (cofollowers != PAD_ID)
    # per-seed mass 1/deg spreads over its followers
    deg1 = torch.clamp(torch.sum(c_valid, dim=1), min=1)
    w1 = c_valid.float() / deg1[:, None].float()
    # hop 2 (forward): follows of each co-follower  [S, D1, D2]
    (second,) = row_gather(hop_rows(torch.where(c_valid, cofollowers, PAD_ID), follow_adj.shape[0]), follow_adj)
    s2_valid = c_valid[:, :, None] & (second != PAD_ID)
    deg2 = torch.clamp(torch.sum(s2_valid, dim=2), min=1)
    w2 = w1[:, :, None] * s2_valid.float() / deg2[:, :, None].float()
    return top_unique(torch.where(s2_valid, second, PAD_ID), w2, max_results)


def sims_expansion_candidates(
    sims_nbr_ids: torch.Tensor,  # [P, D] producer → similar producers
    sims_nbr_weights: torch.Tensor,  # [P, D]
    followed: torch.Tensor,  # [S]
    max_results: int,
    second_hop_decay: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two sims hops with decayed second-hop weight (≡ ``sims_expansion/``):
    one row_gather launch a hop (ids and weights together), one dedup-sum
    over both hops' entries."""
    P = sims_nbr_ids.shape[0]
    v = followed != PAD_ID
    h1, hw1 = row_gather(hop_rows(followed, P), sims_nbr_ids, sims_nbr_weights)  # [S, D]
    h1_valid = v[:, None] & (h1 != PAD_ID)
    w1 = torch.where(h1_valid, hw1, 0.0)
    h2, hw2 = row_gather(hop_rows(torch.where(h1_valid, h1, PAD_ID), P), sims_nbr_ids, sims_nbr_weights)  # [S, D, D]
    h2_valid = h1_valid[:, :, None] & (h2 != PAD_ID)
    w2 = torch.where(h2_valid, second_hop_decay * w1[:, :, None] * hw2, 0.0)
    flat_ids = torch.cat([torch.where(h1_valid, h1, PAD_ID).reshape(-1),
                          torch.where(h2_valid, h2, PAD_ID).reshape(-1)])
    flat_w = torch.cat([w1.reshape(-1), w2.reshape(-1)])
    return top_unique(flat_ids, flat_w, max_results)


def _to_candidates(ids, scores, source: str) -> List[Candidate]:
    out = []
    for i, s in zip(host_array(ids), host_array(scores)):
        if int(i) != int(PAD_ID) and np.isfinite(s):
            out.append(Candidate(id=int(i), score=float(s), source=source,
                                 features={"retrieval_score": float(s)}))
    return out


class RecentEngagementSource(CandidateSource):
    """Producers of tweets the viewer recently engaged (≡ ``recent_engagement/``):
    USS engagement tweet ids → author lookup → count-weighted."""

    def __init__(self, author_of_fn: Callable[[np.ndarray], np.ndarray],
                 max_results: int = 40):
        self._author_of = author_of_fn
        self._max = max_results

    def get(self, request, params) -> List[Candidate]:
        ids = np.asarray(getattr(request, "recent_engagement_ids", ()),
                         np.int64)
        if ids.size == 0:
            return []
        authors = host_array(self._author_of(ids)).astype(np.int64)
        uniq, counts = np.unique(authors[authors >= 0], return_counts=True)
        order = np.argsort(-counts)[: self._max]
        return [
            Candidate(id=int(uniq[i]), score=float(counts[i]),
                      source="RecentEngagement",
                      features={"retrieval_score": float(counts[i])})
            for i in order
        ]


class RealGraphSource(CandidateSource):
    """Top RealGraph p(interaction) edges (≡ ``real_graph/``)."""

    def __init__(self, table, model_params, k: int = 40):
        self._table = table
        self._params = model_params
        self._k = k

    def get(self, request, params) -> List[Candidate]:
        uid = int(request.user_id) % int(self._table.neighbor_ids.shape[0])
        ids, scores = realgraph.top_edges(
            self._table, self._params, uid, int(getattr(request, "now", 0)), self._k,
        )
        return _to_candidates(ids, scores, "RealGraph")


class PopGeoSource(CandidateSource):
    """Popular accounts by geo bucket, falling back to global organic top
    (≡ ``geo/`` + ``top_organic_follows_accounts/``)."""

    def __init__(self, geo_top_ids: np.ndarray,  # [G, K]
                 geo_top_scores: np.ndarray,
                 global_top_ids: np.ndarray,  # [K]
                 global_top_scores: np.ndarray):
        self._g_ids = host_array(geo_top_ids)
        self._g_sc = host_array(geo_top_scores)
        self._t_ids = host_array(global_top_ids)
        self._t_sc = host_array(global_top_scores)

    def get(self, request, params) -> List[Candidate]:
        geo = getattr(request, "geo_id", None)
        if geo is not None and 0 <= int(geo) < self._g_ids.shape[0]:
            return _to_candidates(self._g_ids[int(geo)], self._g_sc[int(geo)],
                                  "PopGeo")
        return _to_candidates(self._t_ids, self._t_sc, "TopOrganicFollows")


class StpSource(CandidateSource):
    """"Similar to producer": the sims row of a profile being viewed
    (≡ ``stp/``, the profile-page display location's main source)."""

    def __init__(self, sims_nbr_ids, sims_nbr_weights):
        self._ids = sims_nbr_ids
        self._w = sims_nbr_weights

    def get(self, request, params) -> List[Candidate]:
        p = getattr(request, "profile_user_id", None)
        if p is None:
            return []
        p = int(p) % int(self._ids.shape[0])
        return _to_candidates(self._ids[p], self._w[p], "STP")


class PpmiLocaleSource(CandidateSource):
    """Locale-conditioned PPMI co-follow table (≡ ``ppmi_locale_follow/``)."""

    def __init__(self, ppmi_by_locale: Dict[str, Tuple[np.ndarray, np.ndarray]]):
        self._table = ppmi_by_locale

    def get(self, request, params) -> List[Candidate]:
        loc = getattr(request, "locale", None)
        entry = self._table.get(loc)
        if entry is None:
            return []
        ids, scores = entry
        return _to_candidates(ids, scores, "PpmiLocaleFollow")


class UserUserGraphSource(CandidateSource):
    """UUG circle-of-engaged-users recommendations (≡ ``user_user_graph/``,
    backed by ``graph/graphjet.recommend_users``)."""

    def __init__(self, uug_graph, max_results: int = 40):
        self._graph = uug_graph
        self._max = max_results

    def get(self, request, params) -> List[Candidate]:
        seeds = np.asarray(sorted(request.followed_set), np.int32)
        if seeds.size == 0:
            return []
        dev = self._graph.user_ids.device
        ids, scores, proof = graphjet.recommend_users(
            self._graph, torch.from_numpy(seeds).to(dev)[None],
            torch.ones((1, seeds.size), dtype=torch.float32, device=dev), max_results=self._max,
        )
        cands = _to_candidates(ids[0], scores[0], "UserUserGraph")
        proof_np = host_array(proof[0])
        for i, c in enumerate(cands):
            c.features["social_proof"] = float(proof_np[i])
        return cands


class AddressBookSource(CandidateSource):
    """Contact-import matches (≡ ``addressbook/``): accounts whose uploaded
    contact identifiers intersect the viewer's address book, weighted by
    reverse-lookup count (forward = my contacts on the platform, reverse =
    accounts that have ME in their contacts — both legs surfaced)."""

    def __init__(self, forward: Dict[int, Sequence[int]],
                 reverse: Dict[int, Sequence[int]],
                 max_results: int = 40):
        self._fwd = forward
        self._rev = reverse
        self._max = max_results

    def get(self, request, params) -> List[Candidate]:
        uid = int(request.user_id)
        scores: Dict[int, float] = {}
        for a in self._fwd.get(uid, ()):
            scores[int(a)] = scores.get(int(a), 0.0) + 1.0
        for a in self._rev.get(uid, ()):
            scores[int(a)] = scores.get(int(a), 0.0) + 0.5
        top = sorted(scores.items(), key=lambda kv: -kv[1])[: self._max]
        return [
            Candidate(id=a, score=s, source="AddressBook",
                      features={"retrieval_score": s})
            for a, s in top
        ]


class CrowdSearchAccountsSource(CandidateSource):
    """Frequently-searched / frequently-followed-from-search accounts by
    country bucket (≡ ``crowd_search_accounts/``)."""

    def __init__(self, by_bucket: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 default_bucket: str = "global"):
        self._table = by_bucket
        self._default = default_bucket

    def get(self, request, params) -> List[Candidate]:
        loc = getattr(request, "locale", None) or self._default
        entry = self._table.get(loc) or self._table.get(self._default)
        if entry is None:
            return []
        ids, scores = entry
        return _to_candidates(ids, scores, "CrowdSearchAccounts")


class PromotedAccountsSource(CandidateSource):
    """Ads-blended promoted accounts (≡ ``promoted_accounts/``): candidates
    carry the promoted flag so :func:`interleave_promoted` can weave them
    at the ad slots."""

    def __init__(self, promoted_ids: np.ndarray, bids: np.ndarray,
                 max_results: int = 8):
        self._ids = host_array(promoted_ids)
        self._bids = host_array(bids)
        self._max = max_results

    def get(self, request, params) -> List[Candidate]:
        order = np.argsort(-self._bids)[: self._max]
        out = []
        for i in order:
            c = Candidate(id=int(self._ids[i]), score=float(self._bids[i]),
                          source="PromotedAccounts",
                          features={"is_promoted": 1.0,
                                    "retrieval_score": float(self._bids[i])})
            out.append(c)
        return out


class SocialgraphSource(CandidateSource):
    """Friends-of-friends follow-graph expansion (≡ ``socialgraph/``):
    2-hop over the viewer's follow set, weighted by the number of followed
    accounts that follow the candidate (mutual-follow social proof)."""

    def __init__(self, follows_of: Callable[[int], Sequence[int]],
                 max_results: int = 40):
        self._follows_of = follows_of
        self._max = max_results

    def get(self, request, params) -> List[Candidate]:
        seeds = set(int(a) for a in request.followed_set)
        proof: Dict[int, int] = {}
        for s in seeds:
            for a in self._follows_of(s):
                a = int(a)
                if a in seeds or a == int(request.user_id):
                    continue
                proof[a] = proof.get(a, 0) + 1
        top = sorted(proof.items(), key=lambda kv: (-kv[1], kv[0]))
        out = []
        for a, n in top[: self._max]:
            out.append(Candidate(
                id=a, score=float(n), source="Socialgraph",
                features={"social_proof": float(n),
                          "retrieval_score": float(n)}))
        return out


class TwoHopRandomWalkSource(CandidateSource):
    """Precomputed two-hop random-walk scores (≡ ``two_hop_random_walk/``):
    the offline RWR table keyed by viewer row — the batch twin of the
    SALSA source's online walk."""

    def __init__(self, walk_ids: np.ndarray,  # [U, K]
                 walk_scores: np.ndarray):
        self._ids = host_array(walk_ids)
        self._sc = host_array(walk_scores)

    def get(self, request, params) -> List[Candidate]:
        u = int(request.user_id) % self._ids.shape[0]
        return _to_candidates(self._ids[u], self._sc[u], "TwoHopRandomWalk")


# -- predicate library (≡ common/.../predicates/) -------------------------------


def inactive_predicate(last_active_ts: np.ndarray, max_inactive_s: int = 30 * 86400):
    """≡ ``InactivePredicate``: don't recommend dormant producers."""
    arr = host_array(last_active_ts)

    def pred(request, c: Candidate) -> bool:
        if not (0 <= c.id < arr.shape[0]):
            return True
        return getattr(request, "now", 0) - arr[c.id] <= max_inactive_s

    return pred


class PreviouslyRecommendedStore:
    """Impression history for WTF modules (≡ ``PreviouslyRecommendedUserIds
    Predicate`` + ``dismiss/``): drop users already shown or dismissed."""

    def __init__(self):
        self._shown: Dict[int, Set[int]] = {}
        self._dismissed: Dict[int, Set[int]] = {}

    def record_shown(self, user_id: int, producer_ids: Sequence[int]) -> None:
        self._shown.setdefault(int(user_id), set()).update(
            int(p) for p in producer_ids
        )

    def record_dismiss(self, user_id: int, producer_id: int) -> None:
        self._dismissed.setdefault(int(user_id), set()).add(int(producer_id))

    def predicate(self):
        def pred(request, c: Candidate) -> bool:
            u = int(request.user_id)
            return (c.id not in self._shown.get(u, ())
                    and c.id not in self._dismissed.get(u, ()))

        return pred


def health_predicate(unsafe_ids: Set[int]):
    """≡ ``health/`` + gizmoduck safety flags: drop flagged accounts."""

    def pred(request, c: Candidate) -> bool:
        return c.id not in unsafe_ids

    return pred


def excluded_ids_predicate():
    """≡ ``ExcludedUserIdPredicate``: request-scoped exclusions."""

    def pred(request, c: Candidate) -> bool:
        return c.id not in getattr(request, "excluded_ids", set())

    return pred


# -- ML ranker + promoted interleave --------------------------------------------


def ml_ranker(feature_fn: Callable[[object, List[Candidate]], np.ndarray],
              predict_fn: Callable[[np.ndarray], np.ndarray]):
    """≡ the DataRecord → prediction-service ranker (``rankers/``): batch
    featurize (e.g. retrieval score, #sources, realgraph/sims scores) →
    p(follow) model → candidate.score."""

    def rank(request, candidates: List[Candidate]) -> None:
        if not candidates:
            return
        feats = host_array(feature_fn(request, candidates)).astype(np.float32)
        p = host_array(predict_fn(feats)).reshape(-1)
        for c, s in zip(candidates, p):
            c.features["p_follow"] = float(s)
            c.score = float(s)

    return rank


def interleave_promoted(organic: List[Candidate],
                        promoted: List[Candidate],
                        every: int = 4) -> List[Candidate]:
    """≡ ``promoted_accounts/`` + the ads flow transform: one promoted slot
    every ``every`` organic results."""
    out: List[Candidate] = []
    pi = 0
    for i, c in enumerate(organic):
        if pi < len(promoted) and i > 0 and i % every == 0:
            p = promoted[pi]
            p.features["promoted"] = True
            out.append(p)
            pi += 1
        out.append(c)
    return out


# -- display-location flows (≡ server/.../flows/) --------------------------------


class DisplayLocation(enum.Enum):
    HOME_TIMELINE = "home_timeline"
    PROFILE_SIDEBAR = "profile_sidebar"
    POST_NUX = "post_nux"  # onboarding follow task
    EXPLORE = "explore"


@dataclasses.dataclass
class FlowCatalog:
    """Per-display-location flow wiring (≡ ``ContentRecommenderFlow`` /
    ``PostNuxMlFlow`` etc.): which sources, which predicates, what size."""

    sources_by_name: Dict[str, Callable[[object], List[Candidate]]]
    predicates: Sequence[Callable]
    ranker: Optional[Callable] = None

    FLOW_SOURCES = {
        DisplayLocation.HOME_TIMELINE: (
            "sims", "sims_expansion", "triangular", "salsa",
            "recent_engagement", "real_graph", "user_user_graph",
            "socialgraph", "two_hop_random_walk",
        ),
        DisplayLocation.PROFILE_SIDEBAR: ("stp", "sims", "triangular",
                                          "socialgraph"),
        DisplayLocation.POST_NUX: (
            "pop_geo", "ppmi_locale", "sims", "salsa", "address_book",
            "crowd_search",
        ),
        DisplayLocation.EXPLORE: ("pop_geo", "recent_engagement", "salsa",
                                  "crowd_search", "promoted_accounts"),
    }
    FLOW_SIZE = {
        DisplayLocation.HOME_TIMELINE: 40,
        DisplayLocation.PROFILE_SIDEBAR: 10,
        DisplayLocation.POST_NUX: 60,
        DisplayLocation.EXPLORE: 30,
    }

    def flow(self, location: DisplayLocation) -> RecommendationFlow:
        sources = [
            self.sources_by_name[n]
            for n in self.FLOW_SOURCES[location]
            if n in self.sources_by_name
        ]
        return RecommendationFlow(
            sources=sources,
            predicates=list(self.predicates),
            ranker=self.ranker,
            max_results=self.FLOW_SIZE[location],
        )
