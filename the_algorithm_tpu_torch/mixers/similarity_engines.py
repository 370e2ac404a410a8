"""Similarity engines: the cr-mixer/tweet-mixer engine zoo as CandidateSources.

Counterpart of ``the_algorithm_tpu/mixers/similarity_engines.py``
(``cr-mixer/server/.../similarity_engine/*.scala``): each engine turns a
source signal (user, source tweet, or producer) into scored tweet
candidates through one retrieval backend of the port.

The JAX engines call single-query functions. The port's retrieval paths are
batched (``ann.get_tweet_candidates`` wraps the batched scan, ``uteg.recommend``
takes [R, S] seeds, ``graphjet.related_tweets`` [B] sources), so an engine
calls them with a batch of one and takes row 0: the SANN engines launch one
``row_gather`` and one ``run_collapse`` a query, the UTEG family the same,
UTG two ``row_gather`` hops and one ``run_collapse``. Every keyed read of a
device table (QIG, topic rows) goes through ``row_gather`` with JAX's index
rule (``gather.jax_rows``). Dense top-Ks are an f32 product plus
``retrieval.top_k``, in ``lax.top_k``'s order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from the_algorithm_tpu_torch.core.config import Param
from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.core.metrics import NullStats
from the_algorithm_tpu_torch.graph import graphjet
from the_algorithm_tpu_torch.graph import uteg as uteg_mod
from the_algorithm_tpu_torch.graph.uteg import _on
from the_algorithm_tpu_torch.models.two_tower import retrieve_top_k
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidateSource
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.simclusters import ann


def _np(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a sequence) as numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_candidates(ids, scores, source: str) -> List[Candidate]:
    out = []
    for i, s in zip(_np(ids), _np(scores)):
        if int(i) != int(PAD_ID) and np.isfinite(s):
            out.append(
                Candidate(id=int(i), score=float(s), source=source,
                          features={"retrieval_score": float(s)})
            )
    return out


def _with_features(cands: List[Candidate], name: str, values) -> List[Candidate]:
    """Set ``features[name]`` of the i-th candidate to ``values[i]``."""
    v = _np(values)
    for i, c in enumerate(cands):
        c.features[name] = float(v[i])
    return cands


def _sann_query(index: ClusterTweetIndex, emb: SparseEmbedding, config) -> List:
    emb = SparseEmbedding(_on(emb.ids, index.tweet_ids.device, torch.int32),
                          _on(emb.scores, index.tweet_ids.device, torch.float32))
    return ann.get_tweet_candidates(index, emb, config)


def _recommend_one(graph: uteg_mod.EngagementGraph, seed_ids, seed_weights, *, max_results: int,
                   min_social_proof: int):
    """``uteg.recommend`` for one query: a batch of one, row 0."""
    dev = graph.tweet_ids.device
    out = uteg_mod.recommend(graph, _on(seed_ids, dev, torch.int32)[None], _on(seed_weights, dev, torch.float32)[None],
                             max_results=max_results, min_social_proof=min_social_proof)
    return tuple(t[0] for t in out)


def _table_row(t: int, *tables: torch.Tensor):
    """Row ``t`` of aligned device tables, read as JAX's ``table[t]`` reads
    it (a negative row wraps, one past the end clamps), in one
    ``row_gather`` launch."""
    row = jax_rows(torch.tensor([int(t)], device=tables[0].device), tables[0].shape[0]).to(torch.int32)
    return tuple(r[0] for r in row_gather(row, *tables))


class SimClustersANNEngine(CandidateSource):
    """Query.user_embedding (SimClusters) → SANN candidates."""

    def __init__(
        self,
        index: ClusterTweetIndex,
        config: ann.SimClustersANNConfig,
        embedding_fn: Callable[[Any], SparseEmbedding],
        name: str = "SimClustersANN",
    ):
        self.index = index
        self.config = config
        self.embedding_fn = embedding_fn
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        ids, scores = _sann_query(self.index, self.embedding_fn(query), self.config)
        return _to_candidates(ids, scores, self.name)


class TwHINANNEngine(CandidateSource):
    """Dense two-tower retrieval: user vector → brute-force top-K items."""

    def __init__(
        self,
        item_embeddings: torch.Tensor,  # [N, D] normalized
        user_vector_fn: Callable[[Any], torch.Tensor],
        k: int = 200,
        name: str = "TwHINANN",
    ):
        self.items = item_embeddings
        self.user_vector_fn = user_vector_fn
        self.k = k
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        u = _on(self.user_vector_fn(query), self.items.device, torch.float32)[None, :]
        ids, scores = retrieve_top_k(u, self.items, self.k)
        return _to_candidates(ids[0], scores[0], self.name)


class UTEGEngine(CandidateSource):
    """Seeded engagement-graph traversal ("liked by people you follow")."""

    def __init__(
        self,
        graph: uteg_mod.EngagementGraph,
        seeds_fn: Callable[[Any], tuple],  # query -> (seed_ids, seed_weights)
        max_results: int = 200,
        min_social_proof: int = 1,
        name: str = "UTEG",
    ):
        self.graph = graph
        self.seeds_fn = seeds_fn
        self.max_results = max_results
        self.min_social_proof = min_social_proof
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        seed_ids, seed_weights = self.seeds_fn(query)
        ids, scores, proof = _recommend_one(self.graph, seed_ids, seed_weights, max_results=self.max_results,
                                            min_social_proof=self.min_social_proof)
        return _with_features(_to_candidates(ids, scores, self.name), "social_proof", proof)


class EarlybirdEngine(CandidateSource):
    """In-network realtime search (≡ EarlybirdInNetwork candidate pipeline)."""

    def __init__(
        self,
        index: eb.EarlybirdIndex,
        query_fn: Callable[[Any], eb.SearchQuery],
        max_results: int = 200,
        name: str = "EarlybirdInNetwork",
    ):
        self.index = index
        self.query_fn = query_fn
        self.max_results = max_results
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        sq = self.query_fn(query)
        ids, scores = eb.search(self.index, sq, max_results=self.max_results)
        return _to_candidates(ids, scores, self.name)


class DiffusionEngine(CandidateSource):
    """Retweet-diffusion retrieval ≡ ``DiffusionBasedSimilarityEngine.scala``.

    Consumer-based: the user's SimClusters InterestedIn embedding queries a
    *diffusion* cluster→tweet index — built not from favs but from the
    InterestedIn vectors of each tweet's RETWEETERS, so it surfaces tweets
    that diffuse through the viewer's communities. Same SANN scan,
    different index.
    """

    def __init__(
        self,
        diffusion_index: ClusterTweetIndex,
        config: ann.SimClustersANNConfig,
        embedding_fn: Callable[[Any], SparseEmbedding],
        name: str = "Diffusion",
    ):
        self.index = diffusion_index
        self.config = config
        self.embedding_fn = embedding_fn
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        ids, scores = _sann_query(self.index, self.embedding_fn(query), self.config)
        return _to_candidates(ids, scores, self.name)


def build_diffusion_index(
    retweeter_interested_in: SparseEmbedding,  # [U, K] retweeters' embeddings
    retweet_tweet_ids: np.ndarray,  # [E] tweet retweeted
    retweet_user_rows: np.ndarray,  # [E] row of the retweeter in ^
    num_clusters: int,
    tweets_per_cluster: int,
    device=None,
) -> ClusterTweetIndex:
    """Offline diffusion-index build (host-side): each retweet event adds
    the retweeter's InterestedIn mass to (cluster, tweet) cells; keep the
    top-M tweets per cluster. ≡ the diffusion dataset pipeline the engine
    reads (``DiffusionBasedSimilarityEngine`` store). The index lands on
    ``device`` (default: the card)."""
    ids_np = _np(retweeter_interested_in.ids)
    sc_np = _np(retweeter_interested_in.scores)
    acc: dict = {}
    for t, u in zip(retweet_tweet_ids, retweet_user_rows):
        for c, s in zip(ids_np[u], sc_np[u]):
            if int(c) == int(PAD_ID):
                continue
            key = (int(c), int(t))
            acc[key] = acc.get(key, 0.0) + float(s)
    idx_ids = np.full((num_clusters, tweets_per_cluster), int(PAD_ID), np.int32)
    idx_scores = np.zeros((num_clusters, tweets_per_cluster), np.float32)
    per_cluster: dict = {}
    for (c, t), s in acc.items():
        per_cluster.setdefault(c, []).append((s, t))
    for c, entries in per_cluster.items():
        entries.sort(reverse=True)
        for m, (s, t) in enumerate(entries[:tweets_per_cluster]):
            idx_ids[c, m] = t
            idx_scores[c, m] = s
    ts = np.zeros_like(idx_ids)
    dev = resolve(device, "build_diffusion_index")
    return ClusterTweetIndex(*(torch.from_numpy(a).to(dev) for a in (idx_ids, idx_scores, ts)))


class QIGEngine(CandidateSource):
    """Query-interaction-graph similar tweets ≡ ``TweetBasedQigSimilarityEngine``.

    Tweet-based: a precomputed similar-tweets table (from search-query
    co-click co-occurrence) keyed by source tweet; the engine is one
    ``row_gather`` of the source row + score threshold.
    """

    def __init__(
        self,
        similar_ids: torch.Tensor,  # [T, K] int32 PAD_ID-padded
        similar_scores: torch.Tensor,  # [T, K] float32
        source_tweet_fn: Callable[[Any], int],
        min_score: float = 0.0,
        name: str = "QIG",
    ):
        self.similar_ids = similar_ids
        self.similar_scores = similar_scores
        self.source_tweet_fn = source_tweet_fn
        self.min_score = min_score
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        ids, scores = (_np(r) for r in _table_row(self.source_tweet_fn(query), self.similar_ids,
                                                   self.similar_scores))
        keep = scores >= self.min_score
        return _to_candidates(np.where(keep, ids, int(PAD_ID)), scores, self.name)


def build_qig_table(
    query_clicks: np.ndarray,  # [E, 2] (query_id, tweet_id) click events
    num_tweets: int,
    k: int,
    device=None,
) -> tuple:
    """Offline QIG build: tweets clicked from the same search query
    co-occur; score = cooc / sqrt(deg·deg) (cosine over the query-click
    incidence, the QIG similarity). The tables land on ``device`` (default:
    the card)."""
    from collections import defaultdict

    by_query = defaultdict(set)
    for q, t in query_clicks:
        by_query[int(q)].add(int(t))
    cooc: dict = defaultdict(float)
    deg = np.zeros(num_tweets, np.float32)
    for tweets in by_query.values():
        for t in tweets:
            deg[t] += 1
        tl = sorted(tweets)
        for i, a in enumerate(tl):
            for b in tl[i + 1:]:
                cooc[(a, b)] += 1.0
    ids = np.full((num_tweets, k), int(PAD_ID), np.int32)
    scores = np.zeros((num_tweets, k), np.float32)
    per: dict = defaultdict(list)
    for (a, b), c in cooc.items():
        s = c / max(np.sqrt(deg[a] * deg[b]), 1e-9)
        per[a].append((s, b))
        per[b].append((s, a))
    for t, entries in per.items():
        entries.sort(reverse=True)
        for m, (s, o) in enumerate(entries[:k]):
            ids[t, m] = o
            scores[t, m] = s
    dev = resolve(device, "build_qig_table")
    return torch.from_numpy(ids).to(dev), torch.from_numpy(scores).to(dev)


class TopicTweetEngine(CandidateSource):
    """Topic→tweets retrieval ≡ ``SkitTopicTweetSimilarityEngine`` /
    ``SkitHighPrecisionTopicTweetSimilarityEngine``.

    A topic→top-tweets index (ids+cosine relevance, built by the topic-tweet
    offline job); high-precision mode raises the relevance floor. One
    ``row_gather`` of the topic row + threshold."""

    def __init__(
        self,
        topic_index: ClusterTweetIndex,  # rows keyed by topic id
        topic_fn: Callable[[Any], int],
        min_relevance: float = 0.0,
        high_precision_relevance: float = 0.75,
        high_precision: bool = False,
        allowed_ids=None,  # optional id allow-set (the TrendsVideo variant
        # restricts the trend row to its video corpus)
        name: str = "SkitTopicTweet",
    ):
        self.topic_index = topic_index
        self.topic_fn = topic_fn
        self.min_relevance = (
            high_precision_relevance if high_precision else min_relevance
        )
        self.allowed_ids = (None if allowed_ids is None
                            else {int(i) for i in _np(allowed_ids)})
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        ids, scores = (_np(r) for r in _table_row(self.topic_fn(query), self.topic_index.tweet_ids,
                                                   self.topic_index.scores))
        keep = scores >= self.min_relevance
        out = _to_candidates(np.where(keep, ids, int(PAD_ID)), scores, self.name)
        if self.allowed_ids is not None:
            out = [c for c in out if c.id in self.allowed_ids]
        return out


class UAGEngine(CandidateSource):
    """User-Ad-Graph traversal ≡ ``ConsumersBasedUserAdGraphSimilarityEngine``.

    Same left-seeded bipartite traversal as UTEG, over the user→promoted
    tweet engagement graph: promoted tweets engaged by accounts similar to
    the viewer."""

    def __init__(
        self,
        ad_graph: uteg_mod.EngagementGraph,
        seeds_fn: Callable[[Any], tuple],
        max_results: int = 200,
        min_social_proof: int = 1,
        name: str = "UAG",
    ):
        self.graph = ad_graph
        self.seeds_fn = seeds_fn
        self.max_results = max_results
        self.min_social_proof = min_social_proof
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        seed_ids, seed_weights = self.seeds_fn(query)
        ids, scores, _ = _recommend_one(self.graph, seed_ids, seed_weights, max_results=self.max_results,
                                        min_social_proof=self.min_social_proof)
        cands = _to_candidates(ids, scores, self.name)
        for c in cands:
            c.features["promoted"] = True
        return cands


class UTGEngine(CandidateSource):
    """Tweet-based co-engagement similarity ≡
    ``TweetBasedUserTweetGraphSimilarityEngine`` (UVG = same with a video
    candidate mask): two-hop traversal source tweet → engaging users →
    their other tweets, cosine-normalized by degrees."""

    def __init__(
        self,
        left: uteg_mod.EngagementGraph,
        right: graphjet.RightIndex,
        source_tweet_fn: Callable[[Any], int],
        max_results: int = 200,
        min_cooccurrence: int = 1,
        candidate_mask=None,  # [T] bool (set for the UVG variant)
        name: str = "UTG",
    ):
        self.left = left
        self.right = right
        self.source_tweet_fn = source_tweet_fn
        self.max_results = max_results
        self.min_cooccurrence = min_cooccurrence
        self.candidate_mask = candidate_mask
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        dev = self.left.tweet_ids.device
        t = torch.tensor([int(self.source_tweet_fn(query))], dtype=torch.int32, device=dev)
        mask = None if self.candidate_mask is None else _on(self.candidate_mask, dev, torch.bool)
        ids, scores, cooc = (r[0] for r in graphjet.related_tweets(
            self.left, self.right, t,
            max_results=self.max_results,
            min_cooccurrence=self.min_cooccurrence,
            candidate_mask=mask,
        ))
        return _with_features(_to_candidates(ids, scores, self.name), "cooccurrence", cooc)


class ConsumersBasedUTGEngine(CandidateSource):
    """Similar-consumer engagement retrieval ≡
    ``ConsumersBasedUserTweetGraphSimilarityEngine`` (and the
    ``ConsumersBasedUserVideoGraph`` variant via ``candidate_mask``-capable
    seeds): instead of the viewer's follows, the traversal seeds are
    *similar consumers* (e.g. RealGraph top-K or embedding neighbors) — the
    same left-seeded aggregation as UTEG over a different seed set."""

    def __init__(
        self,
        graph: uteg_mod.EngagementGraph,
        similar_consumers_fn: Callable[[Any], tuple],  # q -> (ids, weights)
        max_results: int = 200,
        min_social_proof: int = 1,
        name: str = "ConsumersBasedUserTweetGraph",
    ):
        self.graph = graph
        self.similar_consumers_fn = similar_consumers_fn
        self.max_results = max_results
        self.min_social_proof = min_social_proof
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        seed_ids, seed_weights = self.similar_consumers_fn(query)
        ids, scores, proof = _recommend_one(self.graph, seed_ids, seed_weights, max_results=self.max_results,
                                            min_social_proof=self.min_social_proof)
        return _with_features(_to_candidates(ids, scores, self.name), "social_proof", proof)


class TwhinCollabFilterEngine(CandidateSource):
    """Two-stage TwHIN collaborative filtering ≡
    ``TwhinCollabFilterSimilarityEngine.scala``: (1) the viewer's TwHIN
    embedding retrieves the K most-similar *users* (one [U, D] f32 product
    + top-K); (2) those users' recent engagement-graph tweets aggregate
    weighted by user similarity (``max(sim, 0)``) — the reference's
    cluster-to-member expansion in two device calls."""

    def __init__(
        self,
        user_embeddings: torch.Tensor,  # [U, D] TwHIN user table
        engagement_graph: uteg_mod.EngagementGraph,  # rows align with ^
        user_vec_fn: Callable[[Any], torch.Tensor],  # query -> [D]
        similar_users: int = 16,
        max_results: int = 200,
        name: str = "TwhinCollabFilter",
    ):
        self.user_embeddings = user_embeddings
        self.graph = engagement_graph
        self.user_vec_fn = user_vec_fn
        self.similar_users = similar_users
        self.max_results = max_results
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        v = _on(self.user_vec_fn(query), self.user_embeddings.device, torch.float32)
        sims = torch.matmul(self.user_embeddings.float(), v)  # [U]
        k = min(self.similar_users, sims.shape[0])
        top_sims, top_users = retrieval.top_k(sims[None], k)
        # similarity-weighted left-seeded aggregation over their engagements
        ids, scores, proof = _recommend_one(self.graph, top_users[0], torch.clamp(top_sims[0], min=0.0),
                                            max_results=self.max_results, min_social_proof=1)
        return _with_features(_to_candidates(ids, scores, self.name), "social_proof", proof)


class UnifiedEngine(CandidateSource):
    """Multi-engine union ≡ ``TweetBasedUnifiedSimilarityEngine`` /
    ``ProducerBasedUnifiedSimilarityEngine``: fan the query out to several
    sub-engines (SANN / UTG / UVG / QIG …), interleave-blend their ranked
    lists, and dedup keeping the best-scoring copy with its contributing
    sources recorded — the cr-mixer "unified" wrapper."""

    def __init__(self, engines: List[CandidateSource],
                 max_results: int = 200, name: str = "Unified"):
        self.engines = list(engines)
        self.max_results = max_results
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        from the_algorithm_tpu_torch.mixers.tweet_mixer import interleave_blend

        per: List[List[Candidate]] = []
        contributors: dict = {}
        # Max-score dedup must happen BEFORE the blend: interleave_blend
        # dedups first-wins by id, so a later (better-scoring) copy would
        # never survive to the selection loop otherwise.
        best: dict = {}
        for eng in self.engines:
            try:
                got = eng.get(query, params)
            except Exception:
                got = []  # fail-open per sub-engine
            for c in got:
                contributors.setdefault(c.id, set()).add(c.source)
                prev = best.get(c.id)
                if prev is None or (c.score or 0.0) > (prev.score or 0.0):
                    best[c.id] = c
            per.append(got)
        blended = interleave_blend(per, self.max_results * 2)
        best = {c.id: best[c.id] for c in blended}
        out = sorted(best.values(), key=lambda c: -(c.score or 0.0))
        for c in out:
            c.features["unified_sources"] = sorted(contributors[c.id])
            c.source = self._name
        return out[: self.max_results]


class ProducerBasedUTGEngine(CandidateSource):
    """Producer-audience retrieval ≡ ``ProducerBasedUserTweetGraph`` /
    ``ProducerBasedUserAdGraphSimilarityEngine``: for each source producer
    signal (followed / heavily-interacted accounts), seed the engagement
    traversal with THAT PRODUCER'S AUDIENCE — the users who recently
    engaged the producer — so the result set is "what this account's
    audience engages with". Seeds from every producer union with the
    producer's signal weight folded into each engager's weight."""

    def __init__(
        self,
        graph: uteg_mod.EngagementGraph,
        engagers_fn: Callable[[int], tuple],  # producer -> (user_ids, w)
        producers_fn: Callable[[Any], tuple],  # query -> (producer_ids, w)
        max_results: int = 200,
        max_seeds: int = 64,
        min_social_proof: int = 1,
        name: str = "ProducerBasedUserTweetGraph",
    ):
        self.graph = graph
        self.engagers_fn = engagers_fn
        self.producers_fn = producers_fn
        self.max_results = max_results
        self.max_seeds = max_seeds
        self.min_social_proof = min_social_proof
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        producers, p_weights = self.producers_fn(query)
        seed_w: dict = {}
        for p, pw in zip(producers, p_weights):
            users, weights = self.engagers_fn(int(p))
            for u, w in zip(users, weights):
                u = int(u)
                seed_w[u] = seed_w.get(u, 0.0) + float(w) * float(pw)
        if not seed_w:
            return []
        top = sorted(seed_w.items(), key=lambda kv: -kv[1])[: self.max_seeds]
        ids, scores, proof = _recommend_one(
            self.graph, np.asarray([u for u, _ in top], np.int32), np.asarray([w for _, w in top], np.float32),
            max_results=self.max_results, min_social_proof=self.min_social_proof)
        return _with_features(_to_candidates(ids, scores, self.name), "social_proof", proof)


class TripEngine(CandidateSource):
    """Trip (geo/trending popularity) retrieval by consumer embedding
    ≡ ``ConsumerEmbeddingBasedTripSimilarityEngine.scala``: take the
    viewer's top SimClusters, fetch each cluster's trip-tweet row from the
    (trip_source × cluster) popularity index, cap per cluster, and
    interleave-dedup keeping the best score — the "popular near your
    interests" source (trip_v1 trends index). Host code.
    """

    MAX_CLUSTERS = 8  # reference MaxClusters
    MAX_PER_CLUSTER = 200  # reference MaxNumResultsPerCluster

    def __init__(
        self,
        embedding_stores,  # {model_id: user_id -> SparseEmbedding}
        trip_index,  # {(trip_source_id, cluster_id): [(tweet, score)]}
        model_id: str,
        trip_source_id: str = "TOP_GEO",
        max_results: int = 200,
        name: str = "ConsumerEmbeddingBasedTripSimilarityEngine",
    ):
        if model_id not in embedding_stores:
            raise KeyError(f"model_id {model_id} not in embedding stores")
        self._store = embedding_stores[model_id]
        self._trip = trip_index
        self._trip_source = trip_source_id
        self.max_results = max_results
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        emb = self._store(int(query.user_id))
        if emb is None:
            return []
        ids = _np(emb.ids)
        scores = _np(emb.scores)
        order = np.argsort(-scores)
        top_clusters = [int(c) for c in ids[order]
                        if int(c) != int(PAD_ID)][: self.MAX_CLUSTERS]
        per_cluster = [
            list(self._trip.get((self._trip_source, c), ()))
            [: self.MAX_PER_CLUSTER]
            for c in top_clusters
        ]
        # interleave across clusters, dedup keeping best score
        best: dict = {}
        order_ids: List[int] = []
        for level in range(max((len(p) for p in per_cluster), default=0)):
            for p in per_cluster:
                if level < len(p):
                    t, s = int(p[level][0]), float(p[level][1])
                    if t not in best:
                        order_ids.append(t)
                    if t not in best or s > best[t]:
                        best[t] = s
        return [
            Candidate(id=t, score=best[t], source=self._name,
                      features={"retrieval_score": best[t]})
            for t in order_ids[: self.max_results]
        ]


class TwoTowerEngine(CandidateSource):
    """Deep-retrieval two-tower ANN ≡
    ``ConsumerEmbeddingBasedTwoTowerSimilarityEngine.scala``: embed the
    viewer with the trained user tower and take exact cosine top-K over
    the device-resident item-tower table (the VecDB/GPU-retrieval role of
    ``DeepRetrievalUserTweetANNCandidateSource``). Rows map to tweet ids
    through ``item_ids`` on the host."""

    def __init__(
        self,
        user_embed_fn,  # user_id -> [D] device/np vector
        item_table,  # [N, D] item-tower embeddings (device-resident)
        item_ids=None,  # [N] tweet ids (None -> row index is the id)
        max_results: int = 200,
        name: str = "ConsumerEmbeddingBasedTwoTowerSimilarityEngine",
    ):
        self._embed = user_embed_fn
        self._items = item_table if isinstance(item_table, torch.Tensor) else torch.as_tensor(_np(item_table))
        self._item_ids = (_np(item_ids)
                          if item_ids is not None else None)
        self.max_results = max_results
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        u = _on(self._embed(int(query.user_id)), self._items.device, torch.float32)
        rows, scores = retrieve_top_k(u[None, :], self._items, self.max_results)
        rows = _np(rows)[0]
        scores = _np(scores)[0]
        ids = self._item_ids[rows] if self._item_ids is not None else rows
        return _to_candidates(ids, scores, self.name)


def first_match(values: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """For each entry of ``values`` [K], the index of its first equal entry
    in ``keys`` [T], 0 where there is none: ``argmax`` of each row of the
    [K, T] equality matrix, without building it (a stable sort of the keys
    and a search)."""
    if keys.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.int64, device=values.device)
    sorted_keys, order = torch.sort(keys, stable=True)
    pos = torch.searchsorted(sorted_keys, values.to(keys.dtype)).clamp_(max=keys.numel() - 1)
    return torch.where(sorted_keys[pos] == values, order[pos], 0)


def author_adjustment(ids: torch.Tensor, tweet_ids: torch.Tensor, author: torch.Tensor,
                      seed_authors: torch.Tensor, seed_weights: torch.Tensor) -> torch.Tensor:
    """Each retrieved id's author adjustment: the seed weight of the author
    of the first index slot holding that id (slot 0 if none holds it), the
    author's first seed (seed 0 if it is not a seed); -inf for PAD ids.
    What the JAX engine computes with two first-match ``argmax``es over
    [T, S] and [K, T] equality matrices."""
    if seed_authors.numel() == 0:
        raise ValueError("author adjustment needs at least one seed author")
    slot = first_match(ids, tweet_ids)  # [K]
    seed = first_match(author[slot], seed_authors)  # [K]
    return torch.where(ids != PAD_ID, seed_weights[seed], -torch.inf)


class EarlybirdModelBasedEngine(CandidateSource):
    """Model-scored earlybird retrieval ≡
    ``EarlybirdModelBasedSimilarityEngine.scala``: scan tweets from seed
    users (FRS/RealGraph top authors) and rank by a trained model score
    (the in-index ``ModelBasedScoringFunction`` with the light ranker's
    linear model) plus per-author score adjustments from the seed weights.
    """

    MAX_HITS = 1000  # reference MaxHitsToProcess

    def __init__(
        self,
        index: eb.EarlybirdIndex,
        seeds_fn,  # query -> (author_ids [S], weights [S])
        model_score_fn,  # features [T, F] -> [T] model scores
        max_results: int = 200,
        name: str = "EarlybirdModelBasedSimilarityEngine",
    ):
        self.index = index
        self._seeds_fn = seeds_fn
        self._score_fn = model_score_fn
        self.max_results = max_results
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        authors, weights = self._seeds_fn(query)
        i = self.index
        dev = i.tweet_ids.device
        # authors and weights MUST stay pairwise aligned: each candidate's
        # author maps to its seed weight by position.
        seed_authors = _on(authors, dev, torch.int32)
        seed_weights = _on(weights, dev, torch.float32)
        sq = eb.SearchQuery(
            tokens=torch.full((1,), PAD_ID, dtype=torch.int32, device=dev),
            require_all=True, min_ts=0, max_ts=2**31 - 1,
            followed_authors=seed_authors,
        )
        # over-retrieve (the MaxHitsToProcess pool), adjust, re-rank: the
        # adjustment changes the ORDER, not just the score
        pool = min(self.MAX_HITS, i.tweet_ids.shape[0])
        ids, scores = eb.search(i, sq, max_results=pool, model_score_fn=self._score_fn)
        adj = author_adjustment(ids, i.tweet_ids, i.author, seed_authors, seed_weights)
        adjusted = torch.where(torch.isfinite(scores), scores + adj, -torch.inf)
        top, sel = retrieval.top_k(adjusted, min(self.max_results, pool))
        return _to_candidates(torch.where(torch.isfinite(top), ids[sel], PAD_ID), top, self.name)


class EarlybirdTensorflowBasedEngine(EarlybirdModelBasedEngine):
    """≡ ``EarlybirdTensorflowBasedSimilarityEngine.scala`` — the same
    seed-user scan ranked by the full learned ranker (any model forward
    over the doc-feature block). Differs from the model-based engine only
    in which trained artifact supplies ``model_score_fn`` — kept as a
    distinct engine for catalog parity."""

    def __init__(self, index, seeds_fn, tf_score_fn, max_results=200,
                 name="EarlybirdTensorflowBasedSimilarityEngine"):
        super().__init__(index, seeds_fn, tf_score_fn,
                         max_results=max_results, name=name)


# the lookup key param — which versioned model the lookup engine serves
# (≡ LookupEngineQuery.lookupKey / modelId)
LOOKUP_MODEL_ID: "Param[Optional[str]]" = Param("lookup_model_id", None)


class LookupEngine(CandidateSource):
    """Versioned model-store lookup ≡ ``LookupSimilarityEngine.scala`` +
    ``ModelBasedANNStore.scala``: a modelId → underlying engine map with
    per-model stats and an optional TTL cache (the MemCacheConfig layer).
    The lookup key (model id) comes from params or the engine default —
    e.g. OfflineSimClusters variants served side by side."""

    def __init__(
        self,
        engines,  # {model_id: CandidateSource}
        default_model: str,
        cache_ttl_s: Optional[float] = None,
        now_fn=None,
        stats=None,
        name: str = "LookupSimilarityEngine",
    ):
        import time as _time

        if default_model not in engines:
            raise KeyError(f"default model {default_model} missing")
        self._engines = dict(engines)
        self._default = default_model
        self._ttl = cache_ttl_s
        self._now = now_fn or _time.monotonic
        self._cache: dict = {}
        self.stats = stats or NullStats()
        self._name = name

    @property
    def name(self):
        return self._name

    def models(self) -> List[str]:
        return sorted(self._engines)

    def get(self, query, params) -> List[Candidate]:
        model_id = self._default
        if params is not None:
            try:
                model_id = params(LOOKUP_MODEL_ID) or self._default
            except TypeError:
                pass
        eng = self._engines.get(model_id)
        if eng is None:
            raise KeyError(f"unknown model_id {model_id}")
        scope = self.stats.scope(f"similarityEngine/{model_id}")
        key = (model_id, int(getattr(query, "user_id", 0)))
        if self._ttl is not None:
            hit = self._cache.get(key)
            if hit is not None and self._now() - hit[0] < self._ttl:
                scope.counter("cache_hit")
                return list(hit[1])
        with scope.time("latency"):
            got = eng.get(query, params)
        if self._ttl is not None:
            self._cache[key] = (self._now(), list(got))
        for c in got:
            c.source = self._name
            c.features.setdefault("lookup_model_id", model_id)
        return got
