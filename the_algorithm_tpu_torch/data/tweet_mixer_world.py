"""The seeded world that tweet-mixer's Home product serves from.

Numpy and seeded-torch builders of a :class:`~the_algorithm_tpu_torch.mixers.
candidate_pipeline_catalog.SourceWorld` that fills every store the
``HOME_RECOMMENDED_TWEETS`` pipelines read, composed from the worlds the port
already has:

- SimClusters: ``data/sann_world``'s corpus and index at ``bench.py``'s shape
  (C=145,408, M=400, T=2,000,000, KT=32) and its query draw; the index also
  serves the diffusion engine and the versioned lookup engine;
- graphs and earlybird: ``data/foryou_world``'s UTEG graph, UTG right index
  and 262,144-doc earlybird index;
- TwHIN and two-tower models over the corpus (16,384 users, 2,000,000
  items, D=128, the JAX package's default widths), with tables drawn as
  flax draws them (``normal(0.02)``) from a seeded generator; the two-tower
  item table is exported once through the item tower;
- host stores (trip popularity rows, similar consumers, producer engagers,
  the model-based earlybird seeds and its linear doc score), seeded numpy;
- a planted-engagement training set for both models at the same shape
  (:func:`planted_engagements`: user u engages with item π(u), and under
  TwHIN relation r with item π_r(u), for seeded permutations), the JAX
  tests' planted preferences (``tests/test_models_training.py``,
  ``tests/test_twhin.py``) at the world's size, with its in-batch training
  batches, losses and hits@K; :meth:`TweetMixerWorld.with_models` serves
  trained models through the Home dense engines.

The sizes are arguments; :data:`FULL` holds the bench's, nothing cut. The
JAX package has no world at this size: its widths are the model configs'
defaults and its corpus and graphs ``bench.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.data import foryou_world, sann_world
from the_algorithm_tpu_torch.graph import graphjet, uteg
from the_algorithm_tpu_torch.mixers import candidate_pipeline_catalog as cat
from the_algorithm_tpu_torch.mixers import similarity_engines as se
from the_algorithm_tpu_torch.models.twhin import RELATIONS, Twhin, TwhinConfig, entity_embeddings, twhin_loss
from the_algorithm_tpu_torch.models.two_tower import TwoTower, TwoTowerConfig, in_batch_softmax_loss, table_rows
from the_algorithm_tpu_torch.ops.retrieval import ClusterTweetIndex
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding
from the_algorithm_tpu_torch.search import earlybird as eb
from the_algorithm_tpu_torch.simclusters import ann

TWHIN_RELATION = RELATIONS.index("favorites")  # the consumer vector's relation
TRIP_MODEL = "trip_v1"
TRIP_SOURCES = ("TOP_GEO", "TOP_DOMAIN")
LOOKUP_MODEL = "simclusters_v2_offline"
RECENT = 4  # recent engaged tweets a query carries (the expansion's fan-out)
SIMILAR_CONSUMERS = 16  # a user's similar consumers
ENGAGERS = 32  # a producer's recent engagers
EB_SEEDS = 16  # model-based earlybird seed authors
TRIP_ROW = 20  # tweets in a trip (source, cluster) row
EXPORT_CHUNK = 1 << 18  # item rows through the item tower at once

# kernel launches of one call of each Home pipeline on the card, (row_gather,
# run_collapse): a SANN query fetches its cluster rows in one launch and
# dedups in one; a UTEG-family traversal the same; UTG two hops and one
# dedup per source tweet; TwHIN's user vector reads the user and relation
# tables, the collaborative filter adds a UTEG traversal; the dense
# lookups one row each; earlybird and the host stores none
PIPELINE_LAUNCHES = {
    "simclusters_interested_in": (1, 1), "simclusters_tweet_based": (1, 1), "simclusters_producer_based": (1, 1),
    "diffusion": (1, 1), "offline_simclusters_lookup": (1, 1),
    "uteg": (1, 1), "consumers_based_utg": (1, 1), "producer_based_utg": (1, 1),
    "utg_tweet_based": (2, 1), "utg_expansion_tweet_based": (2, 1),  # the expansion: per source tweet
    "twhin_consumer_based": (2, 0), "twhin_collab_filter": (3, 1), "twhin_tweet_similarity": (1, 0),
    "deep_retrieval_user_tweet": (1, 0), "deep_retrieval_tweet_tweet": (1, 0), "two_tower_consumer": (1, 0),
    "earlybird_in_network": (0, 0), "earlybird_model_based": (0, 0),
    "trip_geo_popular": (0, 0), "trip_domain_popular": (0, 0),
}


def expected_launches(spec_names, query) -> Dict[str, int]:
    """The launches one request makes through the routed pipelines
    ``spec_names`` (the lookup engine's cache cold)."""
    rg = rc = 0
    for name in spec_names:
        g, c = PIPELINE_LAUNCHES[name]
        n = len(cat._recent_tweets(query)) if name == "utg_expansion_tweet_based" else 1
        rg, rc = rg + n * g, rc + n * c
    return {"run_collapse": rc, "row_gather": rg}


@dataclasses.dataclass(frozen=True)
class TweetMixerShape:
    sann: sann_world.WorldShape = sann_world.PROD
    foryou: foryou_world.ForYouShape = foryou_world.FULL
    embed_dim: int = 128  # TwoTowerConfig / TwhinConfig defaults
    tower_hidden: Tuple[int, ...] = (128,)
    users: int = 32  # served users (queries)

    @property
    def num_users(self) -> int:
        return self.foryou.num_users

    @property
    def num_items(self) -> int:
        return self.sann.T


# bench.py's sizes: 2M items, 16,384 users, the SANN and For You worlds' FULL
FULL = TweetMixerShape()


@dataclasses.dataclass
class Query:
    """A tweet-mixer request: the fields of the JAX package's catalog test
    query (``tests/test_candidate_pipeline_catalog.Query``)."""

    user_id: Optional[int] = 1
    followed_authors: tuple = ()
    recent_engagement_ids: tuple = ()
    source_tweet_id: Optional[int] = None
    topic_id: Optional[int] = None
    geo_id: Optional[int] = None
    trend_id: Optional[int] = None
    last_searched_tweet_id: Optional[int] = None
    language_code: Optional[str] = None
    country_code: Optional[str] = None
    event_id: Optional[int] = None
    interest_topic_ids: tuple = ()
    pinned_tweet_id: Optional[int] = None


class SannParts(NamedTuple):
    """The SimClusters world: the corpus (host), its index and the
    interested-in query draw (device)."""

    corpus_ids: np.ndarray  # [T, KT] int32
    corpus_scores: np.ndarray  # [T, KT] f32
    index: ClusterTweetIndex
    interested_in: SparseEmbedding  # [Q, N]


class CandidateParts(NamedTuple):
    """The For You candidate world: its numpy draws and device stores."""

    world: foryou_world.ForYouWorld
    earlybird_index: eb.EarlybirdIndex
    graph: uteg.EngagementGraph
    right: graphjet.RightIndex


class TripIndex:
    """The trip popularity index ``{(trip_source, cluster): [(tweet, score)]}``
    held as [sources, C, L] arrays, rows score-descending."""

    def __init__(self, ids: np.ndarray, scores: np.ndarray):
        self.ids, self.scores = ids, scores

    def get(self, key, default=()):
        source, cluster = key
        if source not in TRIP_SOURCES or not 0 <= cluster < self.ids.shape[1]:
            return default
        s = TRIP_SOURCES.index(source)
        return list(zip(self.ids[s, cluster].tolist(), self.scores[s, cluster].tolist()))


def community_clusters(shape: sann_world.WorldShape, seed: int = 0) -> np.ndarray:
    """``sann_world.build_corpus``'s community → clusters draw (its first),
    without drawing the corpus."""
    return np.random.default_rng(seed).permutation(shape.C).reshape(shape.n_comm, shape.cpc).astype(np.int32)


def build_sann(shape: sann_world.WorldShape, device) -> SannParts:
    """The SimClusters world of ``bench.py`` (``data/sann_world``), the
    index and queries on ``device``."""
    tweet_ids, tweet_scores, _, comm = sann_world.build_corpus(shape)
    index_np = sann_world.build_index(shape, tweet_ids, tweet_scores)
    q_ids, q_scores = sann_world.draw_queries(shape, comm)
    index = ClusterTweetIndex(*(torch.from_numpy(a).to(device) for a in index_np))
    return SannParts(tweet_ids, tweet_scores, index,
                     SparseEmbedding(torch.from_numpy(q_ids).to(device), torch.from_numpy(q_scores).to(device)))


def build_candidates(shape: TweetMixerShape, device) -> CandidateParts:
    """The For You candidate world (``data/foryou_world``) on ``device``."""
    world = foryou_world.build(shape.foryou, users=shape.users)
    return CandidateParts(world, foryou_world.earlybird_index(world, device),
                          foryou_world.engagement_graph(world, device), foryou_world.right_index(world, device))


@torch.no_grad()
def export_item_table(model: TwoTower, chunk: int = EXPORT_CHUNK) -> torch.Tensor:
    """Every item through the item tower: the [N, D] table the two-tower
    and deep-retrieval engines scan, ``chunk`` rows at a time."""
    n = model.config.num_items
    dev = model.item_table.device
    return torch.cat([model.item_embeddings(torch.arange(s, min(s + chunk, n), device=dev, dtype=torch.int32))
                      for s in range(0, n, chunk)])


def _moved(model: torch.nn.Module, make, device) -> torch.nn.Module:
    """A copy of ``model`` on ``device``: ``make(device)`` builds the shell."""
    shell = make("meta").to_empty(device=device)
    shell.load_state_dict(model.state_dict())
    return shell.requires_grad_(False)


@dataclasses.dataclass
class TweetMixerWorld:
    shape: TweetMixerShape
    sann: SannParts
    sann_config: ann.SimClustersANNConfig
    producer_embeddings: SparseEmbedding  # [Q, N] on the device
    candidates: CandidateParts
    twhin: Twhin
    two_tower: TwoTower
    two_tower_items: torch.Tensor  # [N, D] the exported item-tower table
    similar_consumers: Tuple[np.ndarray, np.ndarray]  # [U, SC] ids, weights
    engagers: Tuple[np.ndarray, np.ndarray]  # [A, E] user ids, weights
    eb_seed_weights: np.ndarray  # [U, EB_SEEDS] f32
    eb_score_weights: torch.Tensor  # [F] f32, the linear doc score
    trip: TripIndex
    queries: List[Query]

    @property
    def device(self) -> torch.device:
        return self.two_tower_items.device

    def with_models(self, twhin: Twhin, two_tower: TwoTower) -> "TweetMixerWorld":
        """The same world serving these (trained) models: frozen copies on
        the world's device, the two-tower item table exported anew."""
        dev = self.device
        tw = _moved(twhin, lambda d: Twhin(twhin.config, device=d), dev)
        tt = _moved(two_tower, lambda d: TwoTower(two_tower.config, device=d), dev)
        return dataclasses.replace(self, twhin=tw, two_tower=tt, two_tower_items=export_item_table(tt))

    def to(self, device) -> "TweetMixerWorld":
        """The same world with every device store on ``device``."""
        dev = torch.device(device)
        cand = self.candidates
        return dataclasses.replace(
            self,
            sann=self.sann._replace(index=ClusterTweetIndex(*(t.to(dev) for t in self.sann.index)),
                                    interested_in=SparseEmbedding(*(t.to(dev) for t in self.sann.interested_in))),
            producer_embeddings=SparseEmbedding(*(t.to(dev) for t in self.producer_embeddings)),
            candidates=CandidateParts(cand.world, cand.earlybird_index._replace(
                **{f: t.to(dev) for f, t in cand.earlybird_index._asdict().items() if isinstance(t, torch.Tensor)}),
                uteg.EngagementGraph(*(t.to(dev) for t in cand.graph)),
                graphjet.RightIndex(*(t.to(dev) for t in cand.right))),
            twhin=_moved(self.twhin, lambda d: Twhin(self.twhin.config, device=d), dev),
            two_tower=_moved(self.two_tower, lambda d: TwoTower(self.two_tower.config, device=d), dev),
            two_tower_items=self.two_tower_items.to(dev),
            eb_score_weights=self.eb_score_weights.to(dev),
        )

    # -- the stores, as the catalog's SourceWorld reads them

    def interested_in(self, user_id: int) -> SparseEmbedding:
        e, Q = self.sann.interested_in, self.sann.interested_in.ids.shape[0]
        return SparseEmbedding(e.ids[int(user_id) % Q], e.scores[int(user_id) % Q])

    def producer_embedding(self, user_id: int) -> SparseEmbedding:
        e, Q = self.producer_embeddings, self.producer_embeddings.ids.shape[0]
        return SparseEmbedding(e.ids[int(user_id) % Q], e.scores[int(user_id) % Q])

    def tweet_embedding(self, tweet_id: int) -> SparseEmbedding:
        t = int(tweet_id)
        return SparseEmbedding(torch.from_numpy(self.sann.corpus_ids[t]), torch.from_numpy(self.sann.corpus_scores[t]))

    @torch.no_grad()
    def twhin_user_vector(self, user_id: int) -> torch.Tensor:
        dev = self.device
        return self.twhin.translate(torch.tensor([int(user_id)], device=dev),
                                    torch.tensor([TWHIN_RELATION], device=dev))[0]

    def twhin_tweet_vector(self, tweet_id: int) -> torch.Tensor:
        return table_rows(self.twhin.item_table, torch.tensor([int(tweet_id)], device=self.device))[0]

    @torch.no_grad()
    def two_tower_user_vector(self, user_id: int) -> torch.Tensor:
        return self.two_tower.user_embeddings(torch.tensor([int(user_id)], device=self.device))[0]

    def two_tower_tweet_vector(self, tweet_id: int) -> torch.Tensor:
        return table_rows(self.two_tower_items, torch.tensor([int(tweet_id)], device=self.device))[0]

    def in_network_query(self, q: Query) -> eb.SearchQuery:
        follows = torch.tensor(sorted(int(a) for a in q.followed_authors), dtype=torch.int32)
        return foryou_world.in_network_query()._replace(followed_authors=follows).to(self.device)

    def eb_seeds(self, q: Query) -> Tuple[List[int], List[float]]:
        authors = [int(a) for a in q.followed_authors][:EB_SEEDS]
        return authors, self.eb_seed_weights[int(q.user_id)][: len(authors)].tolist()

    def eb_model_score(self, features: torch.Tensor) -> torch.Tensor:
        return features @ self.eb_score_weights

    def source_world(self) -> cat.SourceWorld:
        cand, sann = self.candidates, self.sann
        sc_ids, sc_w = self.similar_consumers
        en_ids, en_w = self.engagers
        items = entity_embeddings(self.twhin)
        lookup = se.SimClustersANNEngine(sann.index, self.sann_config, lambda q: self.interested_in(q.user_id),
                                         name="OfflineSimClusters")
        return cat.SourceWorld(
            sann_index=sann.index,
            sann_config=self.sann_config,
            interested_in_fn=lambda q: self.interested_in(q.user_id),
            tweet_embedding_fn=self.tweet_embedding,
            producer_embedding_fn=lambda q: self.producer_embedding(q.user_id),
            twhin_items=items,
            twhin_user_vec_fn=lambda q: self.twhin_user_vector(q.user_id),
            twhin_tweet_vec_fn=self.twhin_tweet_vector,
            dr_tweet_items=self.two_tower_items,
            dr_user_vec_fn=lambda q: self.two_tower_user_vector(q.user_id),
            dr_tweet_vec_fn=self.two_tower_tweet_vector,
            uteg_graph=cand.graph,
            utg_left=cand.graph,
            utg_right=cand.right,
            diffusion_index=sann.index,
            earlybird_index=cand.earlybird_index,
            earlybird_query_fn=self.in_network_query,
            twhin_user_items=entity_embeddings(self.twhin, "user_table"),
            similar_consumers_fn=lambda q: (sc_ids[int(q.user_id)].tolist(), sc_w[int(q.user_id)].tolist()),
            producer_engagers_fn=lambda p: (en_ids[int(p) % en_ids.shape[0]].tolist(),
                                            en_w[int(p) % en_ids.shape[0]].tolist()),
            trip_embedding_stores={TRIP_MODEL: self.interested_in},
            trip_index=self.trip,
            trip_model_id=TRIP_MODEL,
            two_tower_user_fn=self.two_tower_user_vector,
            two_tower_items=self.two_tower_items,
            eb_seeds_fn=self.eb_seeds,
            eb_model_score_fn=self.eb_model_score,
            lookup_engines={LOOKUP_MODEL: lookup},
            lookup_default_model=LOOKUP_MODEL,
        )


# -- planted engagements: what the world's models are trained on

TRAIN_SEED = 17
TRAIN_B = 4096  # in-batch negatives: this world's choice (the JAX tests use 16-64)


class PlantedEngagements(NamedTuple):
    """Each user's planted item: two-tower's π(u) and TwHIN's π_r(u) under
    each relation r, all distinct (cuts of seeded permutations of the
    items)."""

    two_tower: np.ndarray  # [U] int32
    twhin: np.ndarray  # [R, U] int32


def planted_engagements(shape: TweetMixerShape) -> PlantedEngagements:
    U, I, R = shape.num_users, shape.num_items, len(RELATIONS)
    if R * U > I:
        raise ValueError(f"{R} x {U} distinct planted items need more than {I} items")
    rng = np.random.default_rng(TRAIN_SEED)
    two_tower = rng.permutation(I)[:U].astype(np.int32)
    twhin = rng.permutation(I)[:R * U].reshape(R, U).astype(np.int32)
    return PlantedEngagements(two_tower, twhin)


def two_tower_batches(planted: PlantedEngagements, B: int = TRAIN_B) -> Iterator[Dict]:
    """Endless in-batch training batches ``{"users", "items"}`` [B] int32:
    each epoch a seeded permutation of the users cut into batches of B."""
    rng = np.random.default_rng(TRAIN_SEED)
    U = planted.two_tower.shape[0]
    if not 0 < B <= U:
        raise ValueError(f"batches of {B} distinct users from {U}")
    while True:
        order = rng.permutation(U)
        for s in range(0, U - B + 1, B):
            users = order[s:s + B].astype(np.int32)
            yield {"users": users, "items": planted.two_tower[users]}


def twhin_batches(planted: PlantedEngagements, B: int = TRAIN_B) -> Iterator[Dict]:
    """Endless TwHIN batches ``{"users", "relations", "items"}`` [B] int32
    over the R·U planted (user, relation, item) edges, each epoch a seeded
    permutation of them."""
    rng = np.random.default_rng(TRAIN_SEED)
    R, U = planted.twhin.shape
    if not 0 < B <= R * U:
        raise ValueError(f"batches of {B} edges from {R * U}")
    while True:
        order = rng.permutation(R * U)
        for s in range(0, R * U - B + 1, B):
            edge = order[s:s + B]
            rel, users = (edge // U).astype(np.int32), (edge % U).astype(np.int32)
            yield {"users": users, "relations": rel, "items": planted.twhin[rel, users]}


def two_tower_train_loss(model: TwoTower, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """The in-batch softmax at the model's temperature (a Trainer loss_fn)."""
    u, v = model(batch["users"], batch["items"])
    return in_batch_softmax_loss(u, v, model.config.temperature, batch["items"]), {}


def twhin_train_loss(model: Twhin, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """TwHIN's in-batch softmax at the model's temperature (a Trainer loss_fn)."""
    u, v = model(batch["users"], batch["relations"], batch["items"])
    return twhin_loss(u, v, batch["items"], model.config.temperature), {}


HITS_CHUNK = 128  # queries scored against every item at once: [128, 2M] f32 is 1 GB


@torch.no_grad()
def hits_at_k(queries: torch.Tensor, items: torch.Tensor, planted: torch.Tensor, k: int) -> float:
    """The share of ``queries`` [Q, D] whose planted item (``planted`` [Q])
    ranks among the top ``k`` of ``queries @ items.T`` over every item:
    fewer than k items score above it."""
    hits = 0
    planted = planted.to(items.device).long()
    for s in range(0, queries.shape[0], HITS_CHUNK):
        q = queries[s:s + HITS_CHUNK].float()
        scores = q @ items.float().T
        own = scores.gather(1, planted[s:s + HITS_CHUNK, None])
        hits += int(((scores > own).sum(dim=1) < k).sum())
    return hits / max(queries.shape[0], 1)


@torch.no_grad()
def two_tower_hits(model: TwoTower, planted: PlantedEngagements, users: np.ndarray, k: int) -> float:
    """hits@k of each of ``users``' planted item over all items (the item
    tower's export)."""
    dev = model.item_table.device
    q = model.user_embeddings(torch.from_numpy(users.astype(np.int32)).to(dev))
    return hits_at_k(q, export_item_table(model), torch.from_numpy(planted.two_tower[users]), k)


@torch.no_grad()
def twhin_hits(model: Twhin, planted: PlantedEngagements, users: np.ndarray, k: int) -> List[float]:
    """hits@k of each of ``users``' planted item under each relation, over
    every row of the item table."""
    dev = model.item_table.device
    u = torch.from_numpy(users.astype(np.int32)).to(dev)
    return [hits_at_k(model.translate(u, torch.full_like(u, r)), model.item_table,
                      torch.from_numpy(planted.twhin[r, users]), k) for r in range(planted.twhin.shape[0])]


def _queries(shape: TweetMixerShape, cand: CandidateParts, rng: np.random.Generator) -> List[Query]:
    """The served users: seeded user ids, the candidate world's follow
    lists in turn, and each user's newest engaged tweets from their UTEG row."""
    uids = rng.choice(shape.num_users, shape.users, replace=False)
    rows = cand.graph.tweet_ids[torch.from_numpy(uids).to(cand.graph.tweet_ids.device)].cpu().numpy()
    follows = cand.world.follows
    out = []
    for i, (u, row) in enumerate(zip(uids, rows)):
        f = follows[i % follows.shape[0]]
        recent = [int(t) for t in row if t != PAD_ID][:RECENT]
        out.append(Query(user_id=int(u), followed_authors=tuple(int(a) for a in f if a != PAD_ID),
                         recent_engagement_ids=tuple(recent)))
    return out


def build(shape: TweetMixerShape = FULL, *, seed: int = 13, device=None,
          sann: Optional[SannParts] = None) -> TweetMixerWorld:
    """The world on ``device`` (default: the card), over the SANN and For
    You worlds of their own seeds; ``sann``: the SANN world of
    :func:`build_sann` at ``shape.sann`` already built (its numpy build
    takes most of a minute at the full shape)."""
    dev = resolve(device, "tweet_mixer_world")
    sann = build_sann(shape.sann, dev) if sann is None else sann
    cand = build_candidates(shape, dev)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    twhin = Twhin(TwhinConfig(shape.num_users, shape.num_items, shape.embed_dim), device=dev,
                  generator=gen).requires_grad_(False)
    two_tower = TwoTower(TwoTowerConfig(shape.num_users, shape.num_items, shape.embed_dim, shape.tower_hidden),
                         device=dev, generator=gen).requires_grad_(False)
    items = export_item_table(two_tower)

    p_ids, p_scores = sann_world.draw_queries(shape.sann, community_clusters(shape.sann), seed=2)
    U, A = shape.num_users, shape.foryou.num_authors
    similar = (rng.integers(0, U, (U, SIMILAR_CONSUMERS)).astype(np.int32),
               rng.uniform(0.1, 1.0, (U, SIMILAR_CONSUMERS)).astype(np.float32))
    engagers = (rng.integers(0, U, (A, ENGAGERS)).astype(np.int32),
                rng.uniform(0.1, 1.0, (A, ENGAGERS)).astype(np.float32))
    eb_seed_weights = rng.uniform(0.0, 1.0, (U, EB_SEEDS)).astype(np.float32)
    eb_score = torch.from_numpy(rng.normal(0.0, 1.0, len(eb.DOC_FEATURES)).astype(np.float32)).to(dev)
    C, L = shape.sann.C, TRIP_ROW
    trip = TripIndex(rng.integers(0, shape.num_items, (len(TRIP_SOURCES), C, L)).astype(np.int32),
                     -np.sort(-rng.uniform(0.0, 1.0, (len(TRIP_SOURCES), C, L)).astype(np.float32), axis=-1))
    cfg = ann.SimClustersANNConfig(max_scan_clusters=shape.sann.N, max_top_tweets_per_cluster=shape.sann.M,
                                   max_num_results=shape.sann.X)
    return TweetMixerWorld(
        shape, sann, cfg,
        SparseEmbedding(torch.from_numpy(p_ids).to(dev), torch.from_numpy(p_scores).to(dev)),
        cand, twhin, two_tower, items, similar, engagers, eb_seed_weights, eb_score, trip,
        _queries(shape, cand, rng))
