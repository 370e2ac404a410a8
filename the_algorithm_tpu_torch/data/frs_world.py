"""The seeded follow-recommendation (FRS) world over bench.py's For You shape.

From a seed, numpy draws the follow graph of all users of the For You world
(``foryou_world.FULL``: 16,384 users, 4,096 authors; users 0-4,095 are the
authors, as their ids say), in ``foryou_world``'s way — each user follows
48 authors, sorted and padded to 64 with PAD_ID — then a fav stream of 16
events a user on tweets whose author is the tweet id mod the authors. From
those :func:`build` makes, on the device:

- the follow adjacency [U, 64] and the follower adjacency [A, D1], D1 the
  largest in-degree rounded up to a multiple of 32;
- the producer-similarity graph through ``simclusters/sims_graph``
  (follower cosine, top 64, symmetrized);
- a user-user graph (UUG: engager → author) and a RealGraph edge table
  (the first :attr:`FrsShape.realgraph_events` events, folded on the host)
  with a seeded edge model;

and the host tables of the catalog's other sources (recent engagements, geo
and global top authors, locale PPMI rows, address books, crowd-search rows,
promoted accounts, the offline two-hop walk, last-active times, unsafe ids).

:meth:`FrsWorld.catalog` wires every source into a ``FlowCatalog``;
:data:`SOURCE_LAUNCHES` and :func:`expected_launches` give the kernel
launches one call of each device source and each flow makes.
:func:`raw_events` draws a seeded raw action stream over every UUA adapter
for the action pipeline (adapters → staged enrichment with
:class:`AuthorHydrator` → the recos-injector's feeds).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.actions import enricher
from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.data.foryou_world import NOW
from the_algorithm_tpu_torch.graph import graphjet, realgraph
from the_algorithm_tpu_torch.mixers import follow_recommendations as frs
from the_algorithm_tpu_torch.mixers import frs_catalog as fc
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.pipeline.component import Candidate
from the_algorithm_tpu_torch.simclusters import sims_graph
from the_algorithm_tpu_torch.simclusters.known_for import Graph

LOCALES = ("en", "ja", "es", "pt")
FAV = realgraph.INTERACTION_TYPES.index("fav")


@dataclasses.dataclass(frozen=True)
class FrsShape:
    num_users: int = 16_384  # foryou_world.FULL's users
    num_authors: int = 4_096  # users 0..num_authors-1 are the authors
    follows: int = 48  # followed authors per user
    follow_width: int = 64  # follow lists padded to this
    follower_multiple: int = 32  # the follower adjacency's width rounds up to this
    sims_top_k: int = 64
    events_per_user: int = 16
    tweet_space: int = 1 << 15
    uug_width: int = 64
    realgraph_degree: int = 64
    realgraph_events: int = 65_536  # events folded into the RealGraph table (host fold)
    recent: int = 16  # a request's recent engagement ids
    geo_buckets: int = 16
    top_k: int = 40  # host tables' row width, and each device source's results
    walk_width: int = 20  # the offline two-hop walk's row
    promoted: int = 8
    unsafe: int = 64  # authors flagged unsafe
    blocked: int = 4  # blocked accounts a request carries


FULL = FrsShape()


@dataclasses.dataclass
class FrsRequest:
    """A who-to-follow request: what the catalog's sources and predicates read."""

    user_id: int
    followed_set: frozenset = frozenset()
    blocked_set: frozenset = frozenset()
    excluded_ids: frozenset = frozenset()
    recent_engagement_ids: tuple = ()
    geo_id: Optional[int] = None
    profile_user_id: Optional[int] = None
    locale: Optional[str] = None
    now: int = NOW


# kernel launches of one call of each device source, (row_gather, run_collapse):
# a sims / triangular hop is one row fetch, SALSA and the sims expansion two,
# each source one dedup; RealGraph's top edges one row fetch; the UUG one of each
SOURCE_LAUNCHES = {"sims": (1, 1), "sims_expansion": (2, 1), "triangular": (1, 1), "salsa": (2, 1),
                   "real_graph": (1, 0), "user_user_graph": (1, 1)}
SOURCE_NAMES = {"sims": "Sims", "sims_expansion": "SimsExpansion", "triangular": "TriangularLoops",
                "salsa": "Salsa"}


def expected_launches(names: Sequence[str]) -> Dict[str, int]:
    """The launches the sources ``names`` make for a user with follows
    (host sources none)."""
    rg = sum(SOURCE_LAUNCHES.get(n, (0, 0))[0] for n in names)
    rc = sum(SOURCE_LAUNCHES.get(n, (0, 0))[1] for n in names)
    return {"run_collapse": rc, "row_gather": rg}


def flow_launches(location: fc.DisplayLocation) -> Dict[str, int]:
    return expected_launches(fc.FlowCatalog.FLOW_SOURCES[location])


def draw_follows(shape: FrsShape, seed: int) -> np.ndarray:
    """[U, FW] int32: each user's follows, sorted, PAD_ID padded."""
    rng = np.random.default_rng(seed)
    out = np.full((shape.num_users, shape.follow_width), PAD_ID, np.int32)
    for u in range(shape.num_users):
        out[u, : shape.follows] = np.sort(rng.choice(shape.num_authors, shape.follows, False))
    return out


def follower_adjacency(follows: np.ndarray, num_authors: int, multiple: int) -> np.ndarray:
    """[A, D1] int32: each author's followers ascending, PAD_ID padded, D1 the
    largest in-degree rounded up to ``multiple``."""
    users = np.repeat(np.arange(follows.shape[0], dtype=np.int32), follows.shape[1])
    authors = follows.reshape(-1)
    keep = authors != PAD_ID
    users, authors = users[keep], authors[keep]
    order = np.argsort(authors, kind="stable")
    users, authors = users[order], authors[order]
    deg = np.bincount(authors, minlength=num_authors)
    width = max(multiple, -(-int(deg.max()) // multiple) * multiple)
    start = np.cumsum(deg) - deg
    slot = np.arange(authors.size) - start[authors]
    out = np.full((num_authors, width), PAD_ID, np.int32)
    out[authors, slot] = users
    return out


@dataclasses.dataclass
class FrsWorld:
    shape: FrsShape
    device: torch.device
    follows: np.ndarray  # [U, FW] int32
    followers: np.ndarray  # [A, D1] int32
    sims_ids: np.ndarray  # [A, K] int32 (host copy of the device graph)
    sims_weights: np.ndarray  # [A, K] float32
    ev_users: np.ndarray  # [E] int32, in event order
    ev_tweets: np.ndarray  # [E] int32
    ev_ts: np.ndarray  # [E] int32, ascending
    follow_adj: torch.Tensor  # [U, FW] on the device
    follower_adj: torch.Tensor  # [A, D1]
    sims: Graph
    uug: graphjet.UserUserGraph
    realgraph: realgraph.EdgeTable
    rg_params: Dict[str, torch.Tensor]
    geo_ids: np.ndarray  # [G, K]
    geo_scores: np.ndarray
    global_ids: np.ndarray  # [K]
    global_scores: np.ndarray
    ppmi: Dict[str, tuple]
    crowd: Dict[str, tuple]
    address_forward: Dict[int, List[int]]
    address_reverse: Dict[int, List[int]]
    promoted_ids: np.ndarray
    promoted_bids: np.ndarray
    walk_ids: np.ndarray  # [U, W]
    walk_scores: np.ndarray
    last_active: np.ndarray  # [A] int32
    unsafe: frozenset
    blocked: np.ndarray  # [U, blocked] int32

    def to(self, device) -> "FrsWorld":
        """The same world with its device tables on ``device``."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, device=dev, follow_adj=self.follow_adj.to(dev), follower_adj=self.follower_adj.to(dev),
            sims=self.sims.to(dev), uug=graphjet.UserUserGraph(*(t.to(dev) for t in self.uug)),
            realgraph=realgraph.EdgeTable(*(t.to(dev) for t in self.realgraph)),
            rg_params={k: v.detach().to(dev) for k, v in self.rg_params.items()})

    def author_of(self, tweet_ids):
        return np.asarray(tweet_ids, np.int64) % self.shape.num_authors

    def request(self, user_id: int) -> FrsRequest:
        """The world's request for ``user_id``."""
        u = int(user_id)
        f = self.follows[u]
        mine = self.ev_tweets[self.ev_users == u][-self.shape.recent:]
        return FrsRequest(
            user_id=u, followed_set=frozenset(int(a) for a in f[f != PAD_ID]),
            blocked_set=frozenset(int(b) for b in self.blocked[u]),
            recent_engagement_ids=tuple(int(t) for t in mine), geo_id=u % self.shape.geo_buckets,
            profile_user_id=(u * 7 + 3) % self.shape.num_authors, locale=LOCALES[u % len(LOCALES)], now=NOW)

    def followed_tensor(self, request) -> torch.Tensor:
        """[FW] int32 on the device: the request's follow set, sorted, PAD padded."""
        ids = sorted(int(a) for a in request.followed_set)[: self.shape.follow_width]
        out = np.full(self.shape.follow_width, PAD_ID, np.int32)
        out[: len(ids)] = ids
        return torch.from_numpy(out).to(self.device)

    def device_sources(self) -> Dict[str, Callable]:
        """The device sources as flow callables (request → candidates)."""
        k = self.shape.top_k

        def wrap(name, fn):
            return lambda r: fc._to_candidates(*fn(self.followed_tensor(r)), SOURCE_NAMES[name])

        return {
            "sims": wrap("sims", lambda f: frs.similar_producers_candidates(self.sims, f, k)),
            "sims_expansion": wrap("sims_expansion", lambda f: fc.sims_expansion_candidates(
                self.sims.nbr_ids, self.sims.nbr_weights, f, k)),
            "triangular": wrap("triangular", lambda f: frs.triangular_closure_candidates(self.follow_adj, f, k)),
            "salsa": wrap("salsa", lambda f: fc.salsa_candidates(self.follow_adj, self.follower_adj, f, k)),
            "real_graph": _getter(fc.RealGraphSource(self.realgraph, self.rg_params, k=k)),
            "user_user_graph": _getter(fc.UserUserGraphSource(self.uug, max_results=k)),
        }

    def host_sources(self) -> Dict[str, Callable]:
        """The host-table sources as flow callables."""
        follows = self.follows
        return {
            "recent_engagement": _getter(fc.RecentEngagementSource(self.author_of, max_results=self.shape.top_k)),
            "pop_geo": _getter(fc.PopGeoSource(self.geo_ids, self.geo_scores, self.global_ids, self.global_scores)),
            "stp": _getter(fc.StpSource(self.sims.nbr_ids, self.sims.nbr_weights)),
            "ppmi_locale": _getter(fc.PpmiLocaleSource(self.ppmi)),
            "address_book": _getter(fc.AddressBookSource(self.address_forward, self.address_reverse)),
            "crowd_search": _getter(fc.CrowdSearchAccountsSource(self.crowd)),
            "promoted_accounts": _getter(fc.PromotedAccountsSource(self.promoted_ids, self.promoted_bids)),
            "socialgraph": _getter(fc.SocialgraphSource(lambda u: follows[u][follows[u] != PAD_ID])),
            "two_hop_random_walk": _getter(fc.TwoHopRandomWalkSource(self.walk_ids, self.walk_scores)),
        }

    def catalog(self, store: Optional[fc.PreviouslyRecommendedStore] = None) -> fc.FlowCatalog:
        """Every source wired into a FlowCatalog with the predicate library
        and an ML ranker (:func:`follow_score`)."""
        store = store if store is not None else fc.PreviouslyRecommendedStore()
        return fc.FlowCatalog(
            sources_by_name={**self.device_sources(), **self.host_sources()},
            predicates=[frs.not_already_followed, frs.not_blocked, frs.not_self, fc.excluded_ids_predicate(),
                        fc.health_predicate(set(self.unsafe)), fc.inactive_predicate(self.last_active),
                        store.predicate()],
            ranker=fc.ml_ranker(follow_features, follow_score),
        )


def _getter(source) -> Callable:
    return lambda r: source.get(r, None)


def follow_features(request, candidates: List[Candidate]) -> np.ndarray:
    """[B, 3] ranker features: retrieval score, social proof, promoted flag."""
    return np.asarray([[c.features.get("retrieval_score", 0.0), c.features.get("social_proof", 0.0),
                        c.features.get("is_promoted", 0.0)] for c in candidates], np.float32)


FOLLOW_WEIGHTS = np.asarray([2.0, 0.5, -1.0], np.float32)


def follow_score(feats: np.ndarray) -> np.ndarray:
    """p(follow): a logistic model over :func:`follow_features` (numpy, f32)."""
    z = np.log1p(np.abs(feats)) * np.sign(feats) @ FOLLOW_WEIGHTS - np.float32(1.0)
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def _top_rows(counts: np.ndarray, k: int):
    """Each row's k largest counts, descending (lower id first among ties)."""
    order = np.argsort(-counts, axis=-1, kind="stable")[..., :k]
    return order.astype(np.int32), np.take_along_axis(counts, order, -1).astype(np.float32)


def build(shape: FrsShape = FULL, seed: int = 23, device=None) -> FrsWorld:
    """The world on ``device`` (default: the card)."""
    dev = resolve(device, "FrsWorld")
    s = shape
    follows = draw_follows(s, seed)
    followers = follower_adjacency(follows, s.num_authors, s.follower_multiple)
    rng = np.random.default_rng([seed, 1])
    n_ev = s.num_users * s.events_per_user
    ev_users = rng.integers(0, s.num_users, n_ev).astype(np.int32)
    ev_tweets = rng.integers(0, s.tweet_space, n_ev).astype(np.int32)
    ev_ts = np.sort(rng.integers(NOW - 86_400, NOW, n_ev)).astype(np.int32)
    authors = (ev_tweets % s.num_authors).astype(np.int32)

    follow_adj = torch.from_numpy(follows).to(dev)
    fm = sims_graph.follow_matrix_from_adjacency(follow_adj, s.num_authors)
    sims = sims_graph.symmetrize(sims_graph.cosine_similarity_graph(fm, top_k=s.sims_top_k))
    del fm
    uug = graphjet.record_user_user(graphjet.init_user_user(s.num_users, s.uug_width, device=dev),
                                    ev_users, authors, np.full(n_ev, FAV, np.int32), ev_ts)
    m = min(n_ev, s.realgraph_events)
    table = realgraph.apply_interactions(realgraph.init_table(s.num_users, s.realgraph_degree, device=dev),
                                         ev_users[:m], authors[:m], np.full(m, FAV, np.int32), ev_ts[:m])
    rg_params = realgraph.init_model(torch.Generator(device=dev).manual_seed(seed), device=dev)
    with torch.no_grad():  # a positive fav weight, so a stronger edge scores higher
        rg_params["w"][FAV] = 1.0

    # host tables
    geo = np.arange(s.num_users) % s.geo_buckets
    in_deg = np.zeros((s.geo_buckets, s.num_authors), np.float32)
    valid = follows != PAD_ID
    np.add.at(in_deg, (np.repeat(geo, follows.shape[1])[valid.reshape(-1)], follows[valid]), 1.0)
    geo_ids, geo_scores = _top_rows(in_deg, s.top_k)
    global_ids, global_scores = _top_rows(in_deg.sum(0), s.top_k)
    ppmi, crowd = {}, {"global": (global_ids[: s.top_k // 2], global_scores[: s.top_k // 2])}
    for loc in LOCALES:
        ids = np.sort(rng.choice(s.num_authors, s.top_k, False)).astype(np.int32)
        ppmi[loc] = (ids, np.sort(rng.random(s.top_k).astype(np.float32))[::-1].copy())
        crowd[loc] = (rng.choice(s.num_authors, s.top_k // 2, False).astype(np.int32),
                      np.sort(rng.random(s.top_k // 2).astype(np.float32))[::-1].copy())
    book_users = rng.choice(s.num_users, s.num_users // 8, False)
    forward = {int(u): [int(a) for a in rng.choice(s.num_authors, 8, False)] for u in book_users}
    reverse: Dict[int, List[int]] = {}
    for u, contacts in forward.items():
        for a in contacts:
            reverse.setdefault(a, []).append(u)
    walk_ids = rng.integers(0, s.num_authors, (s.num_users, s.walk_width)).astype(np.int32)
    walk_scores = np.sort(rng.random((s.num_users, s.walk_width)).astype(np.float32), axis=1)[:, ::-1].copy()
    return FrsWorld(
        shape=s, device=dev, follows=follows, followers=followers,
        sims_ids=sims.nbr_ids.cpu().numpy(), sims_weights=sims.nbr_weights.cpu().numpy(),
        ev_users=ev_users, ev_tweets=ev_tweets, ev_ts=ev_ts,
        follow_adj=follow_adj, follower_adj=torch.from_numpy(followers).to(dev), sims=sims, uug=uug,
        realgraph=table, rg_params=rg_params, geo_ids=geo_ids, geo_scores=geo_scores,
        global_ids=global_ids, global_scores=global_scores, ppmi=ppmi, crowd=crowd,
        address_forward=forward, address_reverse=reverse,
        promoted_ids=rng.choice(s.num_authors, s.promoted, False).astype(np.int32),
        promoted_bids=rng.random(s.promoted).astype(np.float32),
        walk_ids=walk_ids, walk_scores=walk_scores,
        last_active=np.where(rng.random(s.num_authors) < 0.02, NOW - 60 * 86400,
                             NOW - rng.integers(0, 86400, s.num_authors)).astype(np.int32),
        unsafe=frozenset(int(a) for a in rng.choice(s.num_authors, s.unsafe, False)),
        blocked=rng.integers(0, s.num_authors, (s.num_users, s.blocked)).astype(np.int32),
    )


# -- the action stream: raw events for every UUA adapter ---------------------------

ENRICH_PLAN = enricher.Plan((
    enricher.Stage(enricher.StageType.REPARTITION, ("REPARTITION_TWEET_ID",)),
    enricher.Stage(enricher.StageType.HYDRATION, ("HYDRATE_AUTHOR",)),
))


class AuthorHydrator(enricher.Hydrator):
    """Fills a tweet action's missing author (the tweet id mod the authors,
    as the world draws them), keyed by the repartitioned tweet id; an action
    on a tweet id past ``tweet_space`` is left un-hydrated (tolerated)."""

    def __init__(self, num_authors: int, tweet_space: int):
        self.num_authors, self.tweet_space = num_authors, tweet_space

    def hydrate(self, instruction, key, envelope):
        a = envelope.action
        if key is None or key.key_type != "tweet" or a.author_id is not None or a.item_id >= self.tweet_space:
            return envelope
        envelope.action = dataclasses.replace(a, author_id=int(a.item_id) % self.num_authors)
        return envelope


def raw_events(seed: int, n: int, shape: FrsShape = FULL, now_ms: int = NOW * 1000) -> List[tuple]:
    """``n`` seeded (source, raw event) pairs spread over every UUA adapter,
    some of each kind malformed or unknown (the adapters drop those);
    timestamps on a 1-second grid over the last hour, so many tie."""
    rng = np.random.default_rng([seed, 2])
    U, A, TS = shape.num_users, shape.num_authors, shape.tweet_space
    kinds = ("client_event", "behavioral_client_event", "tls_favs", "social_graph", "tweetypie_event",
             "ads_callback", "email_notification", "favorite_archival", "retweet_archival", "user_modification",
             "interaction_events", "video_client_event")
    client = (("tweet", "favorite"), ("tweet", "retweet"), ("tweet", "reply"), ("tweet", "quote"),
              ("tweet", "click"), ("tweet", "impression"), ("profile", "visit"), ("user", "follow"),
              ("tweet", "hover"))
    behavioral = (("tweet", "bookmark"), ("tweet", "share"), ("tweet", "linger"), ("video", "quality_view"))
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        u, t, a = int(rng.integers(0, U)), int(rng.integers(0, TS)), int(rng.integers(0, A))
        ts = int(now_ms - 1000 * rng.integers(0, 3600))
        author = t % A if rng.random() < 0.5 else None
        r = rng.random()
        if kind in ("client_event", "behavioral_client_event"):
            item_type, action = (client if kind == "client_event" else behavioral)[int(rng.integers(
                0, len(client) if kind == "client_event" else len(behavioral)))]
            item = a if item_type in ("profile", "user") else t
            ev = {"user_id": u, "item_type": item_type, "action": action, "item_id": item, "ts_ms": ts}
            if author is not None and item_type in ("tweet", "video"):
                ev["author_id"] = author
            if r < 0.2:
                ev["surface"], ev["search_details"] = "search", {"query": f"q{t % 50}", "rank": int(r * 50)}
            elif r < 0.35:
                ev["topic_id"], ev["topic_ids"] = t % 97, [t % 89, t % 83]
        elif kind == "tls_favs":
            ev = {"fav_type": "fav" if r < 0.8 else ("unfav" if r < 0.95 else "meh"), "user_id": u,
                  "tweet_id": t, "ts_ms": ts}
            if author is not None:
                ev["author_id"] = author
        elif kind == "social_graph":
            ev = {"op": ("follow", "unfollow", "block", "mute", "poke")[int(r * 5)], "source_id": u,
                  "target_id": a, "ts_ms": ts}
        elif kind == "tweetypie_event":
            tweet = {"user_id": u, "tweet_id": TS + i}
            shape_r = rng.random()
            if shape_r < 0.25:
                tweet.update(in_reply_to_status_id=t, in_reply_to_user_id=t % A)
            elif shape_r < 0.5:
                tweet.update(share_source_tweet_id=t, share_source_user_id=t % A)
            elif shape_r < 0.6:
                tweet.update(quoted_tweet_id=t)
            elif shape_r < 0.65:
                tweet.update(in_reply_to_status_id=t, share_source_tweet_id=t)  # contradictory: dropped
            ev = {"event": "create" if r < 0.85 else "delete", "ts_ms": ts, "tweet": tweet}
        elif kind == "ads_callback":
            engs = ("fav", "click", "follow", "report", "video_playback_50", "nope")
            eng = engs[int(r * len(engs))]
            ev = {"engagement_type": eng, "user_id": u, "ts_ms": ts}
            if eng == "follow":
                ev["profile_id"] = a
            else:
                ev.update(tweet_id=t, author_id=t % A)
        elif kind == "email_notification":
            ev = {"type": "click" if r < 0.8 else "open", "user_id": u, "ts_ms": ts,
                  "path": f"/i/status/{t}" + ("?s=1" if r < 0.2 else ""), "impression_id": i if r < 0.9 else None}
        elif kind == "favorite_archival":
            ev = {"favoriter_id": u, "tweet_id": t, "ts_ms": ts, "tweet_user_id": t % A,
                  "is_archiving_action": None if r < 0.5 else bool(r < 0.75)}
        elif kind == "retweet_archival":
            ev = {"retweet_user_id": u, "src_tweet_id": t, "retweet_id": TS + i, "ts_ms": ts,
                  "src_tweet_user_id": t % A}
        elif kind == "user_modification":
            ev = {"user_id": u, "ts_ms": ts}
            if r < 0.4:
                ev["create"] = {}
            elif r < 0.8:
                ev["update"] = ["name", "bio"][: 1 + int(r * 10) % 2]
        elif kind == "interaction_events":
            ev = {"interaction_type": "impression" if r < 0.9 else "click", "user_id": u, "tweet_id": t,
                  "ts_ms": ts, "author_id": t % A, "surface": "home"}
        else:
            ev = {"user_id": u, "tweet_id": t, "ts_ms": ts, "video_id": t * 3,
                  "playback_percentage": (25, 50, 75, 95, 10)[int(r * 5)]}
            if r > 0.9:
                ev["quality_view"] = True
        out.append((kind, ev))
    return out
