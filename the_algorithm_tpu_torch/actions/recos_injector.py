"""Recos-injector: route cleaned user actions into per-consumer feeds.

Counterpart of ``the_algorithm_tpu/actions/recos_injector.py``, copied:
``EngagementType`` from the port's ``graph/uteg``, ``INTERACTION_TYPES``
from its ``graph/realgraph``; the stable sort by timestamp keeps ties in
input order.

≡ ``recos-injector/`` (README:1-8): a Kafka preprocessor filtering/cleaning
fav/retweet/follow/client events into per-GraphJet-service topics (UTEG,
UTG, UVG) — and here also into the SimClusters fav stream and RealGraph
interaction stream. One normalized UUA stream in, typed numpy batches out —
the host-side feed for the device-resident graph/index update programs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from the_algorithm_tpu_torch.actions.uua import ActionType, UnifiedUserAction
from the_algorithm_tpu_torch.graph.uteg import EngagementType
from the_algorithm_tpu_torch.graph.realgraph import INTERACTION_TYPES

_UTEG_MAP = {
    ActionType.CLIENT_TWEET_FAV: EngagementType.FAVORITE,
    ActionType.SERVER_TWEET_FAV: EngagementType.FAVORITE,
    ActionType.CLIENT_TWEET_RETWEET: EngagementType.RETWEET,
    ActionType.CLIENT_TWEET_REPLY: EngagementType.REPLY,
    ActionType.CLIENT_TWEET_QUOTE: EngagementType.QUOTE,
    ActionType.CLIENT_TWEET_CLICK: EngagementType.CLICK,
}

_REALGRAPH_MAP = {
    ActionType.CLIENT_TWEET_FAV: "fav",
    ActionType.SERVER_TWEET_FAV: "fav",
    ActionType.CLIENT_TWEET_RETWEET: "retweet",
    ActionType.CLIENT_TWEET_REPLY: "reply",
    ActionType.CLIENT_PROFILE_VISIT: "profile_view",
    ActionType.CLIENT_TWEET_CLICK: "tweet_click",
    ActionType.CLIENT_FOLLOW: "follow",
    ActionType.SERVER_FOLLOW: "follow",
}


@dataclasses.dataclass
class Feeds:
    """Typed batches for each downstream consumer (all time-ordered)."""

    uteg: Dict[str, np.ndarray]  # user_ids, tweet_ids, types, timestamps
    simclusters_favs: Dict[str, np.ndarray]  # user_ids, tweet_ids, timestamps
    realgraph: Dict[str, np.ndarray]  # src, dst, interaction_type, timestamps


def route(actions: Sequence[UnifiedUserAction]) -> Feeds:
    """Filter/clean the stream into consumer feeds.

    Cleaning: drops actions with missing ids; drops self-engagements for the
    SimClusters fav feed (the TweetJob filter happens again device-side, but
    the injector pre-filters like the reference does); orders by timestamp.
    """
    ordered = sorted(actions, key=lambda a: a.timestamp_ms)

    ut_u, ut_t, ut_ty, ut_ts = [], [], [], []
    sc_u, sc_t, sc_ts = [], [], []
    rg_s, rg_d, rg_ty, rg_ts = [], [], [], []

    for a in ordered:
        if a.action_type in _UTEG_MAP:
            ut_u.append(a.user_id)
            ut_t.append(a.item_id)
            ut_ty.append(int(_UTEG_MAP[a.action_type]))
            ut_ts.append(a.timestamp_ms // 1000)
        if a.action_type in (ActionType.CLIENT_TWEET_FAV, ActionType.SERVER_TWEET_FAV):
            if a.author_id is None or a.author_id != a.user_id:
                sc_u.append(a.user_id)
                sc_t.append(a.item_id)
                sc_ts.append(a.timestamp_ms // 1000)
        if a.action_type in _REALGRAPH_MAP:
            dst = a.author_id if a.action_type not in (
                ActionType.CLIENT_FOLLOW, ActionType.SERVER_FOLLOW,
                ActionType.CLIENT_PROFILE_VISIT,
            ) else a.item_id
            if dst is not None and dst != a.user_id:
                rg_s.append(a.user_id)
                rg_d.append(int(dst))
                rg_ty.append(INTERACTION_TYPES.index(_REALGRAPH_MAP[a.action_type]))
                rg_ts.append(a.timestamp_ms // 1000)

    i32 = lambda x: np.asarray(x, np.int32)
    return Feeds(
        uteg={
            "user_ids": i32(ut_u), "tweet_ids": i32(ut_t),
            "types": i32(ut_ty), "timestamps": i32(ut_ts),
        },
        simclusters_favs={
            "user_ids": i32(sc_u), "tweet_ids": i32(sc_t), "timestamps": i32(sc_ts),
        },
        realgraph={
            "src": i32(rg_s), "dst": i32(rg_d),
            "interaction_type": i32(rg_ty), "timestamps": i32(rg_ts),
        },
    )
