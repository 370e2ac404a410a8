"""User Signal Service (USS): centralized engagement-signal store.

Counterpart of ``the_algorithm_tpu/features/user_signals.py``
(``user-signal-service/``, ``RETREIVAL_SIGNALS.md:7-27``): one fetch surface
for explicit and implicit engagement signals, each a (target id, timestamp)
stream per user. Signals live in fixed-width per-user tables ([U, S, W]
target ids and timestamps per signal type, newest first); :func:`record` is
the host feed (a per-event numpy loop, as in the JAX package, uploaded
once), :func:`fetch` gathers and time-filters on the tables' device.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops.gather import jax_rows
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


class SignalType(enum.IntEnum):
    """≡ RETREIVAL_SIGNALS.md signal inventory (17 types)."""

    ACCOUNT_FOLLOW = 0
    REPEATED_PROFILE_VISIT = 1
    TWEET_FAVORITE = 2
    RETWEET = 3
    REPLY = 4
    TWEET_SHARE = 5
    TWEET_BOOKMARK = 6
    ORIGINAL_TWEET = 7
    TWEET_CLICK = 8
    TWEET_VIDEO_OPEN = 9
    TWEET_VIDEO_QUALITY_VIEW = 10
    NOTIFICATION_OPEN = 11
    PROFILE_CLICK = 12
    ACCOUNT_MUTE = 13
    ACCOUNT_BLOCK = 14
    TWEET_REPORT = 15
    TWEET_DONT_LIKE = 16


NEGATIVE_SIGNALS = {
    SignalType.ACCOUNT_MUTE,
    SignalType.ACCOUNT_BLOCK,
    SignalType.TWEET_REPORT,
    SignalType.TWEET_DONT_LIKE,
}


class SignalStore(NamedTuple):
    """[U, S, W] ring-buffered signals: newest-first per (user, signal)."""

    target_ids: torch.Tensor  # int32, PAD_ID padded
    timestamps: torch.Tensor  # int32

    @property
    def width(self) -> int:
        return self.target_ids.shape[2]


def init_store(num_users: int, width: int = 64, device=None) -> SignalStore:
    """An empty store on ``device`` (default: the card)."""
    dev = resolve(device, "SignalStore")
    shape = (num_users, len(SignalType), width)
    return SignalStore(torch.full(shape, PAD_ID, dtype=torch.int32, device=dev),
                       torch.zeros(shape, dtype=torch.int32, device=dev))


def record(
    store: SignalStore,
    user_ids: np.ndarray,
    signal_types: np.ndarray,
    target_ids: np.ndarray,
    timestamps: np.ndarray,
) -> SignalStore:
    """Host-side batch append (newest-first shift), events in time order; the
    result goes back to the store's device."""
    tids = store.target_ids.cpu().numpy().copy()
    ts = store.timestamps.cpu().numpy().copy()
    for u, s, t, tm in zip(user_ids, signal_types, target_ids, timestamps):
        tids[u, s, 1:] = tids[u, s, :-1]
        ts[u, s, 1:] = ts[u, s, :-1]
        tids[u, s, 0] = t
        ts[u, s, 0] = tm
    dev = store.target_ids.device
    return SignalStore(torch.from_numpy(tids).to(dev), torch.from_numpy(ts).to(dev))


def fetch(
    store: SignalStore,
    user_id,
    signal_type: SignalType,
    *,
    min_timestamp=None,
):
    """(target_ids[W], timestamps[W], valid[W]) for one user+signal. A user id
    outside [0, U) reads the row a JAX gather reads (:func:`jax_rows`)."""
    u = jax_rows(torch.as_tensor(user_id, device=store.target_ids.device), store.target_ids.shape[0])
    ids = store.target_ids[u, int(signal_type)]
    ts = store.timestamps[u, int(signal_type)]
    valid = ids != PAD_ID
    if min_timestamp is not None:
        valid = valid & (ts >= min_timestamp)
    return ids, ts, valid


def fetch_engagement_tweets(
    store: SignalStore,
    user_id,
    signal_types: Sequence[SignalType],
    min_timestamp: Optional[int] = None,
):
    """Concatenated positive tweet engagements — RSX's USS fetch
    (``twistlyfeatures/UserSignalServiceRecentEngagementsClient.scala``)."""
    parts = [fetch(store, user_id, st, min_timestamp=min_timestamp) for st in signal_types]
    types = [torch.full_like(ids, int(st)) for (ids, _, _), st in zip(parts, signal_types)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]), torch.cat(types))
