"""Production aggregation-config catalog (offline + realtime groups).

≡ ``src/scala/com/twitter/timelines/prediction/common/aggregates/
TimelinesAggregationConfigDetails.scala`` (25 AggregateGroups, 579 LoC) and
``real_time/TimelinesOnlineAggregationConfigBase.scala``: the concrete
(keys × features × labels × metrics × half-lives) cross-products the
heavy-ranker aggregate features are produced from, each with its
pre-transforms (in-network filter, user-id-zero removal) and store binding.

Here each :class:`AggregateConfig` wraps the framework's
:class:`~the_algorithm_tpu_torch.features.aggregation.AggregateGroup` with the
key schema and pre-transform; :func:`build_catalog` returns the full set
and :func:`init_stores` allocates their device stores.

The port of ``the_algorithm_tpu/features/aggregation_configs.py``: the
catalog, the pre-transforms and the host key resolution are copies; the
stores are tensors on the card unless :func:`init_stores` is given a
device, and :func:`apply_events` folds through the port's
:func:`~the_algorithm_tpu_torch.features.aggregation.update` with the
batch's columns moved to the store's device. Rows are allocated in the
order the kept events arrive, as the JAX package allocates them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.features import aggregation

DAY = 86400.0

# engagement label sets (≡ RecapUserFeatureAggregation.LabelsV2 / ...)
LABELS_V2 = (
    "is_favorited", "is_retweeted", "is_replied", "is_clicked",
    "is_profile_clicked", "is_video_playback_50", "is_photo_expanded",
    "is_open_linked", "is_bookmarked", "is_shared",
)
NEGATIVE_LABELS = ("is_report_tweet_clicked", "is_dont_like", "is_block_clicked")
CONTINUOUS_FEATURES = ("engagement",)  # one continuous input per event


@dataclasses.dataclass(frozen=True)
class AggregateConfig:
    """One TimelinesAggregationConfig entry."""

    name: str
    keys: Tuple[str, ...]  # e.g. ("user",), ("user", "author")
    group: aggregation.AggregateGroup
    realtime: bool = False  # Heron realtime vs daily-batch Scalding
    # pre-transform: row mask over an event batch (None = keep all)
    pre_transform: Optional[Callable[[Mapping[str, np.ndarray]], np.ndarray]] = None

    @property
    def n_outputs(self) -> int:
        return self.group.n_outputs


# pre-transforms (≡ preTransforms = Seq(FilterInNetworkTransform,
# RichRemoveUserIdZero, FilterOutNetworkTransform...))


def remove_user_id_zero(batch: Mapping[str, np.ndarray]) -> np.ndarray:
    return np.asarray(batch["user_id"]) != 0


def filter_in_network(batch: Mapping[str, np.ndarray]) -> np.ndarray:
    return np.asarray(batch["is_in_network"]).astype(bool) & \
        remove_user_id_zero(batch)


def filter_out_of_network(batch: Mapping[str, np.ndarray]) -> np.ndarray:
    return ~np.asarray(batch["is_in_network"]).astype(bool) & \
        remove_user_id_zero(batch)


def _group(name, labels, metrics, half_lives) -> aggregation.AggregateGroup:
    return aggregation.AggregateGroup(
        name=name, features=CONTINUOUS_FEATURES, labels=tuple(labels),
        metrics=tuple(metrics), half_lives_s=tuple(half_lives),
    )


def build_catalog() -> List[AggregateConfig]:
    """The production group set. Rough ↔ reference mapping:

    - user_aggregate_v2 / v5.continuous     → user_* entries
    - user_author_aggregate_v2/v5           → user_author_* (in-network)
    - user_engager / user_mention / user_original_author aggregates
    - author_aggregate (aggregates_v1 author rollup)
    - tweet_aggregate (realtime tweet counts)
    - user_topic / user_list aggregates
    - user_request_context (dow/hour conditioning)
    - realtime variants with 30m half-life (OnlineAggregationConfig)
    """
    C = AggregateConfig
    out = [
        # -- offline daily (50-day half-life) --------------------------------
        C("user_aggregate_v2", ("user",),
          _group("user_aggregate_v2", LABELS_V2, ("count", "sum"), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_aggregate_v5_continuous", ("user",),
          _group("user_aggregate_v5.continuous", LABELS_V2,
                 ("count", "sum", "sumsq"), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_negative_aggregate", ("user",),
          _group("user_negative_aggregate", NEGATIVE_LABELS,
                 ("count",), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_author_aggregate_v2", ("user", "author"),
          _group("user_author_aggregate_v2", LABELS_V2, ("sum",), (50 * DAY,)),
          pre_transform=filter_in_network),
        C("user_author_aggregate_v2_count", ("user", "author"),
          _group("user_author_aggregate_v2c", LABELS_V2, ("count",),
                 (50 * DAY,)),
          pre_transform=filter_in_network),
        C("user_author_aggregate_oon", ("user", "author"),
          _group("user_author_aggregate_oon", LABELS_V2, ("count",),
                 (50 * DAY,)),
          pre_transform=filter_out_of_network),
        C("author_aggregate", ("author",),
          _group("author_aggregate", LABELS_V2, ("count", "sum"), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_engager_aggregate", ("user", "engager"),
          _group("user_engager_aggregate", LABELS_V2, ("count",), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_mention_aggregate", ("user", "mentioned_user"),
          _group("user_mention_aggregate", LABELS_V2, ("count",), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_original_author_aggregate", ("user", "original_author"),
          _group("user_original_author_aggregate", LABELS_V2, ("count",),
                 (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_topic_aggregate", ("user", "topic"),
          _group("user_topic_aggregate", LABELS_V2, ("count",), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_list_aggregate", ("user", "list"),
          _group("user_list_aggregate", LABELS_V2, ("count",), (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_request_dow_aggregate", ("user", "day_of_week"),
          _group("user_request_dow_aggregate", LABELS_V2, ("count",),
                 (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        C("user_request_hour_aggregate", ("user", "hour_of_day"),
          _group("user_request_hour_aggregate", LABELS_V2, ("count",),
                 (50 * DAY,)),
          pre_transform=remove_user_id_zero),
        # -- realtime (Heron) 30m/1d/7d half-lives ----------------------------
        C("tweet_aggregate_realtime", ("tweet",),
          _group("tweet_aggregate_rt", LABELS_V2, ("count",),
                 (1800.0, DAY, 7 * DAY)),
          realtime=True),
        C("user_aggregate_realtime", ("user",),
          _group("user_aggregate_rt", LABELS_V2, ("count",),
                 (1800.0, DAY)),
          realtime=True, pre_transform=remove_user_id_zero),
        C("author_aggregate_realtime", ("author",),
          _group("author_aggregate_rt", LABELS_V2, ("count",),
                 (1800.0, DAY)),
          realtime=True),
        C("user_author_aggregate_realtime", ("user", "author"),
          _group("user_author_aggregate_rt", LABELS_V2, ("count",),
                 (1800.0,)),
          realtime=True, pre_transform=filter_in_network),
    ]
    return out


def init_stores(
    configs: Sequence[AggregateConfig], capacity: int, device=None
) -> Dict[str, Tuple[aggregation.AggregateStore, aggregation.KeyResolver]]:
    """Allocate per-config device stores (on ``device``; default: the card)
    + key resolvers."""
    return {
        c.name: (aggregation.init_store(c.group, capacity, device=device),
                 aggregation.KeyResolver(capacity))
        for c in configs
    }


def apply_events(
    config: AggregateConfig,
    store: aggregation.AggregateStore,
    resolver: aggregation.KeyResolver,
    batch: Mapping[str, np.ndarray],
) -> aggregation.AggregateStore:
    """Fold one event batch through the config's pre-transform + key
    extraction into its store (the Scalding daily job / Heron bolt body).

    ``batch`` needs per-key columns (e.g. ``user_id``/``author_id``), the
    label columns in group order, ``engagement`` values, and ``timestamp``.
    """
    keep = (config.pre_transform(batch) if config.pre_transform is not None
            else np.ones(len(batch["timestamp"]), bool))
    if not keep.any():
        return store
    key_cols = [
        np.asarray(batch[k] if k in batch else batch[f"{k}_id"])
        for k in config.keys
    ]
    keys = [tuple(int(col[i]) for col in key_cols)
            for i in np.flatnonzero(keep)]
    rows = resolver.resolve(keys)
    labels = np.stack(
        [np.asarray(batch[l])[keep] for l in config.group.labels], axis=1
    ).astype(np.float32)
    feats = np.asarray(batch["engagement"])[keep].astype(np.float32)[:, None]
    ts = np.asarray(batch["timestamp"])[keep].astype(np.int32)
    dev = store.values.device
    return aggregation.update(
        config.group, store, torch.from_numpy(rows).to(dev), torch.from_numpy(feats).to(dev),
        torch.from_numpy(np.ascontiguousarray(labels)).to(dev), torch.from_numpy(ts).to(dev),
    )
