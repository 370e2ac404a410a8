"""The wide-schema aggregate spec and the seeded hydration world.

Counterpart of ``the_algorithm_tpu/mixers/wide_hydrators.py``:
:func:`make_aggregate_group` and :func:`synthetic_world` with its device
spec (the arrays and formulas ``device_hydration.build_from_world`` needs).
The host columnar hydrators of that module come later.

:func:`synthetic_world` draws from one numpy generator in exactly the JAX
package's order, so the same seed gives the same numbers; the folds it runs
on them (aggregate stores, RealGraph, USS) are the port's own.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.features import aggregation, graph_features, user_signals
from the_algorithm_tpu_torch.features import representation_scorer as rsx
from the_algorithm_tpu_torch.graph import realgraph
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.ops.sparse import PAD_ID


def make_aggregate_group(name: str) -> aggregation.AggregateGroup:
    """The wide-schema rollup spec: engagement value × 15 labels ×
    (count, sum, sumsq, max) × 4 half-lives (mean is derived at hydration)."""
    return aggregation.AggregateGroup(
        name=name,
        features=("engagement",),
        labels=fs.ENGAGEMENT_LABELS,
        metrics=("count", "sum", "sumsq", "max"),
        half_lives_s=fs.AGG_HALFLIVES_S,
    )


def synthetic_world(
    seed: int = 0,
    *,
    num_users: int = 64,
    num_authors: int = 64,
    num_tweets: int = 1 << 14,
    realgraph_degree: int = 16,
    num_clusters: int = 256,
    clusters_per_tweet: int = 8,
    engagement_width: int = 16,
    gfs_degree: int = 8,
    now: int = 10_000_000,
    device=None,
) -> Dict:
    """The JAX package's ``synthetic_world(..., include_device_spec=True)``:
    every table seeded deterministically, as tensors on ``device`` (default:
    the card), with its ``"device_spec"`` entry (the doc table, the
    engagement history and the torch twins of the host formulas). The JAX
    world's host closures (``doc_fn``, ``tweet_embedding_fn``, …) belong to
    the host hydrators and are left out.
    """
    dev = resolve(device, "synthetic_world")
    rng = np.random.default_rng(seed)

    def on(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    # earlybird doc features: deterministic, no rng draws
    n_doc = len(fs.EB_DOC_FEATURES)
    doc_table = np.sin(
        0.001 * np.arange(num_tweets, dtype=np.float64)[:, None]
        * np.arange(1, n_doc + 1, dtype=np.float64)[None, :]
    ).astype(np.float32)

    # realgraph: every user interacts with a few authors
    n_ev = num_users * 4
    src = rng.integers(0, num_users, n_ev).astype(np.int32)
    dst = rng.integers(0, num_authors, n_ev).astype(np.int32)
    itype = rng.integers(0, len(realgraph.INTERACTION_TYPES), n_ev).astype(np.int32)
    ts = np.sort(rng.integers(now - 30 * 86400, now, n_ev)).astype(np.int32)
    rg_table = realgraph.apply_interactions(realgraph.init_table(num_users, realgraph_degree, dev),
                                            src, dst, itype, ts)
    rg_params = {
        "w": on(rng.normal(0, 0.1, len(realgraph.INTERACTION_TYPES)), np.float32),
        "b": torch.zeros((), dtype=torch.float32, device=dev),
    }

    eng_ids = rng.integers(0, num_tweets, (num_users, engagement_width))
    eng_types = rng.integers(0, len(rsx.SIGNAL_TYPES), (num_users, engagement_width))
    eng_ts = rng.integers(now - 6 * 86400, now, (num_users, engagement_width))

    def table(n, k):
        return on(rng.normal(0, 1, (n, k)), np.float32)

    def agg_fixture(prefix: str, n_keys: int, key_fn=None):
        group = make_aggregate_group(prefix)
        store = aggregation.init_store(group, capacity=n_keys + 8, device=dev)
        resolver = aggregation.KeyResolver(capacity=n_keys + 8)
        B = n_keys * 2
        if key_fn is None:
            keys = [(int(k),) for k in rng.integers(0, n_keys, B)]
        else:
            keys = [key_fn(i) for i in range(B)]
        rows = resolver.resolve(keys)
        fv = rng.random((B, 1)).astype(np.float32)
        lv = (rng.random((B, len(fs.ENGAGEMENT_LABELS))) < 0.3).astype(np.float32)
        ets = np.sort(rng.integers(now - 10 * 86400, now, B)).astype(np.int32)
        store = aggregation.update(group, store, on(rows), on(fv), on(lv), on(ets))
        return store, resolver

    sig_store = user_signals.init_store(num_users, width=8, device=dev)
    n_sig = num_users * 3
    sig_store = user_signals.record(
        sig_store,
        rng.integers(0, num_users, n_sig),
        rng.integers(0, len(user_signals.SignalType), n_sig),
        rng.integers(0, num_tweets, n_sig),
        np.sort(rng.integers(now - 80 * 86400, now, n_sig)),
    )

    E = len(graph_features.EdgeType)
    nbrs = np.full((E, num_users, gfs_degree), PAD_ID, np.int32)
    for e in range(E):
        for u in range(num_users):
            deg = int(rng.integers(1, gfs_degree))
            nbrs[e, u, :deg] = np.sort(rng.choice(num_users, size=deg, replace=False))
    gfs_tables = graph_features.GraphTables(on(nbrs))

    meta = np.stack(
        [
            np.log1p(rng.integers(0, 1_000_000, num_authors)),
            np.log1p(rng.integers(0, 5_000, num_authors)),
            rng.integers(0, 5000, num_authors).astype(np.float32),
            (rng.random(num_authors) < 0.1).astype(np.float32),
        ],
        axis=1,
    ).astype(np.float32)

    # pair/keyed crosses: bounded key pools so fixtures stay small
    def _pair_pool(second_max):
        pool = [(int(rng.integers(0, num_users)), int(rng.integers(0, second_max))) for _ in range(24)]
        return lambda i: pool[i % len(pool)]

    def _single_pool(second_max):
        pool = [(int(rng.integers(0, second_max)),) for _ in range(24)]
        return lambda i: pool[i % len(pool)]

    # the dict literals below draw in the JAX package's order: each entry's
    # key pool, then its fold; then the tables of the world dict in order
    pair_aggs = {
        "user_author_agg": agg_fixture("user_author_agg", 32, _pair_pool(num_authors)),
        "user_author_oon_agg": agg_fixture("user_author_oon_agg", 32, _pair_pool(num_authors)),
        "user_engager_agg": agg_fixture("user_engager_agg", 32, _pair_pool(num_users)),
        "user_mention_agg": agg_fixture("user_mention_agg", 32, _pair_pool(num_users)),
        "user_original_author_agg": agg_fixture("user_original_author_agg", 32, _pair_pool(num_authors)),
        "user_topic_agg": agg_fixture("user_topic_agg", 32, _pair_pool(16)),
        "user_list_agg": agg_fixture("user_list_agg", 32, _pair_pool(4)),
        "user_dow_agg": agg_fixture("user_dow_agg", 32, _pair_pool(7)),
        "user_hour_agg": agg_fixture("user_hour_agg", 32, _pair_pool(24)),
        "author_topic_agg": agg_fixture(
            "author_topic_agg", 32,
            (lambda pool: lambda i: pool[i % len(pool)])([
                (int(rng.integers(0, num_authors)), int(rng.integers(0, 16))) for _ in range(24)])),
        "user_source_agg": agg_fixture("user_source_agg", 32, _pair_pool(1024)),
        "user_language_agg": agg_fixture("user_language_agg", 32, _pair_pool(8)),
        "user_media_agg": agg_fixture("user_media_agg", 32, _pair_pool(4)),
        "user_conversation_agg": agg_fixture("user_conversation_agg", 32, _pair_pool(num_tweets)),
        "topic_agg": agg_fixture("topic_agg", 32, _single_pool(16)),
    }

    K, C = clusters_per_tweet, num_clusters

    def tweet_emb_device(ids: torch.Tensor):
        """The synthetic tweet embedding, (cluster ids, scores) [..., K]: the
        JAX package's ``tweet_emb_device``, products in int32 as there (a
        PAD id's product wraps there and here alike). Clusters are unsorted
        and may repeat."""
        k = torch.arange(1, K + 1, dtype=torch.int32, device=ids.device)
        prod = torch.remainder(ids.to(torch.int32)[..., None] * k, C)
        cl = torch.remainder(prod * (2654435761 % C), C)
        sc = (1.0 / (1.0 + torch.arange(K, dtype=torch.float32, device=ids.device))).expand(prod.shape)
        return cl, sc

    def author_follows_viewer_dev(uid: torch.Tensor, authors: torch.Tensor) -> torch.Tensor:
        # twin of the host fixture's followers = range(0, num_authors, 7)
        return (authors >= 0) & (torch.remainder(authors, 7) == 0)

    device_spec = dict(
        doc_table=on(doc_table),
        eng_ids=on(eng_ids, np.int32),
        eng_types=on(eng_types, np.int32),
        eng_ts=on(eng_ts, np.int32),
        tweet_emb_device=tweet_emb_device,
        author_follows_viewer_device=author_follows_viewer_dev,
    )

    return dict(
        pair_aggs=pair_aggs,
        realgraph_table=rg_table,
        realgraph_params=rg_params,
        twhin_user=table(num_users, 64),
        twhin_author=table(num_authors, 64),
        twhin_tweet=table(num_tweets, 64),
        twhin_user_negative=table(num_users, 64),
        twhin_author_follow=table(num_authors, 64),
        user_interests_table=table(num_users, 128),
        author_agg_table=table(num_authors, 128),
        media_cluster_table=table(num_tweets, 64),
        text_embedding_table=table(num_tweets, 128),
        tweet_agg=agg_fixture("tweet_agg", min(num_tweets, 512)),
        author_agg=agg_fixture("author_agg", num_authors),
        user_agg=agg_fixture("user_agg", num_users),
        signal_store=sig_store,
        gfs_tables=gfs_tables,
        tweepcred=on(rng.integers(0, 100, num_authors), np.float32),
        author_meta=on(meta),
        device_spec=device_spec,
    )
