"""Tweet-mixer product configs: per-product pipeline subsets + params.

A host copy of ``the_algorithm_tpu/mixers/tweet_mixer_products.py``. ≡
``tweet-mixer/server/.../model/request/TweetMixerProduct.scala`` (9
products) + the per-product ProductPipelineConfigs: each product surface
(home, notifications, immersive video, related tweets, topic tweets, …)
routes to its own subset of the candidate-pipeline catalog with its own
result size and blending. :func:`run_product` is the product-pipeline entry:
resolve the product's spec names against a built catalog, router-gate them
by the query's signals/params, blend, truncate.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.mixers import candidate_pipeline_catalog as cat
from the_algorithm_tpu_torch.mixers.tweet_mixer import interleave_blend
from the_algorithm_tpu_torch.pipeline.component import Candidate


class TweetMixerProduct(enum.Enum):
    HOME_RECOMMENDED_TWEETS = "home_recommended_tweets"
    NOTIFICATIONS_RECOMMENDED_TWEETS = "notifications_recommended_tweets"
    IMV_RECOMMENDED_TWEETS = "imv_recommended_tweets"  # immersive video
    IMV_RELATED_TWEETS = "imv_related_tweets"
    TOPIC_TWEETS = "topic_tweets"
    RUX_RELATED_TWEETS = "rux_related_tweets"  # tweet-detail related
    VIDEO_RECOMMENDED_TWEETS = "video_recommended_tweets"
    LOGGED_OUT_VIDEO_RECOMMENDED_TWEETS = "logged_out_video"
    DEBUGGER_TWEETS = "debugger_tweets"


@dataclasses.dataclass(frozen=True)
class ProductSpec:
    """Which catalog pipelines a product runs, and its result budget."""

    product: TweetMixerProduct
    pipeline_names: Tuple[str, ...]  # names from catalog_specs()
    max_results: int
    needs_user: bool = True  # logged-out products skip consumer sources


# per-product pipeline subsets (≡ the product pipeline configs under
# tweet-mixer/server/.../product/; names reference catalog_specs())
PRODUCT_SPECS: Dict[TweetMixerProduct, ProductSpec] = {
    s.product: s for s in [
        ProductSpec(
            TweetMixerProduct.HOME_RECOMMENDED_TWEETS,
            ("simclusters_interested_in", "simclusters_tweet_based",
             "simclusters_producer_based", "twhin_consumer_based",
             "twhin_tweet_similarity", "deep_retrieval_user_tweet",
             "deep_retrieval_tweet_tweet", "uteg", "utg_tweet_based",
             "utg_expansion_tweet_based", "earlybird_in_network",
             "diffusion", "twhin_collab_filter", "consumers_based_utg",
             "producer_based_utg", "trip_geo_popular",
             "trip_domain_popular", "two_tower_consumer",
             "earlybird_model_based", "offline_simclusters_lookup"),
            max_results=400,
        ),
        ProductSpec(
            TweetMixerProduct.NOTIFICATIONS_RECOMMENDED_TWEETS,
            ("simclusters_interested_in", "twhin_consumer_based",
             "deep_retrieval_user_tweet", "uteg", "utg_producer_based",
             "earlybird_tensorflow_based"),
            max_results=100,
        ),
        ProductSpec(
            TweetMixerProduct.IMV_RECOMMENDED_TWEETS,
            ("uvg_tweet_based", "uvg_expansion_tweet_based",
             "media_deep_retrieval_user_tweet", "deep_retrieval_user_tweet"),
            max_results=100,
        ),
        ProductSpec(
            TweetMixerProduct.IMV_RELATED_TWEETS,
            ("uvg_tweet_based", "simclusters_tweet_based",
             "twhin_tweet_similarity", "deep_retrieval_tweet_tweet"),
            max_results=60,
            needs_user=False,
        ),
        ProductSpec(
            TweetMixerProduct.TOPIC_TWEETS,
            ("popular_topic_tweets", "skit_topic_tweets",
             "skit_high_precision_topic_tweets", "certo_topic_tweets"),
            max_results=100,
            needs_user=False,
        ),
        ProductSpec(
            TweetMixerProduct.RUX_RELATED_TWEETS,
            ("simclusters_tweet_based", "twhin_tweet_similarity",
             "utg_tweet_based", "qig_search_history_tweets",
             "deep_retrieval_tweet_tweet", "tweet_based_unified"),
            max_results=60,
            needs_user=False,
        ),
        ProductSpec(
            TweetMixerProduct.VIDEO_RECOMMENDED_TWEETS,
            ("uvg_tweet_based", "uvg_expansion_tweet_based",
             "media_deep_retrieval_user_tweet"),
            max_results=200,
        ),
        ProductSpec(
            TweetMixerProduct.LOGGED_OUT_VIDEO_RECOMMENDED_TWEETS,
            ("popular_geo_tweets", "trends_tweets"),
            max_results=100,
            needs_user=False,
        ),
        ProductSpec(
            TweetMixerProduct.DEBUGGER_TWEETS,
            tuple(),  # resolved dynamically: run EVERY built pipeline
            max_results=1000,
            needs_user=False,
        ),
    ]
}


def product_pipelines(
    catalog: Sequence[tuple],  # from cat.build_catalog(world)
    product: TweetMixerProduct,
    query,
    params: Params,
) -> List:
    """Resolve + route a product's pipelines (missing stores already
    dropped by build_catalog; the router re-checks signals and params)."""
    spec = PRODUCT_SPECS[product]
    if spec.needs_user and getattr(query, "user_id", None) is None:
        return []
    if spec.pipeline_names:
        subset = [(s, p) for s, p in catalog if s.name in spec.pipeline_names]
    else:  # debugger: everything that built
        subset = list(catalog)
    return cat.enabled_pipelines(subset, query, params)


def run_product(
    catalog: Sequence[tuple],
    product: TweetMixerProduct,
    query,
    params: Params = Params(),
) -> List[Candidate]:
    """Product entry: route → run each source (fail-open) → ranked
    interleave blend → truncate to the product budget."""
    spec = PRODUCT_SPECS[product]
    per_engine: List[List[Candidate]] = []
    for pipe in product_pipelines(catalog, product, query, params):
        try:
            per_engine.append(pipe.source.get(query, params))
        except Exception:
            per_engine.append([])
    return interleave_blend(per_engine, spec.max_results)
