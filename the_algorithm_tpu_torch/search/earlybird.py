"""Earlybird-equivalent realtime tweet index: ingest, match, score, top-K.

Counterpart of ``the_algorithm_tpu/search/earlybird.py``
(``src/java/com/twitter/search/earlybird/``). The index is a fixed-capacity
ring buffer of recent tweets held as dense tensors on the device — token ids
[T, L], author [T], timestamps [T], doc features [T, F] — and a query scans
all of it: equality masks, a feature-based score plus a BM25-style text
score, and a top-K.

The host half (schema tables, tokenizer, ingester document builder, query
parser) is a copy of the JAX module's; its tables are held equal to the
originals by a test. The device half runs on whatever device the index
lives on. Where the JAX package differs by design:

- ranking is exact and keeps ``lax.top_k``'s order among equal scores
  (:func:`~the_algorithm_tpu_torch.ops.retrieval.top_k`): there is no
  ``approx_max_k`` in torch, and on the CPU the JAX package ranks exactly too;
- the score is float32 throughout, as in the JAX package; its sums run in
  another order on each backend, so scores differ in the last bits, and
  docs whose scores lie that close may swap places;
- :func:`search_sharded` runs over the port's mesh layer (``core/mesh.py``:
  one process a rank, collectives over ``torch.distributed``) where the JAX
  package runs one program under ``shard_map``.

Behaviour kept from the JAX package on purpose: id-valued payloads of
``DOC_FEATURES`` are float32 (exact below 2**24); ``to_user_field`` and
``geo_hash_field`` map to approximate slots of :data:`FIELD_CATALOG`;
``lang:`` compares the language column truncated toward zero.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.core.hashing import murmur3_x64_128
from the_algorithm_tpu_torch.ops.retrieval import top_k
from the_algorithm_tpu_torch.ops.seg_scan import run_collapse_sorted
from the_algorithm_tpu_torch.ops.sparse import PAD_ID
from the_algorithm_tpu_torch.search import analyzer

INT32_MIN = -(2**31)


def tokenize(text: str, max_tokens: int, *, stemming: bool = False
             ) -> np.ndarray:
    """Text → stable int32 term ids via the full analysis chain
    (``search/analyzer.py``: unicode normalization, class-preserving
    hashtag/mention/URL/cashtag tokens, CJK bigrams, optional stemming —
    the ``search/common`` analyzer stack, replacing the r3 lowercase
    regex)."""
    return analyzer.token_ids(text, max_tokens, stemming=stemming)

# doc-feature schema — the Earlybird schema core (``common/schema/``,
# ThriftSearchResultFeatures / EarlybirdFieldConstants): 60 per-doc fields
# covering engagement counts (+v2/decayed variants), content flags, media
# breadth, text/language signals, author reputation + account state, URL
# and embed signals, health-model scores, and conversation structure.
# Count fields get log1p'd at scoring time.
DOC_FEATURES = (
    # engagement counters (+ the v2 decayed variants the schema carries)
    "fav_count", "reply_count", "retweet_count", "quote_count",
    "bookmark_count", "fav_count_v2", "reply_count_v2", "retweet_count_v2",
    "prev_user_tweet_engagement", "num_likes_root", "num_replies_root",
    "video_view_count", "embeds_impression_count", "embeds_url_count",
    # doc structure / time
    "created_ts", "tweet_age_hours", "conversation_depth", "is_self_thread",
    "is_reply", "is_retweet", "is_quote", "has_quote",
    # text / language
    "text_score", "word_count", "visible_token_ratio", "language_match",
    "link_language", "language_confidence", "num_hashtags", "num_mentions",
    "num_stocks", "has_multiple_hashtags_or_trends", "is_trend_tweet",
    # media / content breadth
    "has_image", "has_native_image", "has_video", "has_consumer_video",
    "has_pro_video", "has_card", "has_multiple_media",
    "is_composer_source_camera",
    # urls / embeds
    "has_url", "has_news_url", "has_expanded_url", "has_visible_link",
    # author reputation / state
    "user_rep", "from_verified_account", "from_blue_verified_account",
    "author_followers_log", "author_account_age_days", "is_user_spam",
    "is_user_nsfw", "is_user_bot", "is_nullcast",
    # health / safety model scores (the experimental health model slots)
    "parus_score", "toxicity_score", "pblock_score", "pspammy_score",
    "is_offensive", "is_sensitive_content",
    # r4 breadth toward EarlybirdFieldConstants (≥100 fields): url/card
    # depth resolved by the ingester (card types, domain reputation,
    # shortener expansion), entity/annotation, health-model and label
    # flags, engagement-rate, text-statistics, thread and author-state
    # fields
    "num_urls", "has_shortened_url", "has_media_url", "url_domain_rep",
    "has_poll_card", "has_summary_card", "has_player_card",
    "has_promo_card", "card_language_match", "card_uri_denylisted",
    "num_annotations", "top_annotation_score", "has_place",
    "geo_confidence", "place_country_match", "has_space_card",
    "pnsfw_text_score", "pnsfw_media_score", "pabusive_score",
    "experimental_health_score_1", "experimental_health_score_2",
    "label_abusive_flag", "label_abusive_hi_rcl_flag",
    "label_dup_content_flag", "label_nsfw_hi_prec_flag",
    "label_nsfw_hi_rcl_flag", "label_spam_flag", "label_spam_hi_rcl_flag",
    "label_offensive_flag", "label_low_quality_flag",
    "profile_click_count", "share_count", "dwell_time_avg",
    "quote_rate", "reply_rate", "retweet_rate", "fav_rate",
    "impression_count", "fake_fav_count", "blue_verified_boost",
    "readability_score", "offensive_terms_count", "trending_terms_count",
    "oov_ratio", "emoji_count", "caps_ratio", "token_entropy",
    "num_cashtags", "num_cjk_tokens", "text_entropy_bucket",
    "root_user_rep", "is_ancestor_in_thread", "descendant_reply_count",
    "conversation_control_flag", "author_following_log",
    "author_tweet_count_log", "author_is_protected", "author_state",
    # r5: absolute tweet language id — the lang: operator's posting field
    # (``queryparser``/EarlybirdFieldConstants LANG field)
    "tweet_language",
    # r5 full EarlybirdFieldConstants catalog coverage
    # (``common/schema/earlybird/EarlybirdFieldConstants.java`` — the
    # remaining encoded/extended-encoded feature slots and CSF payloads):
    # weighted/decayed/fake/blink engagement families
    "weighted_retweet_count", "weighted_reply_count",
    "weighted_fav_count", "weighted_quote_count",
    "decayed_retweet_count", "decayed_reply_count",
    "decayed_fav_count", "decayed_quote_count",
    "fake_retweet_count", "fake_reply_count", "fake_quote_count",
    "blink_retweet_count", "blink_reply_count", "blink_fav_count",
    "blink_quote_count",
    # v2 counter slots + engagement recency
    "embeds_impression_count_v2", "embeds_url_count_v2",
    "video_view_count_v2", "num_hashtags_v2", "num_mentions_v2",
    "last_retweet_since_creation_hrs", "last_reply_since_creation_hrs",
    "last_fav_since_creation_hrs", "last_quote_since_creation_hrs",
    # media family: vine/periscope/expando-card slots
    "has_vine", "has_periscope", "has_expando_card", "has_trend",
    "is_trending_now", "periscope_exists", "periscope_has_been_featured",
    "periscope_is_currently_featured", "periscope_is_from_quality_source",
    "periscope_is_live",
    # author-state + health-model tail
    "profile_is_egg", "is_user_new",
    "experimental_health_score_3", "experimental_health_score_4",
    "p_reported_score", "spammy_content_score",
    # card / geo / link CSF payloads
    "tweet_signature", "card_type", "card_lang", "card_uri_hash",
    "lat", "lon", "link_category", "place_country",
    "profile_geo_country", "profile_geo_region", "profile_geo_locality",
    # id-valued CSF payloads (operator-addressable; index-scale ids fit
    # float32's exact-integer range)
    "conversation_id", "shared_status_id", "quoted_tweet_id",
    "quoted_user_id", "directed_at_user_id", "reference_author_id",
    "exclusive_conversation_author_id", "in_reply_to_tweet_id",
    "in_reply_to_user_id", "retweet_source_tweet_id",
    "retweet_source_user_id", "entity_id", "place_id", "space_id",
)

# stable small ids for the lang: operator (ISO codes the reference's
# queryparser accepts; unknown codes hash into the tail range)
LANGUAGE_IDS = {
    c: i for i, c in enumerate((
        "en", "ja", "es", "pt", "ar", "ko", "fr", "tr", "th", "in", "ru",
        "de", "it", "hi", "pl", "nl", "fa", "und", "zh", "sv", "fi", "da",
        "no", "hu", "ur", "ta", "el", "he", "cs", "uk", "vi", "ro",
    ))
}


def language_id(code: str) -> int:
    c = (code or "und").lower()
    if c in LANGUAGE_IDS:
        return LANGUAGE_IDS[c]
    return len(LANGUAGE_IDS) + (_hash_term(c) % 1000)
DOC_FEATURE_INDEX = {n: i for i, n in enumerate(DOC_FEATURES)}

# Full EarlybirdFieldConstants catalog → TPU-index posting representation
# (``common/schema/earlybird/EarlybirdFieldConstants.java``, all 192
# enum members, lowercased). Kinds:
#   tokens     — indexed text; rides the class-prefixed token stream
#                (``search/analyzer.py`` namespaces the term hash)
#   feature    — a numeric slot of the dense [T, F] features array
#   column     — a dedicated EarlybirdIndex array
#   engagement — per-user engagement postings; lives in the engagement
#                graph (``graph/uteg.py``), not the tweet index
#   packed     — the encoded-features blob itself (our features array IS
#                the decoded form)
#   unused     — reference-catalogued unused bit ranges
FIELD_CATALOG: Mapping[str, Tuple[str, Optional[str]]] = {
    # indexed text fields
    "id_field": ("column", "tweet_ids"),
    "resolved_links_text_field": ("tokens", "url_text"),
    "text_field": ("tokens", "text"),
    "tokenized_from_user_field": ("tokens", "user"),
    "card_title_field": ("tokens", "card"),
    "card_description_field": ("tokens", "card"),
    "created_at_field": ("column", "created_ts"),
    "entity_id_field": ("feature", "entity_id"),
    "from_user_field": ("column", "author"),
    "from_user_id_field": ("column", "author"),
    "card_domain_field": ("tokens", "card"),
    "card_name_field": ("tokens", "card"),
    "geo_hash_field": ("feature", "lat"),
    "hashtags_field": ("tokens", "hashtag"),
    "hf_phrase_pairs_field": ("tokens", "phrase_pair"),
    "hf_term_pairs_field": ("tokens", "term_pair"),
    "image_links_field": ("tokens", "url"),
    "in_reply_to_tweet_id_field": ("feature", "in_reply_to_tweet_id"),
    "in_reply_to_user_id_field": ("feature", "in_reply_to_user_id"),
    "internal_field": ("packed", None),
    "iso_language_field": ("feature", "tweet_language"),
    "link_category_field": ("feature", "link_category"),
    "links_field": ("tokens", "url"),
    "mentions_field": ("tokens", "mention"),
    "news_links_field": ("tokens", "url"),
    "normalized_source_field": ("tokens", "source"),
    "place_field": ("tokens", "place"),
    "retweet_source_tweet_id_field": ("feature", "retweet_source_tweet_id"),
    "retweet_source_user_id_field": ("feature", "retweet_source_user_id"),
    "source_field": ("tokens", "source"),
    "stocks_field": ("tokens", "cashtag"),
    "to_user_field": ("feature", "in_reply_to_user_id"),
    "twimg_links_field": ("tokens", "url"),
    "video_links_field": ("tokens", "url"),
    "camelcase_user_handle_field": ("tokens", "user"),
    "tokenized_user_name_field": ("tokens", "user"),
    "conversation_id_field": ("feature", "conversation_id"),
    "place_id_field": ("feature", "place_id"),
    "place_full_name_field": ("tokens", "place"),
    "place_country_code_field": ("feature", "place_country"),
    "profile_geo_country_code_field": ("feature", "profile_geo_country"),
    "profile_geo_region_field": ("feature", "profile_geo_region"),
    "profile_geo_locality_field": ("feature", "profile_geo_locality"),
    "liked_by_user_id_field": ("engagement", "favorite"),
    "normalized_reply_count_greater_than_or_equal_to_field":
        ("feature", "reply_count"),
    "normalized_retweet_count_greater_than_or_equal_to_field":
        ("feature", "retweet_count"),
    "normalized_favorite_count_greater_than_or_equal_to_field":
        ("feature", "fav_count"),
    "composer_source": ("feature", "is_composer_source_camera"),
    "quoted_tweet_id_field": ("feature", "quoted_tweet_id"),
    "quoted_user_id_field": ("feature", "quoted_user_id"),
    "retweeted_by_user_id": ("engagement", "retweet"),
    "replied_to_by_user_id": ("engagement", "reply"),
    "card_lang": ("feature", "card_lang"),
    "named_entity_from_url_field": ("tokens", "entity"),
    "named_entity_from_text_field": ("tokens", "entity"),
    "named_entity_with_type_from_url_field": ("tokens", "entity"),
    "named_entity_with_type_from_text_field": ("tokens", "entity"),
    "directed_at_user_id_field": ("feature", "directed_at_user_id"),
    "space_id_field": ("feature", "space_id"),
    "space_title_field": ("tokens", "space"),
    "space_admin_field": ("tokens", "space"),
    "tokenized_space_admin_field": ("tokens", "space"),
    "camelcase_tokenized_space_admin_field": ("tokens", "space"),
    "tokenized_space_admin_display_name_field": ("tokens", "space"),
    "url_description_field": ("tokens", "url_text"),
    "url_title_field": ("tokens", "url_text"),
    # CSF payloads
    "card_type_csf_field": ("feature", "card_type"),
    "encoded_tweet_features_field": ("packed", None),
    "shared_status_id_csf": ("feature", "shared_status_id"),
    "from_user_id_csf": ("column", "author"),
    "created_at_csf_field": ("column", "created_ts"),
    "id_csf_field": ("column", "tweet_ids"),
    "lat_lon_csf_field": ("feature", "lat"),
    "conversation_id_csf": ("feature", "conversation_id"),
    "quoted_tweet_id_csf": ("feature", "quoted_tweet_id"),
    "quoted_user_id_csf": ("feature", "quoted_user_id"),
    "card_lang_csf": ("feature", "card_lang"),
    "directed_at_user_id_csf": ("feature", "directed_at_user_id"),
    "reference_author_id_csf": ("feature", "reference_author_id"),
    "exclusive_conversation_author_id_csf":
        ("feature", "exclusive_conversation_author_id"),
    "card_uri_csf": ("feature", "card_uri_hash"),
    # encoded feature flags / counters / scores
    "is_retweet_flag": ("feature", "is_retweet"),
    "is_offensive_flag": ("feature", "is_offensive"),
    "has_link_flag": ("feature", "has_url"),
    "has_trend_flag": ("feature", "has_trend"),
    "is_reply_flag": ("feature", "is_reply"),
    "is_sensitive_content": ("feature", "is_sensitive_content"),
    "has_multiple_hashtags_or_trends_flag":
        ("feature", "has_multiple_hashtags_or_trends"),
    "from_verified_account_flag": ("feature", "from_verified_account"),
    "text_score": ("feature", "text_score"),
    "language": ("feature", "tweet_language"),
    "link_language": ("feature", "link_language"),
    "has_image_url_flag": ("feature", "has_image"),
    "has_video_url_flag": ("feature", "has_video"),
    "has_news_url_flag": ("feature", "has_news_url"),
    "has_expando_card_flag": ("feature", "has_expando_card"),
    "has_multiple_media_flag": ("feature", "has_multiple_media"),
    "profile_is_egg_flag": ("feature", "profile_is_egg"),
    "num_mentions": ("feature", "num_mentions"),
    "num_hashtags": ("feature", "num_hashtags"),
    "has_card_flag": ("feature", "has_card"),
    "has_visible_link_flag": ("feature", "has_visible_link"),
    "user_reputation": ("feature", "user_rep"),
    "is_user_spam_flag": ("feature", "is_user_spam"),
    "is_user_nsfw_flag": ("feature", "is_user_nsfw"),
    "is_user_bot_flag": ("feature", "is_user_bot"),
    "is_user_new_flag": ("feature", "is_user_new"),
    "prev_user_tweet_engagement": ("feature",
                                   "prev_user_tweet_engagement"),
    "composer_source_is_camera_flag":
        ("feature", "is_composer_source_camera"),
    "retweet_count": ("feature", "retweet_count"),
    "favorite_count": ("feature", "fav_count"),
    "reply_count": ("feature", "reply_count"),
    "parus_score": ("feature", "parus_score"),
    "visible_token_ratio": ("feature", "visible_token_ratio"),
    "has_quote_flag": ("feature", "has_quote"),
    "from_blue_verified_account_flag":
        ("feature", "from_blue_verified_account"),
    "tweet_signature": ("feature", "tweet_signature"),
    "has_consumer_video_flag": ("feature", "has_consumer_video"),
    "has_pro_video_flag": ("feature", "has_pro_video"),
    "has_vine_flag": ("feature", "has_vine"),
    "has_periscope_flag": ("feature", "has_periscope"),
    "has_native_image_flag": ("feature", "has_native_image"),
    "is_nullcast_flag": ("feature", "is_nullcast"),
    "extended_encoded_tweet_features_field": ("packed", None),
    "embeds_impression_count": ("feature", "embeds_impression_count"),
    "embeds_url_count": ("feature", "embeds_url_count"),
    "video_view_count": ("feature", "video_view_count"),
    "reference_author_id_least_significant_int":
        ("feature", "reference_author_id"),
    "reference_author_id_most_significant_int":
        ("feature", "reference_author_id"),
    "retweet_count_v2": ("feature", "retweet_count_v2"),
    "favorite_count_v2": ("feature", "fav_count_v2"),
    "reply_count_v2": ("feature", "reply_count_v2"),
    "embeds_impression_count_v2":
        ("feature", "embeds_impression_count_v2"),
    "embeds_url_count_v2": ("feature", "embeds_url_count_v2"),
    "video_view_count_v2": ("feature", "video_view_count_v2"),
    "quote_count": ("feature", "quote_count"),
    "label_abusive_flag": ("feature", "label_abusive_flag"),
    "label_abusive_hi_rcl_flag": ("feature", "label_abusive_hi_rcl_flag"),
    "label_dup_content_flag": ("feature", "label_dup_content_flag"),
    "label_nsfw_hi_prc_flag": ("feature", "label_nsfw_hi_prec_flag"),
    "label_nsfw_hi_rcl_flag": ("feature", "label_nsfw_hi_rcl_flag"),
    "label_spam_flag": ("feature", "label_spam_flag"),
    "label_spam_hi_rcl_flag": ("feature", "label_spam_hi_rcl_flag"),
    "weighted_retweet_count": ("feature", "weighted_retweet_count"),
    "weighted_reply_count": ("feature", "weighted_reply_count"),
    "weighted_favorite_count": ("feature", "weighted_fav_count"),
    "weighted_quote_count": ("feature", "weighted_quote_count"),
    "periscope_exists": ("feature", "periscope_exists"),
    "periscope_has_been_featured":
        ("feature", "periscope_has_been_featured"),
    "periscope_is_currently_featured":
        ("feature", "periscope_is_currently_featured"),
    "periscope_is_from_quality_source":
        ("feature", "periscope_is_from_quality_source"),
    "periscope_is_live": ("feature", "periscope_is_live"),
    "is_trending_now_flag": ("feature", "is_trending_now"),
    "decayed_retweet_count": ("feature", "decayed_retweet_count"),
    "decayed_reply_count": ("feature", "decayed_reply_count"),
    "decayed_favorite_count": ("feature", "decayed_fav_count"),
    "decayed_quote_count": ("feature", "decayed_quote_count"),
    "fake_retweet_count": ("feature", "fake_retweet_count"),
    "fake_reply_count": ("feature", "fake_reply_count"),
    "fake_favorite_count": ("feature", "fake_fav_count"),
    "fake_quote_count": ("feature", "fake_quote_count"),
    "last_retweet_since_creation_hrs":
        ("feature", "last_retweet_since_creation_hrs"),
    "last_reply_since_creation_hrs":
        ("feature", "last_reply_since_creation_hrs"),
    "last_favorite_since_creation_hrs":
        ("feature", "last_fav_since_creation_hrs"),
    "last_quote_since_creation_hrs":
        ("feature", "last_quote_since_creation_hrs"),
    "num_hashtags_v2": ("feature", "num_hashtags_v2"),
    "num_mentions_v2": ("feature", "num_mentions_v2"),
    "num_stocks": ("feature", "num_stocks"),
    "blink_retweet_count": ("feature", "blink_retweet_count"),
    "blink_reply_count": ("feature", "blink_reply_count"),
    "blink_favorite_count": ("feature", "blink_fav_count"),
    "blink_quote_count": ("feature", "blink_quote_count"),
    "toxicity_score": ("feature", "toxicity_score"),
    "pblock_score": ("feature", "pblock_score"),
    "experimental_health_model_score_1":
        ("feature", "experimental_health_score_1"),
    "experimental_health_model_score_2":
        ("feature", "experimental_health_score_2"),
    "experimental_health_model_score_3":
        ("feature", "experimental_health_score_3"),
    "experimental_health_model_score_4":
        ("feature", "experimental_health_score_4"),
    "p_spammy_tweet_score": ("feature", "pspammy_score"),
    "p_reported_tweet_score": ("feature", "p_reported_score"),
    "spammy_tweet_content_score": ("feature", "spammy_content_score"),
    # reference-catalogued unused bit ranges
    "extended_feature_unused_bits_0_24_8": ("unused", None),
    "extended_test_feature_unused_bits_4_31_1": ("unused", None),
    "extended_test_feature_unused_bits_7_6_26": ("unused", None),
    "extended_test_feature_unused_bits_12_30_2": ("unused", None),
    "extended_test_feature_unused_bits_13_30_2": ("unused", None),
    "extended_test_feature_unused_bits_14_10_22": ("unused", None),
    "extended_test_feature_unused_bits_16": ("unused", None),
    "extended_test_feature_unused_bits_17": ("unused", None),
    "extended_test_feature_unused_bits_18": ("unused", None),
    "extended_test_feature_unused_bits_19": ("unused", None),
    "extended_test_feature_unused_bits_20": ("unused", None),
}
_COUNT_FIELDS = (
    "fav_count", "reply_count", "retweet_count", "quote_count",
    "bookmark_count", "fav_count_v2", "reply_count_v2", "retweet_count_v2",
    "prev_user_tweet_engagement", "num_likes_root", "num_replies_root",
    "video_view_count", "embeds_impression_count", "embeds_url_count",
)


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float: request scalars enter the
    float32 arithmetic of the JAX package at float32 precision."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class EarlybirdConfig:
    capacity: int = 1 << 16  # ring-buffer tweets (prod: ~7 days sharded)
    max_tokens: int = 32
    num_features: int = len(DOC_FEATURES)


class EarlybirdIndex(NamedTuple):
    """Device-resident ring buffer of recent tweets."""

    tokens: torch.Tensor  # [T, L] int32, PAD_ID padded
    author: torch.Tensor  # [T] int32 (PAD_ID = empty slot)
    created_ts: torch.Tensor  # [T] int32
    features: torch.Tensor  # [T, F] float32
    tweet_ids: torch.Tensor  # [T] int32 external ids
    write_pos: int  # next ring slot

    @property
    def capacity(self) -> int:
        return self.author.shape[0]

    @classmethod
    def from_numpy(cls, tokens, author, created_ts, features, tweet_ids, write_pos,
                   device=None) -> "EarlybirdIndex":
        """The index from the JAX package's arrays (as numpy), on ``device``
        (default: the card)."""
        dev = resolve(device, "EarlybirdIndex")
        arrays = zip((tokens, author, created_ts, features, tweet_ids),
                     (np.int32, np.int32, np.int32, np.float32, np.int32))
        return cls(*(torch.from_numpy(np.array(a, dt)).to(dev) for a, dt in arrays),
                   int(write_pos))


def init_index(config: EarlybirdConfig, device=None) -> EarlybirdIndex:
    """An empty index on ``device`` (default: the card)."""
    T, L, F = config.capacity, config.max_tokens, config.num_features
    dev = resolve(device, "EarlybirdIndex")
    return EarlybirdIndex(
        tokens=torch.full((T, L), PAD_ID, dtype=torch.int32, device=dev),
        author=torch.full((T,), PAD_ID, dtype=torch.int32, device=dev),
        created_ts=torch.zeros((T,), dtype=torch.int32, device=dev),
        features=torch.zeros((T, F), dtype=torch.float32, device=dev),
        tweet_ids=torch.full((T,), PAD_ID, dtype=torch.int32, device=dev),
        write_pos=0,
    )


def ingest(
    index: EarlybirdIndex,
    tokens: torch.Tensor,  # [B, L]
    authors: torch.Tensor,  # [B]
    created_ts: torch.Tensor,  # [B]
    features: torch.Tensor,  # [B, F]
    tweet_ids: torch.Tensor,  # [B]
) -> EarlybirdIndex:
    """Append a tweet batch at the ring position (the Kafka consumer path,
    ``partition/EarlybirdKafkaConsumer.java``; single-writer semantics).

    The batch moves to the index's device. A batch longer than the ring
    (B > T) writes some slots twice, and which write survives is not
    specified, here as in the JAX package: callers send B ≤ T.
    """
    B, T = authors.shape[0], index.capacity
    dev = index.tokens.device
    slots = (index.write_pos + torch.arange(B, device=dev)) % T

    def put(table, rows):
        return table.index_copy(0, slots, torch.as_tensor(rows).to(dev, table.dtype))

    return EarlybirdIndex(
        tokens=put(index.tokens, tokens),
        author=put(index.author, authors),
        created_ts=put(index.created_ts, created_ts),
        features=put(index.features, features),
        tweet_ids=put(index.tweet_ids, tweet_ids),
        write_pos=(index.write_pos + B) % T,
    )


# -- relevance scoring -------------------------------------------------------


class RelevanceParams(NamedTuple):
    """Request-scoped ranking parameters (≡ ThriftRankingParams /
    ``earlybird/common/ranking/`` — each search request carries its own
    weights, boosts, and demotions; nothing is hardcoded in the scorer).

    The text block (``text_weight``/``bm25_k1``/``bm25_b``/
    ``proximity_weight``) drives :func:`text_relevance`. The scalars are
    Python floats used at float32 precision.
    """

    weights: torch.Tensor  # [F] per-doc-feature linear weights
    recency_weight: float = 0.0  # boost × decay(now-ts)
    recency_half_life_s: float = 6 * 3600.0
    reply_demotion: float = 1.0  # multiplier if is_reply
    retweet_demotion: float = 1.0
    language_boost: float = 0.0  # added if language_match
    text_weight: float = 1.0
    bm25_k1: float = 1.2
    bm25_b: float = 0.75
    proximity_weight: float = 0.5

    @classmethod
    def from_numpy(cls, weights, *scalars, device=None) -> "RelevanceParams":
        """The params from the JAX package's (weights, *scalars) as numpy;
        the weights go to ``device`` (default: the card)."""
        dev = resolve(device, "RelevanceParams")
        w = torch.from_numpy(np.array(weights, np.float32)).to(dev)
        return cls(w, *(_f32(s) for s in scalars))


_DEFAULT_WEIGHT_TABLE = {
    "fav_count": 0.4, "reply_count": 0.2, "retweet_count": 0.3,
    "quote_count": 0.2, "bookmark_count": 0.3, "text_score": 1.0,
    "user_rep": 0.01, "has_image": 0.1, "has_video": 0.1, "has_card": 0.05,
    "has_url": 0.05, "is_reply": -0.05, "is_retweet": -0.1,
    "parus_score": 0.5, "from_verified_account": 0.05,
    "prev_user_tweet_engagement": 0.1, "language_match": 0.1,
}


def default_relevance_params(device=None) -> RelevanceParams:
    w = np.zeros(len(DOC_FEATURES), np.float32)
    for n, v in _DEFAULT_WEIGHT_TABLE.items():
        w[DOC_FEATURE_INDEX[n]] = v
    return RelevanceParams.from_numpy(w, *RelevanceParams._field_defaults.values(), device=device)


_COUNT_MASK = np.asarray(
    [n in _COUNT_FIELDS for n in DOC_FEATURES], np.bool_
)


def linear_score(
    features: torch.Tensor,
    relevance: RelevanceParams,
    created_ts: Optional[torch.Tensor] = None,
    now=None,
) -> torch.Tensor:
    """≡ ``LinearScoringFunction.java:24`` — dot of doc features and the
    request's ranking-parameter weights (log1p'd counts for stability),
    plus recency boost and reply/retweet demotions
    (``FeatureBasedScoringFunction.java:69`` boost structure)."""
    mask = torch.from_numpy(_COUNT_MASK).to(features.device)
    x = torch.where(mask, torch.log1p(features.clamp(min=0.0)), features)
    score = x @ relevance.weights
    if created_ts is not None and now is not None:
        age = torch.clamp(now - created_ts, min=0).float()
        score = score + _f32(relevance.recency_weight) * torch.exp2(-age / _f32(relevance.recency_half_life_s))
    is_reply = features[..., DOC_FEATURE_INDEX["is_reply"]] > 0
    is_rt = features[..., DOC_FEATURE_INDEX["is_retweet"]] > 0

    # demotion d<1 must always rank DOWN: subtract |score|·(1-d), which
    # equals score·d for positive scores and still decreases negative ones
    # (a bare multiply would *raise* a negative score)
    def demote(s, flag, d):
        return s - torch.where(flag, s.abs() * _f32(1.0 - _f32(d)), 0.0)

    score = demote(score, is_reply, relevance.reply_demotion)
    score = demote(score, is_rt, relevance.retweet_demotion)
    lang = features[..., DOC_FEATURE_INDEX["language_match"]] > 0
    return score + torch.where(lang, _f32(relevance.language_boost), 0.0)


def _query_hits(tokens: torch.Tensor, query_tokens: torch.Tensor) -> torch.Tensor:
    """[T, L, Qt]: position l of doc t holds valid query term q."""
    q_valid = query_tokens != PAD_ID
    return (tokens[:, :, None] == query_tokens[None, None, :]) & q_valid[None, None, :]


def text_relevance(
    tokens: torch.Tensor,  # [T, L] position-indexed token ids (PAD padded)
    query_tokens: torch.Tensor,  # [Qt] (PAD padded)
    live: torch.Tensor,  # [T] bool — slots that hold a real document
    *,
    k1: float = 1.2,
    b: float = 0.75,
    proximity_weight: float = 0.5,
    field_weight: float = 1.0,
    corpus_stats: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """[T] Lucene-analog text score from the position-indexed token arrays.

    ≡ the text component ``FeatureBasedScoringFunction.java:69`` builds on
    (``luceneScore``): per-term BM25 — saturated term frequency with
    document-length normalization and corpus idf — summed over query terms,
    plus a term-proximity boost (minimal pairwise distance between
    consecutive query terms).
    """
    k1, b = _f32(k1), _f32(b)
    q_valid = query_tokens != PAD_ID  # [Qt]
    hit = _query_hits(tokens, query_tokens)  # [T, L, Qt]
    tf = hit.sum(1).float()  # [T, Qt]
    doclen = (tokens != PAD_ID).sum(1).float()  # [T]
    # sharded path: the caller passes the global statistics summed over partitions
    df, sum_doclen, n_live = corpus_stats if corpus_stats is not None else _corpus_stats(hit, tokens, live)
    n_live = torch.clamp(n_live, min=1.0)
    avglen = torch.clamp(sum_doclen / n_live, min=1.0)
    idf = torch.log1p((n_live - df + 0.5) / (df + 0.5))  # [Qt]
    denom = tf + k1 * (_f32(1.0 - b) + b * doclen[:, None] / avglen)
    per_term = idf[None, :] * tf * _f32(k1 + 1.0) / torch.clamp(denom, min=1e-9)
    score = torch.where(q_valid[None, :], per_term, 0.0).sum(1)  # [T]

    # proximity: mean over consecutive valid term pairs of the minimal
    # position distance; docs containing a pair adjacently get the full
    # boost, distant/absent pairs decay to zero
    Qt, L = query_tokens.shape[0], tokens.shape[1]
    if Qt >= 2:
        pos = torch.arange(L, device=tokens.device)
        dist = (pos[:, None] - pos[None, :]).abs().float()
        boosts = []
        for qi in range(Qt - 1):
            pair = hit[:, :, qi, None] & hit[:, None, :, qi + 1]  # [T, L, L]
            d = torch.where(pair, dist, torch.inf).amin(dim=(1, 2))
            boosts.append(torch.where(torch.isfinite(d), d.clamp(min=1.0).reciprocal(), 0.0))
        boost = torch.stack(boosts, dim=1)  # [T, Qt-1]
        pv = (q_valid[:-1] & q_valid[1:]).float()  # [Qt-1]
        n_pairs = torch.clamp(pv.sum(), min=1.0)
        pair_mean = (boost * pv).sum(1) / n_pairs
        score = score + _f32(proximity_weight) * pair_mean
    return _f32(field_weight) * score


def text_corpus_stats(
    tokens: torch.Tensor, query_tokens: torch.Tensor, live: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(df [Qt], Σ doclen [], n_live []) — the corpus statistics
    :func:`text_relevance` needs; summed over partitions they give the
    sharded path exact global idf. Float32, counted exactly."""
    return _corpus_stats(_query_hits(tokens, query_tokens), tokens, live)


def _corpus_stats(hit, tokens, live):
    doclen = (tokens != PAD_ID).sum(1)
    df = (hit.any(1) & live[:, None]).sum(0).float()
    return df, (doclen * live).sum().float(), live.sum().float()


def text_relevance_reference(
    docs: Sequence[Sequence[int]],
    query_terms: Sequence[int],
    *,
    k1: float = 1.2,
    b: float = 0.75,
    proximity_weight: float = 0.5,
) -> np.ndarray:
    """Plain-Python oracle for :func:`text_relevance` (parity tests; a copy
    of the JAX package's)."""
    import math

    n = max(len(docs), 1)
    avglen = max(sum(len(d) for d in docs) / n, 1.0)
    df = {t: sum(1 for d in docs if t in d) for t in query_terms}
    out = np.zeros(len(docs), np.float32)
    for i, d in enumerate(docs):
        s = 0.0
        for t in query_terms:
            tf = sum(1 for w in d if w == t)
            idf = math.log1p((n - df[t] + 0.5) / (df[t] + 0.5))
            denom = tf + k1 * (1 - b + b * len(d) / avglen)
            s += idf * tf * (k1 + 1) / max(denom, 1e-9)
        if len(query_terms) >= 2:
            pair_boosts = []
            for a, bb in zip(query_terms, query_terms[1:]):
                pa = [j for j, w in enumerate(d) if w == a]
                pb = [j for j, w in enumerate(d) if w == bb]
                if pa and pb:
                    dmin = min(abs(x - y) for x in pa for y in pb)
                    pair_boosts.append(1.0 / max(dmin, 1))
                else:
                    pair_boosts.append(0.0)
            s += proximity_weight * sum(pair_boosts) / len(pair_boosts)
        out[i] = s
    return out


class SearchQuery(NamedTuple):
    """The serialized query tree's conjunctive serving form
    (≡ ``queryparser``/SerializedQuery operators actually issued by the
    products): required terms (AND/OR), excluded terms (NOT), and quoted
    phrases (position-consecutive token runs, each required). Arrays are
    tensors on the index's device (:meth:`to`), scalars Python ints."""

    tokens: torch.Tensor  # [Qt] int32 (PAD for unused)
    require_all: bool  # AND vs OR semantics
    min_ts: int
    max_ts: int
    # in-network: follow list (PAD padded); None ⇒ no author filter
    followed_authors: Optional[torch.Tensor] = None
    # NOT terms: a doc containing any is excluded ([Qe] int32, PAD padded)
    exclude_tokens: Optional[torch.Tensor] = None
    # quoted phrases: [Pn, Pl] int32, PAD padded rows; every non-empty
    # phrase must appear as consecutive tokens
    phrases: Optional[torch.Tensor] = None
    # tweet-id cursor window (exclusive), like Earlybird's SINCE_ID/MAX_ID
    # operators (``FollowingEarlybirdQueryTransformer.scala:40-52``)
    min_id: Optional[int] = None  # ids strictly greater
    max_id: Optional[int] = None  # ids strictly smaller
    # from: author set ([Fa] int32, PAD padded); ANDs with the follow filter
    from_authors: Optional[torch.Tensor] = None
    # scored-facet floors / ceilings over the doc-feature columns
    # (min_faves:/min_retweets:/… and -filter: negations): [n_doc] f32,
    # -inf / +inf for unconstrained columns
    feature_min_bounds: Optional[torch.Tensor] = None
    feature_max_bounds: Optional[torch.Tensor] = None
    # any-of filter groups (filter:media = image OR video OR …): [G, n_doc]
    # 0/1 — a doc passes iff every group has SOME flagged column ≥ 0.5
    feature_any_groups: Optional[torch.Tensor] = None
    # lang: operator — doc's tweet_language column equals this id
    lang_id: Optional[int] = None

    def to(self, device) -> "SearchQuery":
        """The same query with its tensors on ``device``."""
        return self._replace(**{
            f: v.to(device) for f, v in zip(self._fields, self) if isinstance(v, torch.Tensor)})


def phrase_match(tokens: torch.Tensor, phrases: torch.Tensor) -> torch.Tensor:
    """[T] — does each doc contain every non-empty phrase consecutively?

    ``tokens`` [T, L] position-indexed token ids; ``phrases`` [Pn, Pl].
    """
    T, L = tokens.shape
    Pl = min(phrases.shape[1], L)
    phrases = phrases[:, :Pl]
    # pad the doc so every start position 0..L-1 has a full window — a
    # phrase SHORTER than the padded Pl must still match at the doc's tail
    # (padded window slots compare against PAD phrase slots, which the
    # validity mask ignores; real phrase tokens never equal PAD)
    padded = torch.cat([tokens, tokens.new_full((T, Pl - 1), PAD_ID)], dim=1)
    windows = padded.unfold(1, Pl, 1)  # [T, L, Pl]
    valid = phrases != PAD_ID  # [Pn, Pl]
    nonempty = valid.any(1)  # [Pn]
    # [T, L, Pn, Pl]: window position j matches phrase token j (or slot unused)
    eq = windows[:, :, None, :] == phrases[None, None, :, :]
    ok = (eq | ~valid[None, None, :, :]).all(-1)  # [T, L, Pn]
    found = ok.any(1)  # [T, Pn]
    return (found | ~nonempty[None, :]).all(1)  # [T]


def _author_in_set(author: torch.Tensor, follows: torch.Tensor) -> torch.Tensor:
    """[R, T] membership of each doc's author in each of R (PAD-padded)
    follow lists [R, FW].

    The JAX form compares all T × FW pairs; here each list is sorted (PAD,
    the largest int32, sorts last) and searched, which keeps memory at
    [R, T]. A PAD author (an empty ring slot) never matches."""
    R, T = follows.shape[0], author.shape[0]
    if follows.shape[1] == 0:
        return torch.zeros((R, T), dtype=torch.bool, device=author.device)
    follows = torch.sort(follows, dim=-1).values
    pos = torch.searchsorted(follows, author.expand(R, T).contiguous(), out_int32=True)
    found = torch.gather(follows, 1, pos.clamp_(max=follows.shape[1] - 1)) == author[None, :]
    return found & (author != PAD_ID)[None, :]


def match_mask(index: EarlybirdIndex, query: SearchQuery) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ok [T], overlap [T]) — the boolean query-tree evaluation.

    ok = (terms AND/OR) ∧ phrases ∧ ¬excluded ∧ time-window ∧ author-set.
    overlap = matched-term ratio (the text-score contribution).
    """
    q_valid = query.tokens != PAD_ID  # [Qt]
    hit = _query_hits(index.tokens, query.tokens).any(1)  # [T, Qt]
    n_q = torch.clamp(q_valid.sum(), min=1)
    if query.require_all:
        match = hit.sum(1) == n_q
    else:
        match = hit.any(1)
    # an empty term set is a match-all recency query (the recap/timeline
    # fetch issues author+time-window-only queries)
    match = match | ~q_valid.any()

    if query.phrases is not None:
        match &= phrase_match(index.tokens, query.phrases)
    if query.exclude_tokens is not None:
        match &= ~_query_hits(index.tokens, query.exclude_tokens).any(2).any(1)

    ok = (
        match
        & (index.author != PAD_ID)
        & (index.created_ts >= query.min_ts)
        & (index.created_ts <= query.max_ts)
    )
    if query.min_id is not None:
        ok &= index.tweet_ids > query.min_id
    if query.max_id is not None:
        ok &= index.tweet_ids < query.max_id
    if query.followed_authors is not None:
        ok &= _author_in_set(index.author, query.followed_authors[None])[0]
    if query.from_authors is not None:
        ok &= _author_in_set(index.author, query.from_authors[None])[0]
    # field operators over the doc-feature columns (lang:, filter:,
    # min_faves:-style scored facets)
    if query.feature_min_bounds is not None:
        ok &= (index.features >= query.feature_min_bounds[None, :]).all(1)
    if query.feature_max_bounds is not None:
        ok &= (index.features <= query.feature_max_bounds[None, :]).all(1)
    if query.feature_any_groups is not None:
        groups = query.feature_any_groups > 0  # [G, n_doc]
        grp_hit = ((index.features[:, None, :] >= 0.5) & groups[None, :, :]).any(2)  # [T, G]
        ok &= (grp_hit | ~groups.any(1)[None, :]).all(1)
    if query.lang_id is not None:
        lang_col = DOC_FEATURE_INDEX["tweet_language"]
        ok &= index.features[:, lang_col].to(torch.int32) == query.lang_id
    return ok, hit.sum(1) / n_q


def _doc_scores(index, query, relevance, model_score_fn, corpus_stats) -> torch.Tensor:
    """[T] the feature score (linear, or ``model_score_fn``) plus the text score."""
    if model_score_fn is not None:
        score = model_score_fn(index.features)
    else:
        score = linear_score(index.features, relevance, created_ts=index.created_ts, now=query.max_ts)
    # Lucene-analog text component: BM25 tf/idf + length norm + proximity
    # (``FeatureBasedScoringFunction.java:69`` luceneScore structure)
    return score + _f32(relevance.text_weight) * text_relevance(
        index.tokens, query.tokens, index.author != PAD_ID,
        k1=relevance.bm25_k1, b=relevance.bm25_b,
        proximity_weight=relevance.proximity_weight,
        corpus_stats=corpus_stats,
    )


def search(
    index: EarlybirdIndex,
    query: SearchQuery,
    *,
    max_results: int,
    relevance: Optional[RelevanceParams] = None,
    model_score_fn=None,
    extra_mask: Optional[torch.Tensor] = None,
    rank_by: str = "relevance",
    corpus_stats: Optional[Tuple] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-corpus scan → (tweet_ids[X], scores[X]).

    ``relevance`` carries the request-scoped ranking params (weights,
    boosts, demotions); ``model_score_fn(features [T, F]) -> [T]``
    overrides the linear scorer (≡ ``ModelBasedScoringFunction`` /
    ``TensorflowBasedScoringFunction`` plugging the light ranker in-index);
    ``extra_mask`` [T] ANDs caller-side doc filters into the match.
    ``rank_by="recency"`` orders by created_ts descending — the timeline
    products' rankingMode=Recency (``FollowingEarlybirdQueryTransformer``),
    exact integer ordering with no float scoring at all. Equal keys rank
    lower ring slot first, as ``lax.top_k`` ranks them.
    """
    ok, _ = match_mask(index, query)
    if extra_mask is not None:
        ok = ok & extra_mask
    if rank_by == "recency":
        key = torch.where(ok, index.created_ts, INT32_MIN)
        top_ts, idx = top_k(key, min(max_results, key.shape[0]))
        found = top_ts > INT32_MIN
        ids = torch.where(found, index.tweet_ids[idx], PAD_ID)
        return ids, torch.where(found, top_ts.float(), -torch.inf)
    if relevance is None:
        relevance = default_relevance_params(index.features.device)
    score = torch.where(ok, _doc_scores(index, query, relevance, model_score_fn, corpus_stats), -torch.inf)
    top_scores, idx = top_k(score, min(max_results, score.shape[0]))
    ids = torch.where(torch.isfinite(top_scores), index.tweet_ids[idx], PAD_ID)
    return ids, top_scores


def search_in_network_batch(
    index: EarlybirdIndex,
    query: SearchQuery,
    follows_b: torch.Tensor,  # [R, FW] int32 per-user follow sets (PAD pad)
    *,
    max_results: int,
    relevance: Optional[RelevanceParams] = None,
    model_score_fn=None,
    corpus_stats: Optional[Tuple] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R users' in-network scans in one call → (ids [R, X], scores).

    The timeline products issue the SAME query for every user except the
    author filter (``FollowingEarlybirdQueryTransformer``), so the doc
    scoring (linear features + BM25 text) is user-independent: compute it
    ONCE over the corpus, then per user apply the follow mask and take the
    top-K. Ranking is exact (the JAX package may use ``approx_max_k`` on a
    TPU; on the CPU it ranks exactly too).
    """
    if relevance is None:
        relevance = default_relevance_params(index.features.device)
    ok_base, _ = match_mask(index, query)
    base = torch.where(ok_base, _doc_scores(index, query, relevance, model_score_fn, corpus_stats),
                       -torch.inf)  # [T]
    s = torch.where(_author_in_set(index.author, follows_b), base[None, :], -torch.inf)  # [R, T]
    top, idx = top_k(s, min(max_results, base.shape[0]))
    return torch.where(torch.isfinite(top), index.tweet_ids[idx], PAD_ID), top


def search_sharded(
    mesh,
    index: EarlybirdIndex,  # this rank's block of the tweet axis, P('model') on [T] arrays
    query: SearchQuery,
    *,
    max_results: int,
    relevance: Optional[RelevanceParams] = None,
    model_score_fn=None,
    rank_by: str = "relevance",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partitioned scan + root merge (≡ ``earlybird_root`` fan-out): each
    rank scans its block of the index and the per-partition top-X lists are
    gathered over 'model' and merged; every rank returns the same (ids [X],
    scores [X]).

    Relevance: the text-corpus statistics (df, Σ doclen, live docs) are
    summed over the partitions first, so idf and length norms are the
    single index's (whole-number float32 counts, exact below 2^24; the
    reference's per-partition Lucene idf drifts here). Recency: the merge
    ranks on the int32 timestamps with an int32-min sentinel, never on
    float scores (float32 at epoch-second magnitude is ~128 s an ulp).
    Ties merge in shard order, then ring slot, as ``lax.top_k`` ranks the
    gathered lists.
    """
    from the_algorithm_tpu_torch.core.mesh import MODEL_AXIS

    X = max_results
    if rank_by == "recency":
        ok, _ = match_mask(index, query)
        key = torch.where(ok, index.created_ts, INT32_MIN)
        top_ts, idx = top_k(key, min(X, key.shape[0]))
        ids = torch.where(top_ts > INT32_MIN, index.tweet_ids[idx], PAD_ID)
        all_ids, all_keys = mesh.all_gather(ids, MODEL_AXIS), mesh.all_gather(top_ts, MODEL_AXIS)
        top, midx = top_k(all_keys, min(X, all_keys.shape[0]))
        found = top > INT32_MIN
        return torch.where(found, all_ids[midx], PAD_ID), torch.where(found, top.float(), -torch.inf)
    stats = tuple(mesh.psum(s, MODEL_AXIS)
                  for s in text_corpus_stats(index.tokens, query.tokens, index.author != PAD_ID))
    ids, scores = search(index, query, max_results=X, relevance=relevance, model_score_fn=model_score_fn,
                         rank_by=rank_by, corpus_stats=stats)
    all_ids, all_scores = mesh.all_gather(ids, MODEL_AXIS), mesh.all_gather(scores, MODEL_AXIS)
    top, idx = top_k(all_scores, min(X, all_scores.shape[0]))
    return torch.where(torch.isfinite(top), all_ids[idx], PAD_ID), top


def shard_index(mesh, index: EarlybirdIndex) -> EarlybirdIndex:
    """This rank's block of an index's tweet axis (P('model')), on the
    mesh's device, for :func:`search_sharded`. The capacity must divide."""
    from the_algorithm_tpu_torch.core.mesh import shard_rows

    return EarlybirdIndex(*(shard_rows(t, mesh, pad=False, what="capacity") for t in index[:5]), 0)


# -- facets (the earlybird facets endpoint) -----------------------------------


def facet_counts(
    facet_ids: torch.Tensor,  # [T, Fc] int32 per-doc facet ids (PAD padded)
    match: torch.Tensor,  # [T] bool from match_mask
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k facets among matching docs → (facet_ids[k], counts[k] int32).

    ≡ the facets service (``earlybird/search/facets/``): count hashtag /
    mention / link facets over the matching doc set: mask → flat sort →
    run-collapse of a ones array (the kernel of ``csrc/seg_scan.cu`` on the
    card), whose run-end slot holds the run length where the JAX package
    puts it.
    """
    flat = torch.where(match[:, None], facet_ids, PAD_ID).reshape(1, -1)
    s = torch.sort(flat, dim=-1).values.contiguous()  # PAD sorts last
    rep, length = run_collapse_sorted(s, torch.ones(s.shape, dtype=torch.float32, device=s.device))
    cand = torch.where(rep != PAD_ID, length, 0.0).to(torch.int32)[0]
    top_counts, pos = top_k(cand, k)
    ids = torch.where(top_counts > 0, s[0, pos], PAD_ID)
    return ids, top_counts


# -- ingester (the tweet → index-document pipeline) ----------------------------


@dataclasses.dataclass
class RawTweet:
    """Ingester input (≡ the TweetEventData the ingester consumes,
    ``src/java/com/twitter/search/ingester/``)."""

    tweet_id: int
    author_id: int
    created_ts: int
    text: str
    language: str = "en"
    fav_count: int = 0
    reply_count: int = 0
    retweet_count: int = 0
    quote_count: int = 0
    bookmark_count: int = 0
    has_image: bool = False
    has_video: bool = False
    has_card: bool = False
    is_reply: bool = False
    is_retweet: bool = False
    is_quote: bool = False
    user_rep: float = 0.0
    author_following: int = 0
    author_tweet_count: int = 0
    author_is_protected: bool = False
    parus_score: float = 0.0
    from_verified_account: bool = False
    from_blue_verified_account: bool = False
    is_trend_tweet: bool = False
    num_likes_root: int = 0
    num_replies_root: int = 0
    conversation_depth: int = 0
    is_self_thread: bool = False
    prev_user_tweet_engagement: float = 0.0
    # r3 schema-breadth fields (ThriftSearchResultFeatures parity)
    video_view_count: int = 0
    embeds_impression_count: int = 0
    embeds_url_count: int = 0
    has_native_image: bool = False
    has_consumer_video: bool = False
    has_pro_video: bool = False
    is_composer_source_camera: bool = False
    has_news_url: bool = False
    has_expanded_url: bool = False
    author_followers: int = 0
    author_account_age_days: float = 0.0
    is_user_spam: bool = False
    is_user_nsfw: bool = False
    is_user_bot: bool = False
    is_nullcast: bool = False
    toxicity_score: float = 0.0
    pblock_score: float = 0.0
    pspammy_score: float = 0.0
    is_offensive: bool = False
    is_sensitive_content: bool = False
    language_confidence: float = 1.0


def _hash_term(term: str) -> int:
    h1, _ = murmur3_x64_128(term.encode("utf-8"))
    return int(np.int32(h1 & 0x7FFFFFFF))


_URL_SHORTENERS = frozenset(
    {"t.co", "bit.ly", "tinyurl.com", "goo.gl", "ow.ly", "buff.ly"})
_MEDIA_DOMAINS = frozenset(
    {"pic.twitter.com", "youtube.com", "youtu.be", "twitch.tv",
     "instagram.com", "vimeo.com"})


def build_documents(
    tweets: Sequence[RawTweet],
    config: EarlybirdConfig,
    *,
    ui_language: str = "en",
    now: Optional[int] = None,
    max_facets: int = 8,
    url_reputation: Optional[Mapping] = None,  # domain -> rep [0,1]
    card_store: Optional[Mapping] = None,  # tweet_id -> card type str
):
    """Ingester analog: raw tweets → (tokens [B,L], authors, ts, features
    [B,F], tweet_ids, facets [B,Fc]).

    Text analysis (tokenize + hashtag/mention/url facet extraction +
    text-quality score) and the full 30-field doc-feature fill happen here,
    host-side, mirroring the ingester's TwitterTextTokenizer + feature
    extraction stages; the output arrays go straight into :func:`ingest`.
    """
    B, L, F = len(tweets), config.max_tokens, config.num_features
    tokens = np.full((B, L), int(PAD_ID), np.int32)
    authors = np.empty(B, np.int32)
    ts = np.empty(B, np.int32)
    feats = np.zeros((B, F), np.float32)
    ids = np.empty(B, np.int32)
    facets = np.full((B, max_facets), int(PAD_ID), np.int32)
    anl = analyzer

    for i, t in enumerate(tweets):
        tokens[i] = tokenize(t.text, L)
        authors[i] = t.author_id
        ts[i] = t.created_ts
        ids[i] = t.tweet_id
        toks = anl.analyze(t.text)
        words = [tk.text for tk in toks
                 if tk.cls in (anl.TokenClass.WORD, anl.TokenClass.HASHTAG,
                               anl.TokenClass.MENTION)]
        ents = anl.extract_entities(t.text)
        urls = ents["urls"]
        facet_terms = (
            [f"#{h}" for h in ents["hashtags"]]
            + [f"@{m}" for m in ents["mentions"]]
            + ents["domains"]
        )
        for j, f in enumerate(facet_terms[:max_facets]):
            facets[i, j] = _hash_term(f)
        n_words = max(len(words), 1)
        uniq_ratio = len(set(words)) / n_words
        cjk_count = sum(
            1 for tk in toks if tk.cls is anl.TokenClass.CJK_BIGRAM)
        raw = t.text
        letters = [c for c in raw if c.isalpha()]
        caps_ratio = (sum(1 for c in letters if c.isupper())
                      / max(len(letters), 1))
        emoji_count = sum(1 for c in raw if ord(c) >= 0x1F000)
        counts = {}
        for w in words:
            counts[w] = counts.get(w, 0) + 1
        total = max(sum(counts.values()), 1)
        entropy = -sum((c / total) * np.log2(c / total)
                       for c in counts.values())
        # URL/card resolution (the ingester's resolve stage; the resolver
        # hooks let a deployment wire live stores)
        domains = ents["domains"]
        domain_rep = max((float(url_reputation.get(d, 0.5))
                          for d in domains), default=0.0) \
            if url_reputation is not None else (0.5 if domains else 0.0)
        shortened = any(d in _URL_SHORTENERS for d in domains)
        card = card_store.get(t.tweet_id) if card_store is not None else None
        row = {
            "fav_count": t.fav_count, "reply_count": t.reply_count,
            "retweet_count": t.retweet_count, "quote_count": t.quote_count,
            "bookmark_count": t.bookmark_count, "created_ts": t.created_ts,
            # text score: length & diversity heuristic (the ingester's
            # text-quality stage; any richer scorer slots in here)
            "text_score": min(n_words / 16.0, 1.0) * uniq_ratio,
            "user_rep": t.user_rep,
            "has_image": t.has_image, "has_video": t.has_video,
            "has_card": t.has_card,
            "has_url": bool(urls),
            "is_reply": t.is_reply, "is_retweet": t.is_retweet,
            "is_quote": t.is_quote,
            "num_hashtags": len(ents["hashtags"]),
            "num_mentions": len(ents["mentions"]),
            "link_language": _hash_term(t.language) % 1000,
            "language_match": t.language == ui_language,
            "prev_user_tweet_engagement": t.prev_user_tweet_engagement,
            "from_verified_account": t.from_verified_account,
            "is_trend_tweet": t.is_trend_tweet,
            "has_multiple_media": int(t.has_image) + int(t.has_video) > 1,
            "tweet_age_hours": max(((now or t.created_ts) - t.created_ts), 0)
            / 3600.0,
            "parus_score": t.parus_score,
            "from_blue_verified_account": t.from_blue_verified_account,
            "num_likes_root": t.num_likes_root,
            "num_replies_root": t.num_replies_root,
            "conversation_depth": t.conversation_depth,
            "is_self_thread": t.is_self_thread,
            # r3 schema-breadth fill
            "fav_count_v2": t.fav_count,  # v2 = decayed; equal at ingest
            "reply_count_v2": t.reply_count,
            "retweet_count_v2": t.retweet_count,
            "video_view_count": t.video_view_count,
            "embeds_impression_count": t.embeds_impression_count,
            "embeds_url_count": t.embeds_url_count,
            "has_quote": t.is_quote,
            "word_count": len(words),
            "visible_token_ratio": uniq_ratio,
            "language_confidence": t.language_confidence,
            "num_stocks": len(ents["cashtags"]),
            "has_multiple_hashtags_or_trends":
                len(ents["hashtags"]) > 1 or t.is_trend_tweet,
            "has_native_image": t.has_native_image or t.has_image,
            "has_consumer_video": t.has_consumer_video,
            "has_pro_video": t.has_pro_video,
            "is_composer_source_camera": t.is_composer_source_camera,
            "has_news_url": t.has_news_url,
            "has_expanded_url": t.has_expanded_url or bool(urls),
            "has_visible_link": bool(urls),
            "author_followers_log": float(np.log1p(t.author_followers)),
            "author_account_age_days": t.author_account_age_days,
            "is_user_spam": t.is_user_spam,
            "is_user_nsfw": t.is_user_nsfw,
            "is_user_bot": t.is_user_bot,
            "is_nullcast": t.is_nullcast,
            "toxicity_score": t.toxicity_score,
            "pblock_score": t.pblock_score,
            "pspammy_score": t.pspammy_score,
            "is_offensive": t.is_offensive,
            "is_sensitive_content": t.is_sensitive_content,
            # r4 analyzer/resolver-derived breadth
            "num_urls": len(urls),
            "has_shortened_url": shortened,
            "has_media_url": any(d in _MEDIA_DOMAINS for d in domains),
            "url_domain_rep": domain_rep,
            "has_poll_card": card == "poll",
            "has_summary_card": card == "summary",
            "has_player_card": card == "player",
            "has_promo_card": card == "promo",
            "card_language_match": bool(card) and t.language == ui_language,
            "num_cashtags": len(ents["cashtags"]),
            "num_cjk_tokens": cjk_count,
            "emoji_count": emoji_count,
            "caps_ratio": caps_ratio,
            "token_entropy": entropy,
            "text_entropy_bucket": min(int(entropy), 7),
            "oov_ratio": 1.0 - uniq_ratio,
            "author_following_log": float(np.log1p(t.author_following)),
            "author_tweet_count_log": float(np.log1p(t.author_tweet_count)),
            "author_is_protected": t.author_is_protected,
            "tweet_language": language_id(t.language),
        }
        for n, v in row.items():
            if DOC_FEATURE_INDEX.get(n, F) < F:
                feats[i, DOC_FEATURE_INDEX[n]] = float(v)
    return tuple(torch.from_numpy(a) for a in (tokens, authors, ts, feats, ids, facets)
    )


# filter:NAME → doc-feature constraint. Single-column filters support
# ``-filter:NAME`` negation (the column must stay below the threshold);
# any-of groups express media-breadth filters the way the reference's
# internal posting fields do (``queryparser``/``common/query``).
_SINGLE_COL_FILTERS = {
    "links": "has_url",
    "images": "has_image",
    "replies": "is_reply",
    "retweets": "is_retweet",
    "quote": "is_quote",
    "news": "has_news_url",
    "verified": "from_verified_account",
    "blue_verified": "from_blue_verified_account",
    "nullcast": "is_nullcast",
    "self_threads": "is_self_thread",
    "trusted": "from_verified_account",
    "spaces": "has_space_card",
    "polls": "has_poll_card",
}
_ANY_GROUP_FILTERS = {
    "media": ("has_image", "has_native_image", "has_video",
              "has_consumer_video", "has_pro_video", "has_media_url"),
    "videos": ("has_video", "has_consumer_video", "has_pro_video"),
    "cards": ("has_card", "has_poll_card", "has_summary_card",
              "has_player_card", "has_promo_card"),
}
# filter:safe — ceilings instead of floors
_SAFE_MAX = {"is_sensitive_content": 0.5, "is_user_nsfw": 0.5,
             "pnsfw_media_score": 0.9}
_MIN_COUNT_OPS = {
    "min_faves": "fav_count",
    "min_retweets": "retweet_count",
    "min_replies": "reply_count",
    "min_quotes": "quote_count",
    "min_score": "text_score",
}


def parse_query(text: str, max_tokens: int = 16, max_phrases: int = 2,
                phrase_len: int = 4) -> dict:
    """Parse the user-facing query syntax → SearchQuery kwargs.

    Operator surface (≡ ``src/java/com/twitter/search/earlybird/
    queryparser/`` + ``common/query/``): bare terms, ``-term``,
    ``"quoted phrase"``, ``from:<author-id>``, ``from:follows`` (returned
    as ``from_follows=True`` for the caller to resolve against the
    viewer's follow set — the in-network leg's operator form),
    ``lang:<code>``, ``filter:<name>`` / ``-filter:<name>``,
    ``min_faves:<n>``-family scored facets, ``since_time:``/``until_time:``
    (epoch seconds → min_ts/max_ts) and ``since_id:``/``max_id:``.
    Returns kwargs for :class:`SearchQuery` plus the ``from_follows`` flag:
    arrays as CPU tensors (move them with :meth:`SearchQuery.to`), scalars
    as Python ints that must fit int32, as the JAX package's ``jnp.int32``.
    """
    phrases_txt = re.findall(r'"([^"]*)"', text)
    rest = re.sub(r'"[^"]*"', " ", text)
    terms, excluded = [], []
    from_ids = []
    from_follows = False
    lang = None
    nF = len(DOC_FEATURES)
    min_bounds = np.full(nF, -np.inf, np.float32)
    max_bounds = np.full(nF, np.inf, np.float32)
    any_groups = []
    min_ts = max_ts = min_id = max_id = None
    has_min = has_max = False

    def col(name):
        return DOC_FEATURE_INDEX[name]

    for w in rest.split():
        lw = w.lower()
        neg = lw.startswith("-")
        body = lw[1:] if neg else lw
        op, _, val = body.partition(":")
        if _ == ":" and val:
            if op == "from":
                if val == "follows":
                    from_follows = True
                elif val.isdigit():
                    from_ids.append(int(val))
                continue
            if op == "lang":
                lang = language_id(val)
                continue
            if op == "filter":
                if val in _SINGLE_COL_FILTERS:
                    c = col(_SINGLE_COL_FILTERS[val])
                    if neg:
                        max_bounds[c] = min(max_bounds[c], 0.5)
                        has_max = True
                    else:
                        min_bounds[c] = max(min_bounds[c], 0.5)
                        has_min = True
                elif val in _ANY_GROUP_FILTERS and not neg:
                    g = np.zeros(nF, np.float32)
                    for n in _ANY_GROUP_FILTERS[val]:
                        g[col(n)] = 1.0
                    any_groups.append(g)
                elif val == "safe" and not neg:
                    for n, t_ in _SAFE_MAX.items():
                        c = col(n)
                        max_bounds[c] = min(max_bounds[c], t_)
                    has_max = True
                continue
            if op in _MIN_COUNT_OPS and _num(val) is not None:
                c = col(_MIN_COUNT_OPS[op])
                min_bounds[c] = max(min_bounds[c], _num(val))
                has_min = True
                continue
            if op == "since_time" and val.isdigit():
                min_ts = int(val)
                continue
            if op == "until_time" and val.isdigit():
                max_ts = int(val)
                continue
            if op == "since_id" and val.isdigit():
                min_id = int(val)
                continue
            if op == "max_id" and val.isdigit():
                max_id = int(val)
                continue
            # unknown operator: fall through as a term (parser leniency)
        if neg and len(lw) > 1:
            excluded.append(body)
        else:
            terms.append(lw)

    tokens = tokenize(" ".join(terms), max_tokens)
    exclude = tokenize(" ".join(excluded), max_tokens) if excluded else None
    phrases = None
    if phrases_txt:
        phrases = np.stack(
            [tokenize(p, phrase_len) for p in phrases_txt[:max_phrases]]
        )
        if phrases.shape[0] < max_phrases:
            pad = np.full(
                (max_phrases - phrases.shape[0], phrase_len), int(PAD_ID),
                np.int32,
            )
            phrases = np.concatenate([phrases, pad])

    out = dict(
        tokens=torch.from_numpy(tokens),
        exclude_tokens=None if exclude is None else torch.from_numpy(exclude),
        phrases=None if phrases is None else torch.from_numpy(phrases),
    )
    if from_follows:
        # only present when the operator appeared: splatting an UNRESOLVED
        # from:follows into SearchQuery must fail loudly (resolve it with
        # :func:`build_query`), while operator-free queries stay
        # constructible the old way
        out["from_follows"] = True
    if from_ids:
        out["from_authors"] = torch.from_numpy(np.asarray(from_ids, np.int32))
    if lang is not None:
        out["lang_id"] = _int32(lang)
    if has_min:
        out["feature_min_bounds"] = torch.from_numpy(min_bounds)
    if has_max:
        out["feature_max_bounds"] = torch.from_numpy(max_bounds)
    if any_groups:
        out["feature_any_groups"] = torch.from_numpy(np.stack(any_groups))
    if min_ts is not None:
        out["min_ts"] = _int32(min_ts)
    if max_ts is not None:
        out["max_ts"] = _int32(max_ts)
    if min_id is not None:
        out["min_id"] = _int32(min_id)
    if max_id is not None:
        out["max_id"] = _int32(max_id)
    return out


def _num(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def _int32(v: int) -> int:
    """``v`` if it fits int32; raises OverflowError as ``jnp.int32(v)`` does."""
    return int(np.int32(v))


def build_query(
    text: str,
    *,
    follows=None,
    min_ts: int = 0,
    max_ts: int = 2**31 - 1,
    require_all: bool = True,
    **parse_kwargs,
) -> SearchQuery:
    """Operator text → a complete :class:`SearchQuery`.

    ``from:follows`` resolves against ``follows`` (the viewer's follow
    set) — the in-network timeline leg in operator form
    (``FollowingEarlybirdQueryTransformer.scala``). Explicit operator
    time/id windows override the defaults. The query's tensors are on the
    CPU: ``.to(device)`` puts them beside the index.
    """
    kw = parse_query(text, **parse_kwargs)
    from_follows = kw.pop("from_follows", False)
    followed = None
    if from_follows:
        if follows is None:
            raise ValueError("query uses from:follows but no follow set")
        followed = torch.from_numpy(np.asarray(follows, np.int32))
    kw.setdefault("min_ts", _int32(min_ts))
    kw.setdefault("max_ts", _int32(max_ts))
    return SearchQuery(
        require_all=require_all, followed_authors=followed, **kw)


def doc_feature_reader(index: EarlybirdIndex):
    """``ids [B] -> {name: [B]}`` closure over the live index — the feed
    for home-mixer's EarlybirdDocColumnarHydrator (the reference's
    EarlybirdFeatureHydrator reads these same in-index doc features).
    Unknown ids read as zero rows. The closure holds a host copy."""
    tids = index.tweet_ids.cpu().numpy()
    order = np.argsort(tids, kind="stable")
    sorted_ids = tids[order]
    feats = index.features.cpu().numpy()[order]

    def read(ids: np.ndarray):
        ids = np.asarray(ids)
        pos = np.clip(
            np.searchsorted(sorted_ids, ids), 0, sorted_ids.shape[0] - 1
        )
        found = sorted_ids[pos] == ids
        block = np.where(found[:, None], feats[pos], 0.0).astype(np.float32)
        return {n: block[:, i] for i, n in enumerate(DOC_FEATURES)}

    return read
