"""The For You product's query.

Counterpart of ``the_algorithm_tpu/mixers/home_mixer.py:42-50`` (a host copy
of :class:`ForYouQuery` only; the per-request pipeline comes later).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence


@dataclasses.dataclass
class ForYouQuery:
    """The PipelineQuery analog for the For You product."""

    user_id: int
    followed_authors: Sequence[int] = ()
    seen_tweet_ids: frozenset = frozenset()
    max_results: int = 50
    now: int = 0
    features: Dict[str, object] = dataclasses.field(default_factory=dict)
