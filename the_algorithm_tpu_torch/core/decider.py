"""Deciders: runtime on/off dials with deterministic id bucketing.

A copy of ``the_algorithm_tpu/core/decider.py`` (whose package imports JAX),
hashing through the port's :func:`~the_algorithm_tpu_torch.core.hashing.murmur3_x64_128`:
the reference's ``RepresentationScorerDecider.scala`` availability dials and
``DeciderGateBuilderWithIdHashing.scala`` — a feature is enabled for a
fraction of traffic, optionally keyed by id so a given user/tweet gets a
stable decision (hash(id) mod 10000 < availability).
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional

from the_algorithm_tpu_torch.core.hashing import murmur3_x64_128

DECIDER_SCALE = 10000  # availability is per-mille*10, like the reference


class Decider:
    """Mutable registry of availability dials (0..10000)."""

    def __init__(self, availabilities: Optional[Dict[str, int]] = None):
        self._lock = threading.Lock()
        self._avail = dict(availabilities or {})

    def set_availability(self, feature: str, availability: int) -> None:
        with self._lock:
            self._avail[feature] = max(0, min(DECIDER_SCALE, availability))

    def availability(self, feature: str) -> int:
        with self._lock:
            return self._avail.get(feature, 0)

    def is_available(self, feature: str) -> bool:
        """Random-traffic gate (non-sticky): fraction of calls pass."""
        return random.randrange(DECIDER_SCALE) < self.availability(feature)

    def is_available_for_id(self, feature: str, id_: int) -> bool:
        """Sticky per-id gate ≡ DeciderGateBuilderWithIdHashing: the same id
        always gets the same decision at a given availability."""
        h, _ = murmur3_x64_128(f"{feature}:{id_}".encode("utf-8"))
        return (h % DECIDER_SCALE) < self.availability(feature)
