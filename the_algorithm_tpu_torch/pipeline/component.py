"""The product-mixer candidate record.

Counterpart of ``the_algorithm_tpu/pipeline/component.py:28-37`` (a host
copy of :class:`Candidate` only; the component traits come with the
pipelines that need them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

FeatureMap = Dict[str, Any]


@dataclasses.dataclass
class Candidate:
    """≡ product-mixer ``CandidateWithFeatures``."""

    id: int
    features: FeatureMap = dataclasses.field(default_factory=dict)
    score: Optional[float] = None
    source: Optional[str] = None

    def get(self, feature: str, default=None):
        return self.features.get(feature, default)
