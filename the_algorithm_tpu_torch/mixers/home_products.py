"""Home timeline products: for now only the exact-tier experiment param.

Counterpart of ``the_algorithm_tpu/mixers/home_products.py:49``; the
products themselves come later.
"""

from __future__ import annotations

from the_algorithm_tpu_torch.core.config import Param

# quality-tier experiment param: force a request into (True) or out of
# (False) the EXACT full-corpus retrieval tier; None defers to the sticky
# ``exact_retrieval_tier`` decider dial (the configapi FSParam pattern:
# experiment-bucketed per-request override over a fleet availability)
EXACT_RETRIEVAL_TIER: Param = Param("exact_retrieval_tier", None)
