"""Tweet-mixer: the OON candidate-generation coordinator.

A host copy of ``the_algorithm_tpu/mixers/tweet_mixer.py``. ≡
``tweet-mixer/`` (current-gen, supersedes cr-mixer — SURVEY.md §2.1): USS
source-signal extraction → parallel similarity engines → blending → light
filtering/truncation; plus memcached candidate caching (here an in-process
TTL cache). The blender is cr-mixer's ranked interleave
(``cr-mixer/server/.../blender/``): round-robin across engines in engine
priority order, dedup by first occurrence.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from the_algorithm_tpu_torch.core.config import Params
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidateSource


def interleave_blend(
    per_engine: Sequence[List[Candidate]],
    max_results: int,
) -> List[Candidate]:
    """Ranked round-robin interleave with first-wins dedup
    (≡ ``InterleaveBlender``): preserves each engine's internal order and
    balances across engines regardless of score scales."""
    out: List[Candidate] = []
    seen = set()
    idx = [0] * len(per_engine)
    while len(out) < max_results:
        progressed = False
        for e, cands in enumerate(per_engine):
            while idx[e] < len(cands):
                c = cands[idx[e]]
                idx[e] += 1
                if c.id not in seen:
                    seen.add(c.id)
                    out.append(c)
                    progressed = True
                    break
            if len(out) >= max_results:
                break
        if not progressed:
            break
    return out


@dataclasses.dataclass
class _CacheEntry:
    candidates: List[Candidate]
    expires_at: float


class TweetMixer:
    """Coordinator over similarity engines with TTL candidate caching.

    ≡ ``CandidateSourcesRouter`` + ``CrCandidateGenerator`` and the 10-min
    memcache TTL on DR-ANN candidates
    (``DeepRetrievalUserTweetANNCandidateSource.scala:24-61``).
    """

    def __init__(
        self,
        engines: Sequence[CandidateSource],
        max_results: int = 400,
        cache_ttl_s: float = 600.0,
        max_concurrency: int = 8,
    ):
        self.engines = list(engines)
        self.max_results = max_results
        self.cache_ttl_s = cache_ttl_s
        self._cache: Dict[Any, _CacheEntry] = {}
        # parallel engine fan-out (≡ the Finagle Future.collect over
        # similarity engines); kernel launches and device waits release the GIL
        self._pool = (ThreadPoolExecutor(max_workers=max_concurrency)
                      if max_concurrency > 1 else None)

    def get_candidates(
        self, query, params: Params = Params(), cache_key=None
    ) -> List[Candidate]:
        now = time.monotonic()
        if cache_key is not None:
            hit = self._cache.get(cache_key)
            if hit and hit.expires_at > now:
                return list(hit.candidates)

        def fetch(engine) -> List[Candidate]:
            try:
                return engine.get(query, params)
            except Exception:
                return []  # engine fail-open

        if self._pool is not None and len(self.engines) > 1:
            # futures keep engine order — blending stays deterministic
            per_engine = list(self._pool.map(fetch, self.engines))
        else:
            per_engine = [fetch(e) for e in self.engines]
        blended = interleave_blend(per_engine, self.max_results)

        if cache_key is not None:
            self._cache[cache_key] = _CacheEntry(
                list(blended), now + self.cache_ttl_s
            )
        return blended

    def close(self) -> None:
        """Stop the fan-out threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class TweetMixerSource(CandidateSource):
    """Expose a TweetMixer as a pipeline CandidateSource (home-mixer's
    TweetMixer candidate pipeline)."""

    def __init__(self, mixer: TweetMixer, name: str = "TweetMixer"):
        self.mixer = mixer
        self._name = name

    @property
    def name(self):
        return self._name

    def get(self, query, params) -> List[Candidate]:
        key = getattr(query, "user_id", None)
        return self.mixer.get_candidates(query, params, cache_key=key)
