"""Pushservice: the notification recommender pipeline.

Counterpart of ``the_algorithm_tpu/mixers/pushservice.py``, copied; the
rankers' outputs reach the host explicitly (a predict function may return
tensors on the card), and a source that raises is skipped (fail-open) as
in the reference, so a check of the card calls each source directly.

≡ ``pushservice/src/main/scala/com/twitter/frigate/pushservice/`` (SURVEY.md
§2.1): refresh handler → target building (is the user reachable? device,
fatigue, open rate) → candidate sources (incl. the SimClusters
push-open-based index) → hydration → **light ranking** (MLP,
``model_pools_mlp.py``) → take (top-1 with fatigue bookkeeping) after
**heavy ranking** (ClemNet multi-task: open/favorite probabilities).

In-process: target building is a predicate stack; candidates come from any
framework CandidateSource; the rankers are the JAX push models behind
batched predict fns; the take step enforces per-user notification budgets.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from the_algorithm_tpu_torch.core.device import host_array
from the_algorithm_tpu_torch.pipeline.component import Candidate, CandidateSource


@dataclasses.dataclass
class PushTarget:
    """≡ target building output (``refresh_handler/`` + target predicates)."""

    user_id: int
    has_device: bool = True
    notifications_enabled: bool = True
    recent_notification_count: int = 0
    last_notification_ts: int = 0
    open_rate: float = 0.5


@dataclasses.dataclass(frozen=True)
class FatiguePolicy:
    """≡ the take-step fatigue rules: per-day budget + minimum spacing."""

    max_per_day: int = 4
    min_interval_s: int = 4 * 3600


def target_is_eligible(
    target: PushTarget, now: int, policy: FatiguePolicy
) -> bool:
    """Target predicates (device, settings, fatigue)."""
    if not (target.has_device and target.notifications_enabled):
        return False
    if target.recent_notification_count >= policy.max_per_day:
        return False
    if now - target.last_notification_ts < policy.min_interval_s:
        return False
    return True


@dataclasses.dataclass
class PushPipeline:
    """target predicates → candidates → pre-ranking predicates → light rank
    (truncate) → heavy rank → per-type fatigue take → NTab write.

    The predicate stacks mirror the reference's ``predicate/`` catalog
    (``PreRankingPredicates``, ``HealthPredicates``, ``FatiguePredicate``,
    ``TargetPredicates``); build them from
    :mod:`the_algorithm_tpu_torch.mixers.push_candidates`.
    """

    sources: Sequence[CandidateSource]
    light_predict: Callable[[np.ndarray], np.ndarray]  # [B, F] -> [B]
    heavy_predict: Callable[[np.ndarray], np.ndarray]  # [B, F] -> [B, H]
    featurize: Callable[[PushTarget, Candidate], np.ndarray]
    heavy_head_weights: np.ndarray  # [H] (e.g. open, fav heads)
    light_keep: int = 64  # light-ranker truncation before the heavy model
    policy: FatiguePolicy = FatiguePolicy()
    # extended predicate stacks (each optional; empty = legacy behavior)
    target_predicates: Sequence[Callable] = ()  # (target, now) -> bool
    candidate_predicates: Sequence[Callable] = ()  # (target, cand) -> bool
    batch_candidate_predicates: Sequence[Callable] = ()  # (target, [c]) -> [bool]
    ntab: Optional["object"] = None  # push_candidates.NTabStore
    fatigue_config: Optional["object"] = None  # push_candidates.PushFatigueConfig

    def run(self, target: PushTarget, now: int) -> Optional[Candidate]:
        """Returns the single notification to send (recorded in NTab), or
        None."""
        if not target_is_eligible(target, now, self.policy):
            return None
        for pred in self.target_predicates:
            if not pred(target, now):
                return None
        candidates: List[Candidate] = []
        seen = set()
        for src in self.sources:
            try:
                for c in src.get(target, None):
                    if c.id not in seen:
                        seen.add(c.id)
                        candidates.append(c)
            except Exception:
                continue  # source fail-open
        # pre-ranking predicates (scalar then batch)
        for pred in self.candidate_predicates:
            candidates = [c for c in candidates if pred(target, c)]
        for bpred in self.batch_candidate_predicates:
            keep = bpred(target, candidates)
            candidates = [c for c, k in zip(candidates, keep) if k]
        # per-type fatigue over NTab history (the take-step gate applied
        # pre-ranking so fatigued types don't crowd the light ranker)
        if self.ntab is not None and self.fatigue_config is not None:
            from the_algorithm_tpu_torch.mixers import push_candidates as pc

            allowed: dict = {}
            kept = []
            for c in candidates:
                crt = c.features.get("crt")
                if crt is None:
                    kept.append(c)
                    continue
                if crt not in allowed:
                    allowed[crt] = pc.crt_allowed(
                        self.ntab, target.user_id, crt, now,
                        self.fatigue_config,
                    )
                if allowed[crt]:
                    kept.append(c)
            candidates = kept
        if not candidates:
            return None

        feats = np.stack([self.featurize(target, c) for c in candidates])
        light = host_array(self.light_predict(feats)).reshape(-1)
        order = np.argsort(-light)[: self.light_keep]
        kept = [candidates[i] for i in order]
        kept_feats = feats[order]

        heavy = host_array(self.heavy_predict(kept_feats))  # [B, H]
        combined = heavy @ self.heavy_head_weights
        best = int(np.argmax(combined))
        winner = kept[best]
        winner.score = float(combined[best])
        winner.features["push_light_score"] = float(light[order][best])
        if self.ntab is not None:
            from the_algorithm_tpu_torch.mixers import push_candidates as pc

            crt = winner.features.get("crt", pc.CRT.IN_NETWORK_TWEET)
            self.ntab.record_sent(
                target.user_id,
                pc.SentNotification(tweet_id=winner.id, crt=crt, sent_at=now),
            )
        return winner
