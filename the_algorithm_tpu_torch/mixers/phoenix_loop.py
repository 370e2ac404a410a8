"""The Phoenix serving↔training loop: rescoring hydration + logged serves.

≡ the three home-mixer Phoenix loop pieces the r3 scorer lacked:

- ``feature_hydrator/PhoenixRescoringFeatureHydrator.scala`` — previously
  computed Phoenix head scores hydrate onto the SAME candidates on the
  next request (from the store the side effect feeds), as
  ``phoenix_rescoring_<head>`` features;
- ``side_effect/ScoredPhoenixCandidatesKafkaSideEffect.scala`` — every
  serve appends the scored candidates (head probabilities + context) to
  the training log AND the rescoring store;
- ``scorer/PhoenixModelRerankingScorer.scala`` — a selectable reranking
  stage blending the heavy-ranker score with the (fresher) Phoenix
  rescoring signal.

The loop closes through training: :func:`training_batch` converts the
logged serves (joined with observed next actions) into
``models.phoenix`` training arrays, so serve → log → retrain → rescore
is one test-verified cycle.

Counterpart of ``the_algorithm_tpu/mixers/phoenix_loop.py`` (host code; the
reranker's weighted combination runs on the host in f32, and
:func:`training_batch` returns tensors on the CPU).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.metrics import NullStats
from the_algorithm_tpu_torch.mixers.phoenix_scorer import (
    PHOENIX_HEADS, PhoenixHead, candidate_bool_features)
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.models.phoenix import NUM_ACTIONS, CandidateFeatures
from the_algorithm_tpu_torch.pipeline.component import (
    Candidate,
    FeatureHydrator,
    Scorer,
    SideEffect,
)

HEAD_NAMES: Tuple[str, ...] = tuple(h.name for h in PHOENIX_HEADS)


class PhoenixScoreStore:
    """(user_id, tweet_id) → per-head Phoenix scores with TTL.

    The memcache the Kafka side effect feeds and the rescoring hydrator
    reads — scores age out like the reference's cache TTL.
    """

    def __init__(self, ttl_s: float = 30 * 60.0, now_fn=None):
        self._ttl = ttl_s
        self._now = now_fn or time.monotonic
        self._lock = threading.Lock()
        self._map: Dict[Tuple[int, int], Tuple[float, np.ndarray]] = {}

    def put(self, user_id: int, tweet_id: int, scores: np.ndarray) -> None:
        with self._lock:
            self._map[(int(user_id), int(tweet_id))] = (
                self._now(), np.asarray(scores, np.float32))

    def get(self, user_id: int, tweet_id: int) -> Optional[np.ndarray]:
        with self._lock:
            hit = self._map.get((int(user_id), int(tweet_id)))
        if hit is None or self._now() - hit[0] > self._ttl:
            return None
        return hit[1]

    def __len__(self) -> int:
        return len(self._map)


class ServedPhoenixRecord(NamedTuple):
    """One logged (request, candidate) serve — the Kafka topic row."""

    user_id: int
    tweet_id: int
    author_id: int
    served_ts: int
    head_scores: np.ndarray  # [H] phoenix head probabilities
    bool_features: np.ndarray  # [NB] candidate bool features
    position: int  # served rank


class ScoredPhoenixCandidatesSideEffect(SideEffect):
    """≡ ``ScoredPhoenixCandidatesKafkaSideEffect``: after each serve,
    publish the Phoenix-scored candidates to the training log and refresh
    the rescoring store."""

    def __init__(self, store: PhoenixScoreStore,
                 log: Optional[List[ServedPhoenixRecord]] = None,
                 stats=None):
        self.store = store
        self.log: List[ServedPhoenixRecord] = log if log is not None else []
        self.stats = stats or NullStats()

    def run(self, query, result: Sequence[Candidate], params) -> None:
        uid = int(getattr(query, "user_id", 0))
        now = int(getattr(query, "now", 0))
        n = 0
        for pos, c in enumerate(result):
            scores = np.asarray(
                [float(c.features.get(f"phoenix_{h}", 0.0))
                 for h in HEAD_NAMES], np.float32)
            if not np.any(scores):
                continue  # not phoenix-scored this serve
            self.store.put(uid, c.id, scores)
            self.log.append(ServedPhoenixRecord(
                user_id=uid, tweet_id=int(c.id),
                author_id=int(c.features.get("author_id", -1)),
                served_ts=now, head_scores=scores,
                bool_features=candidate_bool_features(c), position=pos))
            n += 1
        self.stats.counter("phoenix/served_candidates", n)


class PhoenixRescoringFeatureHydrator(FeatureHydrator):
    """≡ ``PhoenixRescoringFeatureHydrator``: on the next request, attach
    the previously served Phoenix head scores as
    ``phoenix_rescoring_<head>`` candidate features (None-safe: absent
    pairs hydrate nothing, the scorer falls back)."""

    def __init__(self, store: PhoenixScoreStore):
        self.store = store

    def hydrate(self, query, candidates, params) -> None:
        uid = int(getattr(query, "user_id", 0))
        for c in candidates:
            scores = self.store.get(uid, c.id)
            if scores is None:
                continue
            for j, h in enumerate(HEAD_NAMES):
                c.features[f"phoenix_rescoring_{h}"] = float(scores[j])
            c.features["phoenix_rescoring_available"] = 1.0


class PhoenixModelRerankingScorer(Scorer):
    """≡ ``PhoenixModelRerankingScorer``: blend the heavy-ranker combined
    score with the Phoenix rescoring signal where available.

    new_score = (1-α)·masknet_score + α·phoenix_weighted, α only applied
    when the rescoring hydration found scores for the candidate.
    """

    def __init__(self, alpha: float = 0.5,
                 heads: Sequence[PhoenixHead] = PHOENIX_HEADS,
                 name: str = "PhoenixModelRerankingScorer"):
        self.alpha = alpha
        self.heads = list(heads)
        self._name = name

    @property
    def name(self):
        return self._name

    def score(self, query, candidates, params) -> None:
        weights = torch.tensor([h.weight for h in self.heads], dtype=torch.float32)
        rescored = [c for c in candidates
                    if c.features.get("phoenix_rescoring_available")]
        if not rescored:
            return
        probs = np.asarray([
            [float(c.features.get(f"phoenix_rescoring_{h.name}", 0.0))
             for h in self.heads] for c in rescored
        ], np.float32)
        combined = masknet.weighted_model_score(
            torch.from_numpy(probs), weights).numpy()
        for c, p in zip(rescored, combined):
            base = c.score if c.score is not None else 0.0
            c.score = (1 - self.alpha) * base + self.alpha * float(p)
            c.features["phoenix_reranked"] = 1.0


# -- log → training arrays (the Kafka-topic → deepbird dataset join) ----------


def training_batch(
    log: Sequence[ServedPhoenixRecord],
    engagements: Dict[Tuple[int, int], Sequence[int]],  # (uid, tweet) -> actions
    user_sequences,  # uid -> UserActionSequence
    author_buckets: int,
    max_candidates: int,
):
    """Join served candidates with observed next actions → per-request
    training examples for ``models.phoenix`` (the offline label join the
    reference performs between the scored-candidates topic and UUA).

    Returns a list of (UserActionSequence, CandidateFeatures,
    labels [C, NUM_ACTIONS]) tuples, one per (user, serve) group.
    """
    by_request: Dict[Tuple[int, int], List[ServedPhoenixRecord]] = {}
    for r in log:
        by_request.setdefault((r.user_id, r.served_ts), []).append(r)

    out = []
    for (uid, ts), recs in sorted(by_request.items()):
        recs = recs[:max_candidates]
        C = max_candidates
        hashes = np.zeros(C, np.int32)
        bools = np.zeros((C, recs[0].bool_features.shape[0]), np.float32)
        valid = np.zeros(C, bool)
        labels = np.zeros((C, NUM_ACTIONS), np.float32)
        for i, r in enumerate(recs):
            hashes[i] = r.author_id % author_buckets
            bools[i] = r.bool_features
            valid[i] = True
            for a in engagements.get((r.user_id, r.tweet_id), ()):
                labels[i, int(a)] = 1.0
        out.append((
            user_sequences(uid),
            CandidateFeatures(
                torch.from_numpy(hashes), torch.from_numpy(bools),
                torch.from_numpy(valid)),
            torch.from_numpy(labels),
        ))
    return out
