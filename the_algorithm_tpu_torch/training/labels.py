"""Training-label closure: served-candidate logs × UUA events → head labels.

A host copy of ``the_algorithm_tpu/training/labels.py`` (numpy; the JAX
package's modules cannot be imported without JAX): each tweet the home
pipeline *served* becomes one training example whose per-head binary labels
come from the viewer's subsequent UUA engagements inside an attribution
window. :data:`HEAD_LABEL_RULES` binds MaskNet's 15 heads
(``models/masknet.py``'s ``DEFAULT_HEAD_NAMES``) to UUA action semantics,
the derived "good click" labels (click + ≥2 min dwell) included.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from the_algorithm_tpu_torch.actions.uua import ActionType, UnifiedUserAction

GOOD_CLICK_DWELL_S = 120  # the 2-minute conv-dwell bar for "good click"
DWELL_LABEL_S = 10  # linger threshold for the dwell head


@dataclasses.dataclass(frozen=True)
class LabelRule:
    """One head's labeling semantics over a (user, tweet) action set."""

    head: str
    action_types: frozenset  # any of these fires the label...
    min_dwell_s: float = 0.0  # ...if metadata dwell reaches this
    needs_meta: Optional[str] = None  # truthy metadata key required


def _r(head, types, **kw):
    return LabelRule(head, frozenset(types), **kw)


# head order MUST match masknet.DEFAULT_HEAD_NAMES
HEAD_LABEL_RULES: Tuple[LabelRule, ...] = (
    _r("fav", {ActionType.CLIENT_TWEET_FAV}),
    _r("reply", {ActionType.CLIENT_TWEET_REPLY}),
    _r("retweet", {ActionType.CLIENT_TWEET_RETWEET,
                   ActionType.CLIENT_TWEET_QUOTE}),
    _r("reply_engaged_by_author", {ActionType.CLIENT_TWEET_REPLY},
       needs_meta="engaged_by_author"),
    # good click v1: click followed by ≥2min dwell in the conversation
    _r("good_click_convo", {ActionType.CLIENT_TWEET_CLICK},
       min_dwell_s=GOOD_CLICK_DWELL_S),
    # good click v2: profile click with ≥ the dwell bar
    _r("good_click_profile", {ActionType.CLIENT_PROFILE_VISIT},
       min_dwell_s=GOOD_CLICK_DWELL_S),
    _r("good_profile_click", {ActionType.CLIENT_PROFILE_VISIT},
       needs_meta="engaged"),
    _r("video_quality_view", {ActionType.CLIENT_TWEET_VIDEO_QUALITY_VIEW}),
    _r("bookmark", {ActionType.CLIENT_TWEET_BOOKMARK}),
    _r("share", {ActionType.CLIENT_TWEET_SHARE}),
    _r("dwell", {ActionType.CLIENT_TWEET_LINGER}, min_dwell_s=DWELL_LABEL_S),
    _r("open_link", {ActionType.CLIENT_TWEET_OPEN_LINK}),
    _r("screenshot", {ActionType.CLIENT_TWEET_SCREENSHOT}),
    _r("negative_feedback_v2", {
        ActionType.CLIENT_TWEET_NOT_INTERESTED, ActionType.CLIENT_BLOCK,
        ActionType.CLIENT_MUTE,
    }),
    _r("report", {ActionType.CLIENT_TWEET_REPORT}),
)
HEAD_NAMES: Tuple[str, ...] = tuple(r.head for r in HEAD_LABEL_RULES)


def _rule_fires(rule: LabelRule, a: UnifiedUserAction) -> bool:
    if a.action_type not in rule.action_types:
        return False
    if rule.min_dwell_s and float(
        a.metadata.get("dwell_s", 0.0)
    ) < rule.min_dwell_s:
        return False
    if rule.needs_meta and not a.metadata.get(rule.needs_meta):
        return False
    return True


@dataclasses.dataclass(frozen=True)
class ServedCandidate:
    """One row of the served-candidates scribe log."""

    user_id: int
    tweet_id: int
    served_at: int  # seconds
    predicted: Mapping[str, float] = dataclasses.field(default_factory=dict)


def parse_served_log(lines: Iterable[str]) -> List[ServedCandidate]:
    """Decode ``ScribeServedCandidatesSideEffect`` JSON lines."""
    out: List[ServedCandidate] = []
    for line in lines:
        rec = json.loads(line)
        for c in rec["candidates"]:
            out.append(ServedCandidate(
                user_id=int(rec["user_id"]),
                tweet_id=int(c["tweet_id"]),
                served_at=int(rec["served_at"]),
                predicted=c.get("predicted", {}),
            ))
    return out


def join_labels(
    served: Sequence[ServedCandidate],
    actions: Sequence[UnifiedUserAction],
    *,
    attribution_window_s: int = 24 * 3600,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(user_ids [N], tweet_ids [N], served_at [N], labels [N, H]).

    An action attributes to a served impression iff same (user, tweet) and
    ``served_at ≤ t < served_at + window`` (the offline label join; dedup:
    one example per (user, tweet, served_at), any qualifying action sets
    the head to 1).
    """
    by_key: Dict[Tuple[int, int], List[UnifiedUserAction]] = {}
    for a in actions:
        by_key.setdefault((int(a.user_id), int(a.item_id)), []).append(a)

    seen = set()
    users, tweets, ts, labels = [], [], [], []
    for s in served:
        key = (s.user_id, s.tweet_id, s.served_at)
        if key in seen:
            continue
        seen.add(key)
        row = np.zeros(len(HEAD_LABEL_RULES), np.float32)
        for a in by_key.get((s.user_id, s.tweet_id), ()):
            t = a.timestamp_ms / 1000.0
            if not (s.served_at <= t < s.served_at + attribution_window_s):
                continue
            for h, rule in enumerate(HEAD_LABEL_RULES):
                if row[h] == 0.0 and _rule_fires(rule, a):
                    row[h] = 1.0
        users.append(s.user_id)
        tweets.append(s.tweet_id)
        ts.append(s.served_at)
        labels.append(row)
    if not users:
        H = len(HEAD_LABEL_RULES)
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros((0, H), np.float32))
    return (
        np.asarray(users, np.int64), np.asarray(tweets, np.int64),
        np.asarray(ts, np.int64), np.stack(labels),
    )


def build_training_examples(
    served_log_lines: Iterable[str],
    actions: Sequence[UnifiedUserAction],
    feature_fn,  # (user_ids [N], tweet_ids [N]) -> [N, F] features
    *,
    attribution_window_s: int = 24 * 3600,
    negative_downsample: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The full closure: scribe log + UUA stream + offline re-hydration →
    (features [N, F], labels [N, H]) ready for ``Trainer.fit`` (≡ the
    DataRecord training-data pipeline; ``feature_fn`` is the offline
    hydration join over the same stores the serve path read).

    ``negative_downsample``: keep-probability for all-zero-label examples
    (the reference downsamples negatives heavily; re-weight at train time).
    """
    served = parse_served_log(served_log_lines)
    users, tweets, _, labels = join_labels(
        served, actions, attribution_window_s=attribution_window_s
    )
    if negative_downsample < 1.0 and labels.shape[0]:
        rng = rng or np.random.default_rng(0)
        pos = labels.any(axis=1)
        keep = pos | (rng.random(labels.shape[0]) < negative_downsample)
        users, tweets, labels = users[keep], tweets[keep], labels[keep]
    feats = np.asarray(feature_fn(users, tweets), np.float32)
    return feats, labels
