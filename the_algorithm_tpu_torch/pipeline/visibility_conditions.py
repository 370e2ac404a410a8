"""Leaf module: visibility condition combinators.

A host copy of ``the_algorithm_tpu/pipeline/visibility_conditions.py``.

≡ ``visibilitylib/src/main/scala/com/twitter/visibility/rules/Condition.scala``
— the predicate algebra every rule family is composed from. Lives in its own
leaf module so both ``visibility_rules`` (core families + level policies) and
``visibility_rules_breadth`` (DM / Spaces / SafeSearch / card / AF families)
can import it in any order without a cycle.
"""

from __future__ import annotations

from typing import Callable, Mapping

Condition = Callable[[Mapping], bool]


def tweet_label(name: str) -> Condition:
    return lambda f: name in f.get("tweet_labels", ())


def author_label(name: str) -> Condition:
    return lambda f: name in f.get("author_labels", ())


def score_above(key: str, threshold: float) -> Condition:
    return lambda f: float(f.get(key, 0.0)) > threshold


def flag(key: str) -> Condition:
    return lambda f: bool(f.get(key, False))


def non_author(c: Condition) -> Condition:
    """≡ NonAuthorWithTweetLabelRule: never hide content from its author."""
    return lambda f: not f.get("viewer_is_author", False) and c(f)


def non_follower(c: Condition) -> Condition:
    """≡ NonFollowerWithTweetLabelRule: followers opted in by following."""
    return lambda f: (
        not f.get("viewer_is_author", False)
        and not f.get("viewer_follows_author", False)
        and c(f)
    )


def all_of(*cs: Condition) -> Condition:
    return lambda f: all(c(f) for c in cs)


def any_of(*cs: Condition) -> Condition:
    return lambda f: any(c(f) for c in cs)


def not_(c: Condition) -> Condition:
    return lambda f: not c(f)


def muted_keyword(f) -> bool:
    """≡ MutedKeywordRules: viewer's muted keyword appears in the tweet."""
    muted = f.get("viewer_muted_keywords", ())
    toks = f.get("tweet_keywords", ())
    return bool(set(muted) & set(toks))
