"""Typed config/param system.

A copy of ``the_algorithm_tpu/core/config.py`` (stdlib only; that module's
package imports JAX): configapi-style typed per-request params
(``ParamsBuilder.scala``, ``FSParam``/``FSBoundedParam``) and model/job
config objects.

  - ``Param[T]``: a named, typed knob with a default (and optional bounds).
  - ``Params``: an immutable resolution context: ``params(MyParam)`` returns
    the override if present else the default. Built per-request (serving) or
    per-run (training) from a plain dict — the stand-in for experiment
    bucketing / feature-switch resolution.
  - ``param_scope``: context manager layering ambient overrides (tests).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Generic, Iterator, Mapping, Optional, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class Param(Generic[T]):
    """A typed parameter with a default value and optional bounds."""

    name: str
    default: T
    lo: Optional[T] = None
    hi: Optional[T] = None

    def clamp(self, value: T) -> T:
        if self.lo is not None and value < self.lo:  # type: ignore[operator]
            return self.lo
        if self.hi is not None and value > self.hi:  # type: ignore[operator]
            return self.hi
        return value

    def __hash__(self) -> int:
        return hash(self.name)


_ambient = threading.local()


def _ambient_overrides() -> Dict[str, Any]:
    if not hasattr(_ambient, "stack"):
        _ambient.stack = []
    merged: Dict[str, Any] = {}
    for layer in _ambient.stack:
        merged.update(layer)
    return merged


class Params:
    """Immutable param-resolution context.

    Resolution order: explicit overrides > ambient ``param_scope`` layers >
    param default. Bounded params are clamped (mirroring ``FSBoundedParam``).
    """

    def __init__(self, overrides: Optional[Mapping[Any, Any]] = None):
        norm: Dict[str, Any] = {}
        for k, v in dict(overrides or {}).items():
            norm[k.name if isinstance(k, Param) else str(k)] = v
        self._overrides = norm

    def __call__(self, param: Param[T]) -> T:
        if param.name in self._overrides:
            return param.clamp(self._overrides[param.name])
        ambient = _ambient_overrides()
        if param.name in ambient:
            return param.clamp(ambient[param.name])
        return param.default

    def with_overrides(self, more: Mapping[Any, Any]) -> "Params":
        merged = dict(self._overrides)
        for k, v in dict(more).items():
            merged[k.name if isinstance(k, Param) else str(k)] = v
        return Params(merged)

    def overrides(self) -> Mapping[str, Any]:
        return dict(self._overrides)

    def __repr__(self) -> str:
        return f"Params({self._overrides!r})"


EMPTY_PARAMS = Params()


@contextlib.contextmanager
def param_scope(overrides: Mapping[Any, Any]) -> Iterator[None]:
    """Layer ambient param overrides for the duration of the context."""
    if not hasattr(_ambient, "stack"):
        _ambient.stack = []
    norm = {
        (k.name if isinstance(k, Param) else str(k)): v
        for k, v in dict(overrides).items()
    }
    _ambient.stack.append(norm)
    try:
        yield
    finally:
        _ambient.stack.pop()
