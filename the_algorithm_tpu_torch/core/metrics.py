"""Lightweight metrics registry — the StatsReceiver analog.

A host copy of ``the_algorithm_tpu/core/metrics.py``: that package's
``core/__init__.py`` imports its JAX mesh module, so no module under it can
be imported without JAX.

The reference threads a Finagle ``StatsReceiver`` through every component
(e.g. ``simclusters-ann/server/.../SimClustersANNCandidateSource.scala:30-33``,
navi's Prometheus histograms ``navi/navi/src/metrics.rs:268-290``). Here a
process-local registry provides scoped counters / gauges / stats (histogram
percentiles), a ``time`` context, and a Prometheus-style text export for the
serving edge.

:func:`span` names a section of the program in an operator's
``torch.profiler`` trace; ``StatsReceiver.time`` opens one around the
section it times.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time as _time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a ``torch.profiler``
    session collects on this thread, so the section lands in the profile's
    trace on the device operations' clock; otherwise one shared null
    context, which creates no ``RecordFunction`` and reads no clock."""
    return record_function(name) if _profiler_enabled() else _OFF


class _Stat:
    """Value distribution with percentile readout over a uniform sample of
    at most ``cap`` values (Algorithm R, seeded per stat, so a stream reads
    the same percentiles every run). Values are kept unsorted and sorted
    when read."""

    __slots__ = ("values", "count", "total", "_cap", "_rng")

    def __init__(self, cap: int = 4096):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self._cap = cap
        self._rng = random.Random(0)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self.values) < self._cap:
            self.values.append(v)
        else:  # the count-th value replaces a kept one with probability cap / count
            slot = self._rng.randrange(self.count)
            if slot < self._cap:
                self.values[slot] = v

    def percentile(self, p: float) -> float:
        if not self.values:
            return 0.0
        kept = sorted(self.values)
        return kept[min(len(kept) - 1, int(p / 100.0 * len(kept)))]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class StatsReceiver:
    """Scoped counters/gauges/stats. ``scope()`` returns a child view."""

    def __init__(self, prefix: str = "", _root: Optional["StatsReceiver"] = None):
        self._prefix = prefix
        if _root is None:
            self._lock = threading.Lock()
            self._counters: Dict[str, int] = {}
            self._gauges: Dict[str, float] = {}
            self._stats: Dict[str, _Stat] = {}
            self._root = self
        else:
            self._root = _root

    def _key(self, name: str) -> str:
        return f"{self._prefix}/{name}" if self._prefix else name

    def scope(self, name: str) -> "StatsReceiver":
        child = StatsReceiver(self._key(name), _root=self._root)
        return child

    def counter(self, name: str, delta: int = 1) -> None:
        root = self._root
        with root._lock:
            root._counters[self._key(name)] = (
                root._counters.get(self._key(name), 0) + delta
            )

    def gauge(self, name: str, value: float) -> None:
        root = self._root
        with root._lock:
            root._gauges[self._key(name)] = float(value)

    def stat(self, name: str, value: float) -> None:
        root = self._root
        with root._lock:
            root._stats.setdefault(self._key(name), _Stat()).add(float(value))

    @contextmanager
    def time(self, name: str):
        """Record elapsed milliseconds into a stat (mirrors ``Stats.track``),
        inside a :func:`span` of the stat's scoped name."""
        with span(self._key(name)):
            t0 = _time.perf_counter()
            try:
                yield
            finally:
                self.stat(name + "_ms", (_time.perf_counter() - t0) * 1e3)

    # -- readout ------------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        return dict(self._root._counters)

    def gauges(self) -> Dict[str, float]:
        return dict(self._root._gauges)

    def stat_summary(
        self, name: str, percentiles: Sequence[float] = (50, 90, 99)
    ) -> Dict[str, float]:
        s = self._root._stats.get(self._key(name))
        if s is None:
            return {}
        out = {"count": float(s.count), "mean": s.mean}
        for p in percentiles:
            out[f"p{int(p)}"] = s.percentile(p)
        return out

    def export_prometheus(self) -> str:
        """Prometheus text format (navi ``metrics.rs:268-290`` analog)."""
        lines: List[str] = []
        root = self._root
        with root._lock:
            for k, v in sorted(root._counters.items()):
                lines.append(f'{_sanitize(k)}_total {v}')
            for k, v in sorted(root._gauges.items()):
                lines.append(f"{_sanitize(k)} {v}")
            for k, s in sorted(root._stats.items()):
                base = _sanitize(k)
                lines.append(f"{base}_count {s.count}")
                lines.append(f"{base}_sum {s.total}")
                for p in (50, 90, 99):
                    lines.append(
                        f'{base}{{quantile="0.{p}"}} {s.percentile(p)}'
                    )
        return "\n".join(lines) + "\n"


def _sanitize(name: str) -> str:
    return name.replace("/", ":").replace("-", "_").replace(" ", "_")


class NullStats(StatsReceiver):
    """No-op receiver (the null-object pattern, cf. reference NoopHydrator)."""

    def __init__(self):
        super().__init__()

    def counter(self, name: str, delta: int = 1) -> None:  # noqa: D102
        pass

    def gauge(self, name: str, value: float) -> None:  # noqa: D102
        pass

    def stat(self, name: str, value: float) -> None:  # noqa: D102
        pass
