"""Named counters / gauges / histograms behind a registry.

The machinery under ``serve.metrics.ProgramMetrics`` (a facade over a
private :class:`Registry` per hosted program) plus one process-wide
:data:`REGISTRY` for runtime-global signals: plan-cache hits/misses,
per-strategy conv dispatch counts, fused-segment fallbacks.

All metrics in one registry share a single lock, so a registry
``snapshot()`` is internally consistent (every value from the same
instant) — the property ``Server.stats()`` has always promised. Metrics
are always-on (an increment is one lock + one add; the hooks sit at
per-batch / per-compile granularity, never per-element), unlike tracing
which is off by default.

Naming convention (dotted, lowercase, the reference package's names):
``<subsystem>.<object>.<signal>``, e.g.
``plan.cache.hit``, ``dispatch.conv.strip``, ``serve.lenet.submitted``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def get(self) -> int:
        with self._lock:
            return self.value


class Gauge:
    """A value that goes up and down (queue depths, in-flight counts)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += delta

    def get(self) -> float:
        with self._lock:
            return self.value


# Default histogram buckets: ratios in [0, 1] (padding waste, batch
# occupancy). Callers with other domains pass their own boundaries.
RATIO_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max.

    ``buckets`` are upper bounds (``le`` semantics, Prometheus-style); an
    implicit +Inf bucket catches the rest.
    """

    __slots__ = ("name", "buckets", "counts", "sum", "count",
                 "min", "max", "_lock")

    def __init__(self, name: str, lock: threading.RLock,
                 buckets: Sequence[float] = RATIO_BUCKETS):
        self.name = name
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            i = 0
            for i, le in enumerate(self.buckets):      # noqa: B007
                if v <= le:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": (self.sum / self.count) if self.count else 0.0,
                "min": self.min,
                "max": self.max,
                "buckets": {
                    **{f"le_{le:g}": c
                       for le, c in zip(self.buckets, self.counts)},
                    "le_inf": self.counts[-1]},
            }


class Registry:
    """A namespace of metrics sharing one lock (consistent snapshots)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, object] = {}

    def _get_or_make(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_make(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_make(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = RATIO_BUCKETS) -> Histogram:
        return self._get_or_make(name, Histogram, buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Every metric's value, read under one lock acquisition."""
        with self._lock:
            out: Dict[str, object] = {}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                out[name] = (m.summary() if isinstance(m, Histogram)
                             else m.value)
            return out

    def reset(self) -> None:
        """Drop every metric (tests; never called by the runtime)."""
        with self._lock:
            self._metrics.clear()


# The process-wide registry: runtime-global signals (plan cache, kernel
# dispatch). Per-program serving metrics live in per-ProgramMetrics
# registries so two Servers hosting the same program name never alias.
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = RATIO_BUCKETS
              ) -> Histogram:
    return REGISTRY.histogram(name, buckets)
