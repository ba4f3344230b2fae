"""Declarative SLOs with rolling-window evaluation.

The deadline-shedding scheduler exists to protect a latency objective;
this module watches that objective from inside the server:

    server.register("lenet", program,
                    slo=obs.SLO(p99_ms=50.0, max_shed_rate=0.05))

:class:`SLO` declares the objectives; :class:`SLOMonitor` keeps a
rolling window of request outcomes (served / shed / failed, with
latencies) and evaluates the objectives on every observation — but at
most once per ``eval_every_s`` (default ``window_s / 8``) so a
saturated server is not computing percentiles per request. A breach
report names the objective, the measured value and the limit; the
``Server`` turns reports into ``slo.breach.<program>`` counter
increments, a structured log event and a rate-limited flight dump.

Timestamps are caller-supplied seconds (the serving runtime passes its
injectable ``Clock``), so the whole engine is deterministic under
``VirtualClock`` in tests.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

KINDS = ("served", "shed", "failed")


@dataclass(frozen=True)
class SLO:
    """Per-program service-level objectives over a rolling window.

    Any subset of objectives may be set (at least one must be):

    * ``p99_ms`` — 99th-percentile served latency must stay below this.
    * ``max_shed_rate`` — fraction of window requests deadline-shed.
    * ``max_error_rate`` — fraction of window requests failed
      (``WorkerError``).
    * ``window_s`` — rolling window length in seconds.
    * ``min_count`` — objectives are not evaluated until the window
      holds at least this many outcomes (a 1-request window has a
      meaningless p99).
    * ``eval_every_s`` — minimum spacing between evaluations; ``None``
      means ``max(window_s / 8, 0.25)``. Pass ``0`` to evaluate on
      every observation (tests).
    """

    p99_ms: Optional[float] = None
    max_shed_rate: Optional[float] = None
    max_error_rate: Optional[float] = None
    window_s: float = 60.0
    min_count: int = 1
    eval_every_s: Optional[float] = None

    def __post_init__(self):
        if (self.p99_ms is None and self.max_shed_rate is None
                and self.max_error_rate is None):
            raise ValueError("SLO needs at least one objective "
                             "(p99_ms / max_shed_rate / max_error_rate)")
        if self.p99_ms is not None and self.p99_ms <= 0:
            raise ValueError(f"p99_ms must be > 0, got {self.p99_ms}")
        for fname in ("max_shed_rate", "max_error_rate"):
            v = getattr(self, fname)
            if v is not None and not (0.0 <= v <= 1.0):
                raise ValueError(f"{fname} must be in [0, 1], got {v}")
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if self.min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {self.min_count}")
        if self.eval_every_s is not None and self.eval_every_s < 0:
            raise ValueError(f"eval_every_s must be >= 0, "
                             f"got {self.eval_every_s}")

    @property
    def eval_spacing_s(self) -> float:
        if self.eval_every_s is not None:
            return self.eval_every_s
        return max(self.window_s / 8.0, 0.25)


class SLOMonitor:
    """Rolling-window evaluator for one hosted program's :class:`SLO`."""

    def __init__(self, name: str, slo: SLO):
        self.name = name
        self.slo = slo
        self._lock = threading.Lock()
        self._window: deque = deque()     # (t_s, kind, latency_ms | None)
        self._breach_counts: Dict[str, int] = {}
        self._last_eval_t: Optional[float] = None
        self._last_breach_t: Optional[float] = None

    # -- feeding -----------------------------------------------------------

    def observe(self, kind: str, t: float,
                latency_ms: Optional[float] = None) -> List[Dict]:
        """Record one request outcome at time ``t`` (seconds).

        Returns the list of *new* breach reports from this evaluation
        tick (usually empty; also empty between throttled ticks).
        """
        if kind not in KINDS:
            raise ValueError(f"unknown outcome {kind!r}; expected one of "
                             f"{KINDS}")
        with self._lock:
            self._window.append((t, kind, latency_ms))
            self._prune(t)
            if (self._last_eval_t is not None
                    and t - self._last_eval_t < self.slo.eval_spacing_s):
                return []
            self._last_eval_t = t
            breaches = self._evaluate(t)
            if breaches:
                self._last_breach_t = t
                for b in breaches:
                    obj = b["objective"]
                    self._breach_counts[obj] = \
                        self._breach_counts.get(obj, 0) + 1
            return breaches

    def _prune(self, t: float) -> None:
        # caller holds self._lock
        horizon = t - self.slo.window_s
        window = self._window
        while window and window[0][0] < horizon:
            window.popleft()

    # -- evaluating --------------------------------------------------------

    def _values(self) -> Dict[str, Optional[float]]:
        # caller holds self._lock
        n = len(self._window)
        out: Dict[str, Optional[float]] = {"n": n, "p99_ms": None,
                                           "shed_rate": None,
                                           "error_rate": None}
        if n == 0:
            return out
        shed = sum(1 for _, kind, _ in self._window if kind == "shed")
        failed = sum(1 for _, kind, _ in self._window if kind == "failed")
        out["shed_rate"] = shed / n
        out["error_rate"] = failed / n
        lats = [lat for _, kind, lat in self._window
                if kind == "served" and lat is not None]
        if lats:
            out["p99_ms"] = float(np.percentile(lats, 99))
        return out

    def _evaluate(self, t: float) -> List[Dict]:
        # caller holds self._lock
        slo = self.slo
        vals = self._values()
        if vals["n"] < slo.min_count:
            return []
        breaches = []

        def breach(objective, value, limit):
            breaches.append({"objective": objective, "value": value,
                             "limit": limit, "window_s": slo.window_s,
                             "n": vals["n"]})

        if (slo.p99_ms is not None and vals["p99_ms"] is not None
                and vals["p99_ms"] > slo.p99_ms):
            breach("p99_ms", vals["p99_ms"], slo.p99_ms)
        if (slo.max_shed_rate is not None
                and vals["shed_rate"] > slo.max_shed_rate):
            breach("shed_rate", vals["shed_rate"], slo.max_shed_rate)
        if (slo.max_error_rate is not None
                and vals["error_rate"] > slo.max_error_rate):
            breach("error_rate", vals["error_rate"], slo.max_error_rate)
        return breaches

    # -- reading -----------------------------------------------------------

    def state(self, t: Optional[float] = None) -> Dict:
        """Current window values vs limits (the ``/statusz`` SLO block)."""
        slo = self.slo
        with self._lock:
            if t is not None:
                self._prune(t)
            vals = self._values()
            return {
                "window_s": slo.window_s,
                "n": vals["n"],
                "objectives": {
                    "p99_ms": {"value": vals["p99_ms"], "limit": slo.p99_ms},
                    "shed_rate": {"value": vals["shed_rate"],
                                  "limit": slo.max_shed_rate},
                    "error_rate": {"value": vals["error_rate"],
                                   "limit": slo.max_error_rate},
                },
                "breaches": dict(self._breach_counts),
                "last_breach_t": self._last_breach_t,
            }
