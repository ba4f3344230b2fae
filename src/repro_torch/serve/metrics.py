"""Serving metrics: request counters, latency percentiles, throughput,
padding waste — plain counters under one lock per hosted program.

The snapshot keeps the reference runtime's shape (``Server.stats()``), so
the two runtimes report alike; the histogram, Prometheus and trace layers
of the reference (``repro.obs``) are not ported yet.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

PERCENTILES = (50.0, 95.0, 99.0)
_MIN_WINDOW_S = 1e-9          # achieved_fps divisor clamp (clock ticks)


class ProgramMetrics:
    """Counters + latency reservoir for one hosted program (thread-safe)."""

    def __init__(self, window: int = 8192, name: str = "program"):
        self.name = name
        self._lock = threading.Lock()
        self.submitted = 0
        self.served = 0
        self.shed = 0
        self.rejected = 0
        self.failed = 0
        self.frames_served = 0
        self.batches = 0
        self.slots = 0
        self.queued_frames = 0
        self._latencies_ms: deque = deque(maxlen=window)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def record_admit(self, n_requests: int = 1) -> None:
        with self._lock:
            self.submitted += n_requests

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.shed += n

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def add_queued(self, delta: int) -> None:
        with self._lock:
            self.queued_frames += delta

    def record_batch(self, slots: int, t_dispatch: float) -> None:
        with self._lock:
            self.batches += 1
            self.slots += slots
            if self._t_first is None:
                self._t_first = t_dispatch

    def record_served(self, latency_s: float, frames: int,
                      t_done: float) -> None:
        with self._lock:
            self.served += 1
            self.frames_served += frames
            self._latencies_ms.append(latency_s * 1e3)
            self._t_last = t_done

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            lat = np.asarray(self._latencies_ms, np.float64)
            span = None
            if self._t_first is not None and self._t_last is not None:
                # first dispatch -> last completion, clamped so a single
                # batch within clock resolution stays finite
                span = max(self._t_last - self._t_first, _MIN_WINDOW_S)
            return {
                "requests": {
                    "submitted": self.submitted,
                    "served": self.served,
                    "shed_deadline": self.shed,
                    "rejected": self.rejected,
                    "failed": self.failed,
                    "pending": (self.submitted - self.served - self.shed
                                - self.failed),
                },
                "frames_served": self.frames_served,
                "queue_depth": self.queued_frames,
                "batches": self.batches,
                "avg_batch": (self.frames_served / self.batches
                              if self.batches else 0.0),
                "padding_waste": (1.0 - self.frames_served / self.slots
                                  if self.slots else 0.0),
                "achieved_fps": (self.frames_served / span if span else 0.0),
                "latency_ms": latency_summary(lat),
            }


def latency_summary(lat_ms: np.ndarray) -> Dict[str, float]:
    """p50/p95/p99 + mean/max of a latency sample (``{"count": 0}`` when
    empty, never NaN)."""
    if lat_ms.size == 0:
        return {"count": 0}
    out = {"count": int(lat_ms.size),
           "mean": float(lat_ms.mean()),
           "max": float(lat_ms.max())}
    for p, v in zip(PERCENTILES, np.percentile(lat_ms, PERCENTILES)):
        out[f"p{p:g}"] = float(v)
    return out
