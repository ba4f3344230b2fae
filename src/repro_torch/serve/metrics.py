"""Serving metrics: request counters, latency percentiles, throughput,
padding waste, batch-occupancy histograms — plain counters under one lock
per hosted program — and :func:`format_stats`, the breakdown table.

The snapshot keeps the reference runtime's shape (``Server.stats()``), so
the two runtimes report alike; the reference's registry, Prometheus and
trace layers (``repro.obs``) are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np

PERCENTILES = (50.0, 95.0, 99.0)
_MIN_WINDOW_S = 1e-9          # achieved_fps divisor clamp (clock ticks)
RATIO_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def now() -> float:
    """The one clock every serving timestamp uses (monotonic seconds)."""
    return time.perf_counter()


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max (``buckets`` are upper
    bounds; an implicit +Inf bucket takes the rest). The caller locks."""

    def __init__(self, buckets: Sequence[float] = RATIO_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        i = next((i for i, le in enumerate(self.buckets) if v <= le),
                 len(self.buckets))
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def summary(self) -> Dict[str, object]:
        return {
            "count": self.count, "sum": self.sum,
            "mean": self.sum / self.count if self.count else 0.0,
            "min": self.min, "max": self.max,
            "buckets": {**{f"le_{le:g}": c
                           for le, c in zip(self.buckets, self.counts)},
                        "le_inf": self.counts[-1]}}


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
        self._occupancy = Histogram()
        self._waste = Histogram()
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

    def record_batch(self, slots: int, t_dispatch: float,
                     frames: Optional[int] = None) -> None:
        with self._lock:
            self.batches += 1
            self.slots += slots
            if frames is not None and slots > 0:
                self._occupancy.observe(frames / slots)
                self._waste.observe(1.0 - frames / slots)
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


    def histograms(self) -> Dict[str, Dict]:
        """Batch-occupancy and padding-waste histogram summaries
        (``Server.stats(verbose=True)``)."""
        with self._lock:
            return {"batch_occupancy": self._occupancy.summary(),
                    "padding_waste": self._waste.summary()}


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


def format_stats(stats: Dict[str, object]) -> str:
    """Render ``Server.stats(verbose=True)`` as a breakdown table: one row
    per program (requests, latency percentiles, achieved frames/s, batching
    efficiency, measured against modeled kFPS/W), then the pool, the plan
    cache and the kernel launches. Pure formatting."""
    lines = []
    hdr = (f"{'program':<18} {'served':>7} {'shed':>5} {'fail':>5} "
           f"{'p50ms':>8} {'p99ms':>8} {'fps':>9} {'avg_b':>6} "
           f"{'waste':>6} {'kFPS/W':>8} {'model':>8} {'drift':>7}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for name, p in sorted(stats.get("programs", {}).items()):
        lat = p.get("latency_ms", {})
        model = p.get("model", {})
        req = p.get("requests", {})
        lines.append(
            f"{name:<18} {req.get('served', 0):>7} "
            f"{req.get('shed_deadline', 0):>5} {req.get('failed', 0):>5} "
            f"{lat.get('p50', float('nan')):>8.2f} "
            f"{lat.get('p99', float('nan')):>8.2f} "
            f"{p.get('achieved_fps', 0.0):>9.0f} "
            f"{p.get('avg_batch', 0.0):>6.1f} "
            f"{p.get('padding_waste', 0.0):>6.1%} "
            f"{p.get('measured_kfps_per_w', 0.0):>8.3f} "
            f"{model.get('kfps_per_w', 0.0):>8.1f} "
            f"{p.get('kfps_per_w_drift', 0.0):>7.1e}")
        hists = p.get("histograms")
        if hists:
            occ = hists["batch_occupancy"]
            lines.append(f"{'':<18}   occupancy mean={occ['mean']:.2f} "
                         f"min={occ['min']} max={occ['max']} "
                         f"batches={occ['count']}")
    pool = stats.get("pool")
    if pool:
        occ = " ".join(f"d{d['device']}={d['occupancy']:.0%}"
                       for d in pool.get("per_device", ()))
        lines.append(f"pool: {pool['devices']} device(s) "
                     f"[{pool['placement']}] steals={pool['steals']} "
                     f"occupancy {occ}")
    cache = stats.get("plan_cache")
    if cache:
        lines.append(f"plan cache: {cache['hits']} hits / "
                     f"{cache['misses']} misses "
                     f"(hit rate {cache['hit_rate']:.1%})")
    launches = stats.get("kernel_launches")
    if launches:
        lines.append("kernel launches: " + " ".join(
            f"{k}={v}" for k, v in sorted(launches.items())))
    return "\n".join(lines)
