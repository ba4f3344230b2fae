"""Serving metrics: request counters, latency percentiles, throughput,
padding waste, batch-occupancy histograms, and :func:`format_stats`, the
breakdown table.

:class:`ProgramMetrics` is a facade over a private
:class:`repro_torch.obs.Registry` per hosted program: the counters,
gauge and histograms are registry metrics named ``serve.<program>.*``
(the reference package's names, dumpable with ``obs.prometheus_text``),
and every update and the snapshot run under the registry's one lock, so
a snapshot is internally consistent. The snapshot keeps the reference
runtime's shape (``Server.stats()``), so the two runtimes report alike.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from repro_torch import obs

PERCENTILES = (50.0, 95.0, 99.0)
_MIN_WINDOW_S = 1e-9          # achieved_fps divisor clamp (clock ticks)


def now() -> float:
    """The one clock every serving timestamp uses (monotonic seconds)."""
    return time.perf_counter()


class ProgramMetrics:
    """Counters + latency reservoir for one hosted program (thread-safe).

    The ``queued_frames`` gauge is written only through :meth:`add_queued`;
    the counts read as properties (``metrics.served``).
    """

    def __init__(self, window: int = 8192, name: str = "program",
                 registry: Optional[obs.Registry] = None):
        # a private registry by default: two Servers hosting the same
        # program name never alias each other's counters
        self.registry = registry if registry is not None else obs.Registry()
        self._lock = self.registry._lock
        p = f"serve.{name}"
        self._submitted = self.registry.counter(f"{p}.submitted")
        self._served = self.registry.counter(f"{p}.served")
        self._shed = self.registry.counter(f"{p}.shed_deadline")
        self._rejected = self.registry.counter(f"{p}.rejected")
        self._failed = self.registry.counter(f"{p}.failed")
        self._frames_served = self.registry.counter(f"{p}.frames_served")
        self._batches = self.registry.counter(f"{p}.batches")
        self._slots = self.registry.counter(f"{p}.slots")
        self._queued = self.registry.gauge(f"{p}.queued_frames")
        self._occupancy = self.registry.histogram(f"{p}.batch_occupancy")
        self._waste = self.registry.histogram(f"{p}.padding_waste")
        self._latencies_ms: deque = deque(maxlen=window)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    @property
    def submitted(self) -> int:
        return self._submitted.get()

    @property
    def served(self) -> int:
        return self._served.get()

    @property
    def shed(self) -> int:
        return self._shed.get()

    @property
    def rejected(self) -> int:
        return self._rejected.get()

    @property
    def failed(self) -> int:
        return self._failed.get()

    @property
    def frames_served(self) -> int:
        return self._frames_served.get()

    @property
    def batches(self) -> int:
        return self._batches.get()

    @property
    def slots(self) -> int:
        return self._slots.get()

    @property
    def queued_frames(self) -> int:
        return int(self._queued.get())

    def record_admit(self, n_requests: int = 1) -> None:
        self._submitted.inc(n_requests)

    def record_reject(self) -> None:
        self._rejected.inc()

    def record_shed(self, n: int = 1) -> None:
        self._shed.inc(n)

    def record_failed(self, n: int = 1) -> None:
        self._failed.inc(n)

    def add_queued(self, delta: int) -> None:
        self._queued.add(delta)

    def record_batch(self, slots: int, t_dispatch: float,
                     frames: Optional[int] = None) -> None:
        with self._lock:
            self._batches.inc()
            self._slots.inc(slots)
            if frames is not None and slots > 0:
                self._occupancy.observe(frames / slots)
                self._waste.observe(1.0 - frames / slots)
            if self._t_first is None:
                self._t_first = t_dispatch

    def record_served(self, latency_s: float, frames: int,
                      t_done: float) -> None:
        with self._lock:
            self._served.inc()
            self._frames_served.inc(frames)
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
            submitted, served = self.submitted, self.served
            shed, failed = self.shed, self.failed
            frames_served, batches = self.frames_served, self.batches
            slots = self.slots
            return {
                "requests": {
                    "submitted": submitted,
                    "served": served,
                    "shed_deadline": shed,
                    "rejected": self.rejected,
                    "failed": failed,
                    "pending": submitted - served - shed - failed,
                },
                "frames_served": frames_served,
                "queue_depth": self.queued_frames,
                "batches": batches,
                "avg_batch": (frames_served / batches if batches else 0.0),
                "padding_waste": (1.0 - frames_served / slots
                                  if slots else 0.0),
                "achieved_fps": (frames_served / span if span else 0.0),
                "latency_ms": latency_summary(lat),
            }

    def histograms(self) -> Dict[str, Dict]:
        """Batch-occupancy and padding-waste histogram summaries
        (``Server.stats(verbose=True)``)."""
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
    cache, the conv dispatch counts, the flight recorder, each program's
    SLO window and the kernel launches. Pure formatting."""
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
    disp = stats.get("conv_dispatch")
    if disp:
        lines.append("conv dispatch: " + " ".join(
            f"{k}={v}" for k, v in sorted(disp.items())))
    flight = stats.get("flight")
    if flight:
        rec = flight.get("recorder")
        lines.append(
            f"flight: {flight['dumps']} dump(s), {flight['suppressed']} "
            f"suppressed, last {flight['last_reason']}"
            + (f"; recorder {rec['retained']} retained of "
               f"{rec['recorded_total']} in {rec['rings']} ring(s)"
               if rec else "; no recorder"))
    for name, p in sorted(stats.get("programs", {}).items()):
        slo = p.get("slo")
        if slo:
            objs = " ".join(
                f"{k}={v['value']}/{v['limit']}"
                for k, v in slo["objectives"].items()
                if v["limit"] is not None)
            lines.append(f"slo {name}: {objs} n={slo['n']} breaches "
                         f"{slo['breaches'] or 0}")
    launches = stats.get("kernel_launches")
    if launches:
        lines.append("kernel launches: " + " ".join(
            f"{k}={v}" for k, v in sorted(launches.items())))
    return "\n".join(lines)
