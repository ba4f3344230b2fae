"""Load generators for the serving runtime.

``poisson_load`` is open-loop: it submits on an arrival schedule drawn
before the run (exponential gaps at the offered rate) and never waits for
answers, so a slow server cannot throttle its own offered load. When it
falls behind the schedule it submits at once and counts the arrival in
``behind_schedule`` instead of silently re-timing it, which keeps latency
against offered load free of coordinated omission.

``saturate`` is closed-loop: every request submitted at once under
backpressure, so the server is always backlogged and the achieved frames/s
is its service capacity.

A copy of the reference package's module.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import wait as futures_wait
from typing import Dict, Optional

import numpy as np

from repro_torch.serve.metrics import latency_summary, now
from repro_torch.serve.server import AdmissionError, Server


@dataclasses.dataclass
class LoadReport:
    """What one load run measured (JSON-able via ``dataclasses.asdict``)."""

    program: str
    offered_rps: float          # requests/s the schedule offered
    duration_s: float           # first submit -> last completion
    submitted: int
    served: int
    shed: int                   # deadline-exceeded (or failed)
    rejected: int               # admission-refused
    achieved_rps: float         # served requests/s over the run
    achieved_fps: float         # served frames/s over the run
    behind_schedule: int        # arrivals the generator hit late (>1ms)
    latency_ms: Dict[str, float]   # submit -> result-ready, client-side


def poisson_load(server: Server, name: str, frames: np.ndarray,
                 rate_rps: float, n_requests: int,
                 frames_per_request: int = 1, seed: int = 0,
                 deadline_ms: Optional[float] = None,
                 block: bool = False,
                 result_timeout_s: float = 120.0) -> LoadReport:
    """Offer ``n_requests`` Poisson arrivals at ``rate_rps`` to ``name``.

    ``frames`` is a host pool [N, H, W, C]; request i takes the next
    ``frames_per_request`` frames (wrapping). ``block=False`` keeps the
    loop open: a full queue counts a rejection instead of stalling the
    schedule. Latency is client-side, submit to future completion, taken
    in done-callbacks.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    # every payload exists before the clock starts: the arrival loop paces
    payloads = [
        np.take(frames, range(i * frames_per_request,
                              (i + 1) * frames_per_request),
                axis=0, mode="wrap")
        for i in range(n_requests)]

    lock = threading.Lock()
    latencies, shed = [], [0]

    def _done(fut, t_submit):
        with lock:
            if fut.exception() is not None:
                shed[0] += 1
            else:
                latencies.append((now() - t_submit) * 1e3)

    futures, rejected, behind = [], 0, 0
    t_start = now()
    t_next = t_start
    for i in range(n_requests):
        t_next += gaps[i]
        delay = t_next - now()
        if delay > 0:
            time.sleep(delay)
        elif delay < -1e-3:
            behind += 1                     # late: submit now, keep schedule
        t_submit = now()
        try:
            fut = server.submit(name, payloads[i], deadline_ms=deadline_ms,
                                block=block)
        except AdmissionError:
            rejected += 1
            continue
        fut.add_done_callback(lambda f, t=t_submit: _done(f, t))
        futures.append(fut)

    futures_wait(futures, timeout=result_timeout_s)
    # done-callbacks run after the waiter wakes: let every done future's
    # callback record before reading the tally
    settle_deadline = now() + 5.0
    while now() < settle_deadline:
        n_done = sum(1 for f in futures if f.done())
        with lock:
            if len(latencies) + shed[0] >= n_done:
                break
        time.sleep(1e-3)
    t_end = now()
    with lock:
        lat = np.asarray(latencies, np.float64)
        n_shed = shed[0]
    served = int(lat.size)
    span = max(t_end - t_start, 1e-9)
    return LoadReport(
        program=name, offered_rps=rate_rps, duration_s=span,
        submitted=len(futures), served=served, shed=n_shed,
        rejected=rejected, achieved_rps=served / span,
        achieved_fps=served * frames_per_request / span,
        behind_schedule=behind, latency_ms=latency_summary(lat))


def saturate(server: Server, name: str, frames: np.ndarray,
             n_requests: int, frames_per_request: int = 1,
             result_timeout_s: float = 300.0) -> LoadReport:
    """Closed-loop saturation: submit everything under backpressure (each
    submit blocks until the bounded queue has room), so the achieved
    frames/s is the server's service capacity. The latencies are submit to
    the end of the run, dominated by queueing: use :func:`poisson_load`
    for latency."""
    pool = len(frames)
    futures, submit_times = [], []
    t_start = now()
    for i in range(n_requests):
        idx = (i * frames_per_request) % pool
        req_frames = np.take(frames, range(idx, idx + frames_per_request),
                             axis=0, mode="wrap")
        submit_times.append(now())
        futures.append(server.submit(name, req_frames, block=True))
    futures_wait(futures, timeout=result_timeout_s)
    t_end = now()
    ok = [f.done() and f.exception() is None for f in futures]
    lat = np.asarray([(t_end - t) * 1e3
                      for good, t in zip(ok, submit_times) if good],
                     np.float64)
    served = sum(ok)
    span = max(t_end - t_start, 1e-9)
    return LoadReport(
        program=name, offered_rps=float("inf"), duration_s=span,
        submitted=len(futures), served=served,
        shed=sum(1 for f in futures if f.done() and f.exception() is not None),
        rejected=0, achieved_rps=served / span,
        achieved_fps=served * frames_per_request / span,
        behind_schedule=0, latency_ms=latency_summary(lat))
