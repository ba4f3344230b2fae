"""The two load loops of a cell, over any ``submit(payload) -> Future``.

Both run a lead-in (part of set-up: the server reaches its steady state)
and then a measured window of fixed length, and both keep a seeded sample
of answered requests for the correctness check.

``closed_loop``: ``clients`` callers, each with one request outstanding;
a caller sends its next request when its answer arrives. Frames/s is the
frames whose answers arrived inside the window, over the window.

``open_loop``: requests submitted on a schedule fixed before the run,
whatever the server does (``block=False``: a full queue refuses). Each
request's latency runs from the moment it was **due** on the schedule to
the moment its answer was ready, so a stall of the generator or the
server counts against every request it delayed. A refused or failed
request has no latency: it counts as failed.

Adapted from the program's ``serve/loadgen.py`` (``poisson_load`` timed
from the submit and ran for a number of requests; ``saturate`` submitted
everything at once and timed every request to the end of the run).
"""

from __future__ import annotations

import dataclasses
import math
import queue
import random
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

DRAIN_S = 60.0              # how long after the window answers may come


@dataclasses.dataclass
class Outcome:
    """What a loop saw. Times are ``clock()`` seconds."""

    t0: float                        # window start
    t1: float                        # window end
    due: np.ndarray                  # per request: due (open) / sent (closed)
    sent: np.ndarray                 # submitted (nan: refused)
    done: np.ndarray                 # answer ready (nan: none came)
    ok: np.ndarray                   # answered without an error
    refused: np.ndarray              # refused at admission (open loop)
    frames: np.ndarray               # frames a request
    payload: np.ndarray              # payload index a request
    sample: list = dataclasses.field(default_factory=list)
    # (request ordinal, payload index, answer) of the sampled requests

    def in_window(self) -> np.ndarray:
        return (self.due >= self.t0) & (self.due < self.t1)

    def frames_answered(self, lo: Optional[float] = None,
                        hi: Optional[float] = None) -> int:
        """Frames whose answers arrived in [lo, hi) (default: the
        window)."""
        lo = self.t0 if lo is None else lo
        hi = self.t1 if hi is None else hi
        sel = self.ok & (self.done >= lo) & (self.done < hi)
        return int(self.frames[sel].sum())

    def latencies_ms(self) -> np.ndarray:
        """Due -> answer of every request due in the window; ``inf`` for
        one refused, failed or never answered."""
        sel = self.in_window()
        lat = (self.done[sel] - self.due[sel]) * 1e3
        return np.where(self.ok[sel] & np.isfinite(lat), lat, np.inf)


class _Sampler:
    """A seeded reservoir of ``keep`` answered requests of the window."""

    def __init__(self, keep: int, seed: int):
        self.keep = keep
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.keep:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.keep:
            self.items[j] = item


def _records(n: int) -> dict:
    nan = np.full(n, np.nan)
    return dict(due=nan.copy(), sent=nan.copy(), done=nan.copy(),
                ok=np.zeros(n, bool), refused=np.zeros(n, bool),
                frames=np.zeros(n, np.int64), payload=np.zeros(n, np.int64))


def closed_loop(submit: Callable, payloads: Sequence[np.ndarray],
                order: Sequence[int], clients: int, lead_s: float,
                window_s: float, keep: int, seed: int,
                clock: Callable[[], float] = time.perf_counter,
                drain_s: float = DRAIN_S,
                t_begin: Optional[float] = None) -> Outcome:
    """``clients`` callers over ``payloads``; request k sends
    ``payloads[order[k % len(order)]]``. The lead-in starts at
    ``t_begin`` (default: now)."""
    sampler = _Sampler(keep, seed)
    ready: queue.SimpleQueue = queue.SimpleQueue()
    cap = 1 << 16
    rec = _records(cap)
    lock = threading.Lock()
    t_begin = clock() if t_begin is None else t_begin
    t0, t1 = t_begin + lead_s, t_begin + lead_s + window_s

    def grow():
        nonlocal rec
        for key in ("due", "sent", "done"):
            rec[key] = np.concatenate([rec[key], np.full(len(rec[key]),
                                                         np.nan)])
        for key in ("ok", "refused", "frames", "payload"):
            rec[key] = np.concatenate([rec[key],
                                       np.zeros_like(rec[key])])

    def on_done(fut, k, client):
        t = clock()
        ok = fut.exception() is None
        with lock:
            rec["done"][k] = t
            rec["ok"][k] = ok
            due = rec["due"][k]
            pay = int(rec["payload"][k])
        if ok and t0 <= due < t1:
            sampler.offer((k, pay, fut.result()))
        ready.put(client)

    k = 0

    def send(client):
        nonlocal k
        pay = int(order[k % len(order)])
        with lock:
            if k >= len(rec["due"]):
                grow()
            t = clock()
            rec["due"][k] = rec["sent"][k] = t
            rec["frames"][k] = len(payloads[pay])
            rec["payload"][k] = pay
        key, k = k, k + 1
        fut = submit(payloads[pay])
        fut.add_done_callback(lambda f, key=key, c=client: on_done(f, key, c))

    outstanding = 0
    for c in range(clients):
        send(c)
        outstanding += 1
    while outstanding:
        try:
            client = ready.get(timeout=max(t1 + drain_s - clock(), 0.0))
        except queue.Empty:
            break
        outstanding -= 1
        if clock() < t1:
            send(client)
            outstanding += 1
    with lock:
        n = k
        fields = {key: rec[key][:n].copy() for key in
                  ("due", "sent", "done", "ok", "refused", "frames",
                   "payload")}
    return Outcome(t0=t0, t1=t1, sample=sorted(sampler.items,
                                               key=lambda s: s[0]),
                   **fields)


def open_schedule(rate_rps: float, seconds: float, sizes: Sequence[int],
                  seed: int):
    """Arrival offsets (s) and request sizes for ``seconds`` at
    ``rate_rps``: every seed gets the same multiset of gaps (the
    exponential distribution's quantiles at the midpoints) and of sizes
    (``sizes`` repeated), each in its own seeded order."""
    n = int(math.ceil(rate_rps * seconds)) + 1
    rng = np.random.default_rng(seed)
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / rate_rps)
    reps = -(-n // len(sizes))
    size = rng.permutation(np.tile(np.asarray(sizes, np.int64), reps)[:n])
    return np.cumsum(gaps), size, rng


def open_loop(submit: Callable, payloads: Sequence[np.ndarray],
              offsets: np.ndarray, payload_of: Sequence[int],
              lead_s: float, window_s: float, keep: int, seed: int,
              refused: tuple = (Exception,),
              clock: Callable[[], float] = time.perf_counter,
              sleep: Callable[[float], None] = time.sleep,
              drain_s: float = DRAIN_S,
              t_begin: Optional[float] = None) -> Outcome:
    """Request i is due at ``t_begin + offsets[i]`` (default: now) and
    sends ``payloads[payload_of[i]]``; the schedule runs to the window's
    end. ``submit`` raising one of ``refused`` is a refusal."""
    sampler = _Sampler(keep, seed)
    t_begin = clock() if t_begin is None else t_begin
    t0, t1 = t_begin + lead_s, t_begin + lead_s + window_s
    last = int(np.searchsorted(offsets, lead_s + window_s))
    rec = _records(last)
    rec["due"][:] = t_begin + offsets[:last]
    settled = threading.Condition()
    pending, n_settled = [], 0

    def on_done(fut, i):
        nonlocal n_settled
        t = clock()
        ok = fut.exception() is None
        if ok and t0 <= rec["due"][i] < t1:
            sampler.offer((i, int(payload_of[i]), fut.result()))
        with settled:
            rec["done"][i] = t
            rec["ok"][i] = ok
            n_settled += 1
            settled.notify_all()

    for i in range(last):
        pay = int(payload_of[i])
        rec["frames"][i] = len(payloads[pay])
        rec["payload"][i] = pay
        delay = rec["due"][i] - clock()
        if delay > 0:
            sleep(delay)
        rec["sent"][i] = clock()
        try:
            fut = submit(payloads[pay])
        except refused:
            rec["refused"][i] = True
            continue
        pending.append(fut)
        fut.add_done_callback(lambda f, i=i: on_done(f, i))
    deadline = t1 + drain_s
    with settled:
        # the callbacks record after the futures settle: wait for them
        while n_settled < len(pending) and clock() < deadline:
            settled.wait(max(deadline - clock(), 0.0))
        fields = {key: rec[key].copy() for key in
                  ("due", "sent", "done", "ok", "refused", "frames",
                   "payload")}
    return Outcome(t0=t0, t1=t1, sample=sorted(sampler.items,
                                               key=lambda s: s[0]),
                   **fields)
