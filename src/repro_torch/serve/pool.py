"""The device pool: N workers, one bound Executable per program on each.

    scheduler ──placement──> per-device queues ──> worker threads ──┐
                (least-loaded,    (steal when idle)   (dispatch,     │
                 pluggable)                            then wait on  │
                                                       the previous) v
                                            shared done queue ──> completer

* **Placement** — :meth:`Pool.dispatch` asks the placement policy for a
  device index given every worker's load (queued + in-flight frames).
  :class:`LeastLoaded` (the default) picks the least loaded worker and
  rotates ties, so an idle pool spreads consecutive batches;
  :class:`RoundRobin` ignores load. A policy is any object with
  ``choose(loads) -> index`` (``Server(placement=...)``).
* **Work stealing** — a worker whose own queue is empty takes the oldest
  batch of the most backlogged peer before it sleeps, so one slow device
  cannot strand queued work while others idle.
* **Per-device pipelining** — a worker dispatches a batch (its bound
  view enqueues the copies and the graph replay on its own stream and
  returns a pending host result), then waits for the *previous* batch's
  event while the new one runs (``pipeline >= 2``; 1 runs each batch
  synchronously). The wait is on the worker thread, so the completer
  never waits on a device.
* **Observation** — placement, steals and failures are ``serve.pool.*``
  events, and each batch's device-busy interval is a
  ``serve.device.execute`` span on its device's lane (``device<i>``): it
  ends when the worker has waited for the batch's answer (the event
  behind its device-to-host copy), and a pipelined batch's span starts
  when its predecessor's ended. Counters live in the pool's private
  ``obs.Registry`` (``serve.pool.*``).
* **Fault isolation** — an exception from a worker's execution (or from
  the ``Hooks.execute`` seam around it) fails exactly that batch's
  requests with a typed :class:`WorkerError` naming the device (the
  original exception chained as ``__cause__``); the worker, the pool and
  every other batch keep running, and the failure is counted per device.
  A failed capture or replay is such an exception: nothing reruns eagerly.

Results are bitwise equal to single-device execution: every worker runs
the same per-frame-calibrated executor over a bound view of one compiled
plan, and per-frame calibration makes each frame's result a pure function
of that frame, so placement, stealing, padding and batch composition
cannot change it (``tests/test_torch_serve_pool.py``).
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve.clock import Clock

# Chrome-trace lane ids of the per-device execute spans: a span is
# recorded after its batch's wait returns, so it goes on a synthetic
# lane per device instead of the worker thread's live span stack.
_DEVICE_LANE_BASE = 1 << 21


class WorkerError(RuntimeError):
    """A device worker failed to execute a batch; only that batch's
    requests receive this error. ``program`` and ``device`` (the worker's
    index) say where it died."""

    def __init__(self, message: str, program: str = "", device: int = -1):
        super().__init__(message)
        self.program = program
        self.device = device


# ---------------------------------------------------------------------------
# Placement policies
# ---------------------------------------------------------------------------

class LeastLoaded:
    """The device with the fewest queued + in-flight frames; ties rotate
    (the scan starts just past the previous winner), so an idle pool
    spreads consecutive batches instead of always choosing device 0."""

    def __init__(self):
        self._start = 0

    def choose(self, loads: Sequence[int]) -> int:
        n = len(loads)
        best, best_load = None, None
        for k in range(n):
            i = (self._start + k) % n
            if best_load is None or loads[i] < best_load:
                best, best_load = i, loads[i]
        self._start = (best + 1) % n
        return best


class RoundRobin:
    """Strict rotation, load-blind (deterministic placement)."""

    def __init__(self):
        self._next = 0

    def choose(self, loads: Sequence[int]) -> int:
        i = self._next % len(loads)
        self._next = i + 1
        return i


PLACEMENTS = {"least_loaded": LeastLoaded, "round_robin": RoundRobin}


# ---------------------------------------------------------------------------
# What moves between scheduler, workers and completer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Batch:
    """One closed micro-batch in flight (identity semantics: workers track
    and remove batches by ``is``)."""

    hosted: object                    # serve.server.HostedProgram
    live: list                        # [_Request] whose futures to resolve
    frames: np.ndarray                # [n, H, W, C] concatenated
    bucket: int
    n: int                            # real frames (== frames.shape[0])
    t_closed: float
    t_dispatch: float = 0.0           # stamped by the worker at dispatch


@dataclasses.dataclass
class Done:
    """A finished (or failed) batch, handed to the completer."""

    batch: Batch
    device: int
    out: Optional[np.ndarray]         # host-side result (None on error)
    error: Optional[BaseException]
    t_ready: float


_STOP = object()


def to_host(out) -> np.ndarray:
    """Wait for a dispatched batch's answer and return it on the host: a
    bound view's pending result waits on its event; an array that an
    execute hook substituted is taken as it is."""
    if hasattr(out, "wait"):
        return out.wait()
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


class _Worker:
    """One device: its queue, its load (under the pool's lock), its
    registry counters and its thread."""

    def __init__(self, index: int, name: str, registry: obs.Registry):
        self.index = index
        self.name = name
        self.queue: deque = deque()
        self.queued_frames = 0
        self.inflight_frames = 0
        self.inflight: List[Batch] = []   # dispatched, not yet completed
        p = f"serve.pool.device{index}"
        self.batches = registry.counter(f"{p}.batches")
        self.frames = registry.counter(f"{p}.frames")
        self.steals = registry.counter(f"{p}.steals")
        self.failures = registry.counter(f"{p}.failures")
        self.busy_s = registry.gauge(f"{p}.busy_s")
        # this device's last completion (worker-thread private): a
        # pipelined batch is dispatched while its predecessor still runs,
        # so its busy time starts at max(t_dispatch, predecessor ready)
        self.last_ready: Optional[float] = None
        self.thread: Optional[threading.Thread] = None

    @property
    def load(self) -> int:
        return self.queued_frames + self.inflight_frames


class Pool:
    """N device workers + placement + a shared completion queue.

    The pool moves :class:`Batch` objects from :meth:`dispatch` to the
    ``done`` queue, running each through the hosted program's bound view
    on one device (``hosted.bound[index]``). ``names`` label the devices
    in stats and errors (default ``device<i>``); ``registry`` holds the
    ``serve.pool.*`` metrics.
    """

    def __init__(self, n_devices: int, policy, done: queue_mod.Queue,
                 clock: Optional[Clock] = None,
                 execute_hook: Optional[Callable] = None, pipeline: int = 2,
                 names: Optional[Sequence[str]] = None):
        if n_devices < 1:
            raise ValueError(f"pool needs >= 1 device, got {n_devices}")
        names = list(names) if names is not None else [
            f"device{i}" for i in range(n_devices)]
        if len(names) != n_devices:
            raise ValueError(f"{len(names)} device names for {n_devices} "
                             f"devices")
        self.registry = obs.Registry()
        self._policy = policy
        self._done = done
        self._clock = clock or Clock()
        self._execute_hook = execute_hook
        self._pipeline = max(int(pipeline), 1)
        self._cond = threading.Condition()
        self._stopping = False
        self._t_start: Optional[float] = None
        self._steals = self.registry.counter("serve.pool.steals")
        self._placement_us = self.registry.histogram(
            "serve.pool.placement_us",
            buckets=(1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0))
        self._workers = [_Worker(i, names[i], self.registry)
                         for i in range(n_devices)]

    @property
    def size(self) -> int:
        return len(self._workers)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Pool":
        self._t_start = self._clock.now()
        for w in self._workers:
            w.thread = threading.Thread(
                target=self._run, args=(w,),
                name=f"repro-torch-serve-{w.name}", daemon=True)
            w.thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain every queue, finish pending batches, join the workers.
        Every dispatched batch's completion is on ``done`` when this
        returns, provided every worker joined; under a finite ``timeout``
        check :meth:`alive` and reclaim with :meth:`take_outstanding`."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for w in self._workers:
            if w.thread is not None:
                w.thread.join(timeout)

    def alive(self) -> bool:
        """True while any worker thread still runs."""
        return self.workers_alive() > 0

    def workers_alive(self) -> int:
        return sum(1 for w in self._workers
                   if w.thread is not None and w.thread.is_alive())

    def healthy(self) -> bool:
        """True only while *every* worker thread runs (a pool that lost one
        worker still serves, degraded)."""
        return self.workers_alive() == len(self._workers)

    def take_outstanding(self):
        """Reclaim what a timed-out :meth:`stop` left: ``(queued,
        inflight)``. Queued batches are removed from the worker queues
        (they will never reach ``done``: the caller fails them); in-flight
        ones are a snapshot that a wedged worker may still complete, so the
        caller settles their futures idempotently."""
        queued: List[Batch] = []
        inflight: List[Batch] = []
        with self._cond:
            for w in self._workers:
                while w.queue:
                    batch = w.queue.popleft()
                    w.queued_frames -= batch.n
                    queued.append(batch)
                inflight.extend(w.inflight)
        return queued, inflight

    # -- dispatch (scheduler thread) ---------------------------------------

    def dispatch(self, batch: Batch) -> int:
        """Place ``batch`` on a device queue; returns the device index."""
        t0 = self._clock.now()
        with self._cond:
            idx = self._policy.choose([w.load for w in self._workers])
            w = self._workers[idx]
            w.queue.append(batch)
            w.queued_frames += batch.n
            self._cond.notify_all()
        self._placement_us.observe((self._clock.now() - t0) * 1e6)
        if obs.recording():
            obs.event("serve.pool.place",
                      attrs={"device": idx, "program": batch.hosted.name,
                             "frames": batch.n, "bucket": batch.bucket})
        return idx

    # -- worker loop -------------------------------------------------------

    def _next(self, w: _Worker, block: bool):
        """Own queue first, then the oldest batch of the most backlogged
        peer; ``_STOP`` when stopping and drained, ``None`` when idle with
        a pending batch to finish (``block=False``)."""
        with self._cond:
            while True:
                if w.queue:
                    batch = w.queue.popleft()
                    w.queued_frames -= batch.n
                    return batch
                victim = max((v for v in self._workers if v.queue),
                             key=lambda v: v.queued_frames, default=None)
                if victim is not None:
                    batch = victim.queue.popleft()    # oldest: FIFO-fair
                    victim.queued_frames -= batch.n
                    w.steals.inc()
                    self._steals.inc()
                    if obs.recording():
                        obs.event("serve.pool.steal",
                                  attrs={"thief": w.index,
                                         "victim": victim.index,
                                         "frames": batch.n})
                    return batch
                if self._stopping:
                    return _STOP
                if not block:
                    return None
                self._cond.wait()

    def _run(self, w: _Worker) -> None:
        pending = None                 # (batch, dispatched result)
        while True:
            nxt = self._next(w, block=pending is None)
            if nxt is None:            # idle: finish the in-flight batch
                self._finish(w, *pending)
                pending = None
                continue
            if nxt is _STOP:
                if pending is not None:
                    self._finish(w, *pending)
                return
            out = self._dispatch_one(w, nxt)
            if pending is not None:
                self._finish(w, *pending)
                pending = None
            if out is not None:
                if self._pipeline > 1:
                    pending = (nxt, out)
                else:
                    self._finish(w, nxt, out)

    def _dispatch_one(self, w: _Worker, batch: Batch):
        """Dispatch ``batch`` on this worker's bound view. Returns the
        pending result, or None after routing a failure to ``done``."""
        batch.t_dispatch = self._clock.now()
        with self._cond:
            w.inflight_frames += batch.n
            w.inflight.append(batch)
        exe = batch.hosted.bound[w.index]

        def default():
            return exe.run_padded(batch.frames, batch.bucket)

        try:
            if self._execute_hook is not None:
                return self._execute_hook(batch.hosted.name, w.index,
                                          batch.frames, batch.bucket,
                                          default)
            return default()
        except Exception as e:          # noqa: BLE001 — isolate the batch
            self._fail(w, batch, e)
            return None

    def _finish(self, w: _Worker, batch: Batch, out) -> None:
        """Wait for the batch's answer; hand it to ``done``."""
        try:
            out_np = to_host(out)
        except Exception as e:          # noqa: BLE001 — isolate the batch
            self._fail(w, batch, e)
            return
        # stamped after the wait on the batch's event: the device span
        # ends when the work ended, not when it was enqueued
        t_ready = self._clock.now()
        # the device is serial: a pipelined batch's busy time starts when
        # its predecessor finished, not when it was dispatched
        t0 = batch.t_dispatch
        if w.last_ready is not None and w.last_ready > t0:
            t0 = w.last_ready
        w.last_ready = t_ready
        with self._cond:
            w.inflight_frames -= batch.n
            w.inflight.remove(batch)
        w.busy_s.add(t_ready - t0)
        w.batches.inc()
        w.frames.inc(batch.n)
        if obs.recording():
            obs.span_at("serve.device.execute", t0, t_ready,
                        attrs={"device": w.index,
                               "program": batch.hosted.name,
                               "bucket": batch.bucket, "frames": batch.n,
                               "queued_ms": (t0 - batch.t_dispatch) * 1e3},
                        lane_tid=_DEVICE_LANE_BASE + w.index,
                        lane=f"device{w.index}")
        self._done.put(Done(batch, w.index, out_np, None, t_ready))

    def _fail(self, w: _Worker, batch: Batch, exc: BaseException) -> None:
        with self._cond:
            w.inflight_frames -= batch.n
            w.inflight.remove(batch)
        w.failures.inc()
        err = WorkerError(
            f"device {w.index} ({w.name}) failed executing a bucket-"
            f"{batch.bucket} batch of {batch.hosted.name!r}: {exc}",
            program=batch.hosted.name, device=w.index)
        err.__cause__ = exc
        if obs.recording():
            obs.event("serve.pool.failure",
                      attrs={"device": w.index,
                             "program": batch.hosted.name,
                             "error": type(exc).__name__})
        self._done.put(Done(batch, w.index, None, err, self._clock.now()))

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Per device: batches, frames, steals, failures, queued and
        in-flight frames, busy seconds and occupancy (busy / wall since
        start); pool-wide: steals and the placement-latency histogram."""
        wall = None
        if self._t_start is not None:
            wall = max(self._clock.now() - self._t_start, 1e-9)
        with self._cond:
            per_device = [{
                "device": w.index, "name": w.name, "alive": (
                    w.thread is not None and w.thread.is_alive()),
                "batches": w.batches.get(), "frames": w.frames.get(),
                "steals": w.steals.get(), "failures": w.failures.get(),
                "queued_frames": w.queued_frames,
                "inflight_frames": w.inflight_frames,
                "busy_s": w.busy_s.get(),
                "occupancy": w.busy_s.get() / wall if wall else 0.0,
            } for w in self._workers]
            return {
                "devices": len(self._workers),
                "placement": type(self._policy).__name__,
                "pipeline": self._pipeline,
                "steals": self._steals.get(),
                "placement_us": self._placement_us.summary(),
                "per_device": per_device,
            }
