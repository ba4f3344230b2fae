"""The serving runtime: a multi-program router + async micro-batching
scheduler over one device.

    submit() ──> per-program FIFO queues ──> scheduler ──> device worker
    (any thread;   bounded: admission         (collect, shed,    │
     returns a      control + back-            pad to bucket)     v
     Future)        pressure)                         done queue ──> completer
                                                                     (split,
                                                                      fulfill,
                                                                      metrics)

* **Micro-batching** — the scheduler picks the program whose head request
  is oldest and holds the batch open up to ``max_wait_ms`` (from that
  request's arrival) or until ``max_batch`` frames are collected. It
  closes early when the device is idle and the queue is drained
  (``speculative_close``). The batch is padded to the nearest bucket and
  run with per-frame CRC calibration (``Executable.run_padded``), so
  coalescing and padding are invisible: results are bitwise equal to
  per-request ``run_per_frame`` calls.
* **Admission control + backpressure** — queued frames are bounded by
  ``max_queue``: ``submit(block=False)`` raises :class:`AdmissionError`
  when full, ``block=True`` (default) waits for room.
* **Deadline shedding** — a request whose ``deadline_ms`` has passed when
  its batch is formed fails with :class:`DeadlineExceeded`.
* **Stop** — ``stop(drain=True)`` serves the backlog first,
  ``drain=False`` fails it with :class:`ServerClosed`.
* **Test seams** — every timestamp and timed wait goes through an
  injectable :class:`~repro_torch.serve.clock.Clock`, and
  :class:`Hooks` exposes the batch-close decision.

The reference runtime's multi-device pool, SLOs, flight recorder, admin
endpoint, structured log and trace spans are not ported yet: ``devices``
above 1 raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.program import (Executable, Options, Program,
                                      resolve_device)
from repro_torch.serve import batcher
from repro_torch.serve import pool as pool_mod
from repro_torch.serve.clock import Clock
from repro_torch.serve.metrics import ProgramMetrics


class AdmissionError(RuntimeError):
    """The bounded request queue is full (non-blocking submit, or the
    blocking wait timed out)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before the device got to it."""


class ServerClosed(RuntimeError):
    """The server is stopped (or stopping) and not accepting work."""


@dataclasses.dataclass
class Hooks:
    """``batch_close(program, reason, frames)`` is called the moment a
    micro-batch stops collecting; reason is ``"full"``, ``"speculative"``
    (the device was idle), ``"window"`` (``max_wait_ms`` elapsed) or
    ``"stop"`` (draining)."""

    batch_close: Optional[Callable[[str, str, int], None]] = None


@dataclasses.dataclass
class ServeConfig:
    """Scheduler/queue knobs for a :class:`Server`.

    ``max_batch``      largest device batch a micro-batch may collect (and
                       the top of the default bucket ladder).
    ``max_wait_ms``    how long a batch is held open for more requests,
                       from its oldest request's arrival.
    ``max_queue``      admission bound, in frames, across all programs.
    ``max_inflight``   device pipeline depth (>= 2 overlaps the wait for
                       one batch with the next dispatch).
    ``batch_buckets``  compiled batch sizes per program (``None``: powers
                       of two up to ``max_batch``).
    ``default_deadline_ms``  deadline of requests that carry none.
    ``speculative_close``  close a collecting batch as soon as the queue is
                       drained while the device is idle.
    ``devices``        device count; only 1 is ported.
    ``device``         the device programs run on when ``register`` is not
                       given options (``cuda``; ``cpu`` only if asked).
    """

    max_batch: int = 8
    max_wait_ms: float = 2.0
    max_queue: int = 256
    max_inflight: int = 2
    batch_buckets: Optional[Tuple[int, ...]] = None
    default_deadline_ms: Optional[float] = None
    speculative_close: bool = True
    devices: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        if self.devices is not None and self.devices > 1:
            raise NotImplementedError(
                f"devices={self.devices}: the multi-device pool is not "
                f"ported yet (ROADMAP Queue 1 item 6); serve on one device")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        resolve_device(self.device)


@dataclasses.dataclass
class _Request:
    frames: np.ndarray                # [n, H, W, C]
    n: int
    future: Future
    t_submit: float
    deadline: Optional[float]         # absolute, server-clock seconds


@dataclasses.dataclass
class HostedProgram:
    """One program slot in the router: executable + queue + metrics."""

    name: str
    program: Program
    executable: Executable
    buckets: Tuple[int, ...]
    queue: deque = dataclasses.field(default_factory=deque)
    metrics: ProgramMetrics = dataclasses.field(default_factory=ProgramMetrics)


_SENTINEL = object()
_UNSET = object()


def _settle(future: Future, result=_UNSET,
            exc: Optional[BaseException] = None) -> bool:
    """Resolve ``future`` exactly once; False if it was already settled."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


class Server:
    """Long-lived multi-program serving runtime (see module docstring).

    Usage::

        server = serve.Server(serve.ServeConfig(max_batch=8))
        server.register("lenet", Program.from_model("lenet"))
        server.start()                        # warms every bucket
        logits = server.submit("lenet", frame).result()
        print(server.stats()["programs"]["lenet"]["latency_ms"])
        server.stop()

    Futures resolve to numpy arrays. ``Server`` is also a context manager.
    """

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 clock: Optional[Clock] = None,
                 hooks: Optional[Hooks] = None):
        self.config = config or ServeConfig()
        self._clock = clock or Clock()
        self._hooks = hooks or Hooks()
        self._programs: Dict[str, HostedProgram] = {}
        self._cond = threading.Condition()
        self._queued_total = 0                 # frames across all programs
        self._active_batches = 0               # dispatched, not completed
        self._stopping = False
        self._drain = True
        self._started = False
        self._warmed = False
        self._scheduler: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._pool: Optional[pool_mod.Pool] = None
        self._done: queue_mod.Queue = queue_mod.Queue()

    # -- lifecycle ---------------------------------------------------------

    def register(self, name: str, program: Program,
                 options: Optional[Options] = None,
                 buckets: Optional[Sequence[int]] = None) -> HostedProgram:
        """Host ``program`` under ``name``; compiles it now (on the
        config's device when no ``options`` are given)."""
        if self._started:
            raise RuntimeError("register() before start()")
        if name in self._programs:
            raise ValueError(f"program {name!r} already registered")
        exe = program.compile(options if options is not None
                              else Options(device=self.config.device))
        bks = tuple(sorted({int(b) for b in buckets})) if buckets else \
            (self.config.batch_buckets
             or batcher.power_of_two_buckets(self.config.max_batch))
        if min(bks) < 1:
            raise ValueError(f"buckets must be >= 1, got {bks}")
        hosted = HostedProgram(name, program, exe, bks,
                               metrics=ProgramMetrics(name=name))
        self._programs[name] = hosted
        return hosted

    def start(self, warm: bool = True) -> "Server":
        """Launch the device worker and the scheduler/completer threads;
        with ``warm``, run every bucket of every program once first."""
        if self._started:
            raise RuntimeError("server already started")
        if not self._programs:
            raise RuntimeError("no programs registered")
        if warm:
            for hosted in self._programs.values():
                hosted.executable.warm(hosted.buckets)
        self._warmed = warm
        self._pool = pool_mod.Pool(self._done, clock=self._clock,
                                   pipeline=self.config.max_inflight)
        self._started = True
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="repro-torch-serve-scheduler",
            daemon=True)
        self._completer = threading.Thread(
            target=self._completer_loop, name="repro-torch-serve-completer",
            daemon=True)
        self._pool.start()
        self._completer.start()
        self._scheduler.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the server. ``drain=True`` serves everything queued first;
        ``drain=False`` fails pending requests with :class:`ServerClosed`.
        A finite ``timeout`` bounds every join; batches a wedged device
        still holds then fail with :class:`ServerClosed`."""
        with self._cond:
            self._stopping = True
            self._drain = drain
            self._cond.notify_all()
        if self._scheduler is not None:
            self._scheduler.join(timeout)
            if not self._scheduler.is_alive():
                # retire the worker only once nothing can be dispatched;
                # if it joins, every completion is already on the done
                # queue, so the sentinel cannot overtake one
                if self._pool is not None:
                    self._pool.stop(timeout)
                    if self._pool.alive():
                        self._fail_stranded()
                self._done.put(_SENTINEL)
                if self._completer is not None:
                    self._completer.join(timeout)
        if not drain:
            with self._cond:
                for hosted in self._programs.values():
                    while hosted.queue:
                        req = hosted.queue.popleft()
                        hosted.metrics.add_queued(-req.n)
                        self._queued_total -= req.n
                        if _settle(req.future,
                                   exc=ServerClosed("server stopped")):
                            hosted.metrics.record_failed()
                self._cond.notify_all()    # release backpressured submitters

    def _fail_stranded(self) -> None:
        """Fail every batch a timed-out worker shutdown left behind."""
        queued, inflight = self._pool.take_outstanding()
        for batch in queued + inflight:
            failed = sum(
                1 for req in batch.live
                if _settle(req.future, exc=ServerClosed(
                    f"server stopped before the device drained (a batch "
                    f"of {batch.hosted.name!r} was outstanding)")))
            if failed:
                batch.hosted.metrics.record_failed(failed)
        if queued:
            # queued batches produce no Done: the completer will never
            # decrement the active count for them
            with self._cond:
                self._active_batches -= len(queued)
                self._cond.notify_all()

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # -- request path ------------------------------------------------------

    def submit(self, name: str, frames, deadline_ms: Optional[float] = None,
               block: bool = True, timeout: Optional[float] = None) -> Future:
        """Enqueue ``frames`` ([H, W, C] or [n, H, W, C]) for ``name``.

        Returns a ``Future`` resolving to the program's output for exactly
        those frames (numpy, batch-first), bitwise equal to a direct
        ``run_per_frame``. Raises :class:`AdmissionError` when the queue is
        full (``block=False``, or the wait exceeds ``timeout``),
        :class:`ServerClosed` after :meth:`stop`, and ``ValueError`` for an
        unknown program or a frame-shape mismatch — all before queueing.
        """
        hosted = self._programs.get(name)
        if hosted is None:
            raise ValueError(f"unknown program {name!r}; hosted: "
                             f"{sorted(self._programs)}")
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 3:
            frames = frames[None]
        hwc = tuple(hosted.program.input_hwc)
        if frames.ndim != 4 or tuple(frames.shape[1:]) != hwc:
            raise ValueError(
                f"frames {frames.shape} do not match {name!r}'s input "
                f"[n, {', '.join(map(str, hwc))}]")
        n = frames.shape[0]
        if n == 0:
            raise ValueError("request carries no frames")
        if n > self.config.max_queue:
            raise ValueError(
                f"request of {n} frames exceeds max_queue="
                f"{self.config.max_queue}; raise the bound or split the "
                f"request")
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        t_submit = self._clock.now()
        req = _Request(frames, n, Future(), t_submit,
                       t_submit + deadline_ms / 1e3
                       if deadline_ms is not None else None)
        with self._cond:
            while (self._queued_total + n > self.config.max_queue
                   and not self._stopping):
                if not block:
                    hosted.metrics.record_reject()
                    raise AdmissionError(
                        f"queue full ({self._queued_total} frames >= "
                        f"{self.config.max_queue})")
                if not self._clock.wait(self._cond, timeout):
                    hosted.metrics.record_reject()
                    raise AdmissionError(
                        f"queue full after {timeout}s backpressure wait")
            if self._stopping:
                raise ServerClosed("server is stopping")
            hosted.queue.append(req)
            hosted.metrics.add_queued(n)
            self._queued_total += n
            hosted.metrics.record_admit()
            self._cond.notify_all()
        return req.future

    # -- scheduler ---------------------------------------------------------

    def _collect(self) -> Optional[Tuple[HostedProgram, list, str]]:
        """One scheduling decision: pick a program, hold the batch open,
        pop it. Returns (hosted, requests, close_reason), or None when
        stopping with nothing left to drain."""
        cfg = self.config
        with self._cond:
            while True:
                if self._stopping and not self._drain:
                    return None
                backlog = [h for h in self._programs.values() if h.queue]
                if backlog:
                    break
                if self._stopping:
                    return None
                self._cond.wait()
            hosted = min(backlog, key=lambda h: h.queue[0].t_submit)
            cap = min(cfg.max_batch, max(hosted.buckets))
            close_at = hosted.queue[0].t_submit + cfg.max_wait_ms / 1e3
            reason = None
            while (hosted.metrics.queued_frames < cap
                   and not self._stopping):
                if batcher.should_close_early(hosted.metrics.queued_frames,
                                              cap, self._active_batches,
                                              cfg.speculative_close):
                    reason = "speculative"
                    break
                remaining = close_at - self._clock.now()
                if remaining <= 0:
                    reason = "window"
                    break
                self._clock.wait(self._cond, remaining)
            if reason is None:
                reason = ("full" if hosted.metrics.queued_frames >= cap
                          else "stop")
            reqs, n = [], 0
            while hosted.queue and n + hosted.queue[0].n <= cap:
                req = hosted.queue.popleft()
                reqs.append(req)
                n += req.n
            if not reqs and hosted.queue:
                # the head request alone exceeds the cap: dispatch it solo
                # (run_padded chunks it through the largest bucket)
                reqs = [hosted.queue.popleft()]
                n = reqs[0].n
            hosted.metrics.add_queued(-n)
            self._queued_total -= n
            self._cond.notify_all()        # wake backpressured submitters
        return hosted, reqs, reason

    def _scheduler_loop(self) -> None:
        while True:
            picked = self._collect()
            if picked is None:
                return
            hosted, reqs, reason = picked
            t_closed = self._clock.now()
            if self._hooks.batch_close is not None:
                self._hooks.batch_close(hosted.name, reason,
                                        sum(r.n for r in reqs))
            t = self._clock.now()
            live = []
            for req in reqs:
                if req.deadline is not None and t > req.deadline:
                    if _settle(req.future, exc=DeadlineExceeded(
                            f"deadline missed by "
                            f"{(t - req.deadline) * 1e3:.1f}ms "
                            f"waiting for dispatch")):
                        hosted.metrics.record_shed()
                else:
                    live.append(req)
            if not live:
                continue
            frames = (live[0].frames if len(live) == 1
                      else np.concatenate([r.frames for r in live], axis=0))
            bucket = batcher.pick_bucket(frames.shape[0], hosted.buckets)
            with self._cond:
                self._active_batches += 1
            self._pool.dispatch(pool_mod.Batch(
                hosted, live, frames, bucket, frames.shape[0], t_closed))

    def _completer_loop(self) -> None:
        while True:
            item = self._done.get()
            if item is _SENTINEL:
                return
            batch, live, hosted = item.batch, item.batch.live, item.batch.hosted
            try:
                if item.error is not None:
                    failed = sum(1 for req in live
                                 if _settle(req.future, exc=item.error))
                    if failed:
                        hosted.metrics.record_failed(failed)
                    continue
                hosted.metrics.record_batch(
                    batcher.padded_slots(batch.n, batch.bucket),
                    batch.t_dispatch)
                for part, req in zip(
                        batcher.split_results(item.out, [r.n for r in live]),
                        live):
                    if not _settle(req.future, result=part):
                        continue           # a timed-out stop() failed it
                    t_done = self._clock.now()
                    hosted.metrics.record_served(t_done - req.t_submit,
                                                 req.n, t_done)
            finally:
                with self._cond:
                    self._active_batches -= 1
                    self._cond.notify_all()

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """JSON-able snapshot: per-program counters, latency percentiles,
        achieved frames/s and padding waste, each program's modeled device
        FPS/W from its power report, the plan cache, the device worker and
        the kernel launch counts."""
        from repro_torch.core.plan import plan_cache_stats
        from repro_torch.kernels import launch_counts
        programs = {}
        totals = {"submitted": 0, "served": 0, "shed_deadline": 0,
                  "rejected": 0, "failed": 0}
        frames_served = 0
        for name, hosted in self._programs.items():
            snap = hosted.metrics.snapshot()
            r = hosted.executable.report
            snap["model"] = {"fps": r.fps, "avg_power_w": r.avg_power_w,
                             "kfps_per_w": r.kfps_per_w}
            snap["buckets"] = list(hosted.buckets)
            programs[name] = snap
            for k in totals:
                totals[k] += snap["requests"][k]
            frames_served += snap["frames_served"]
        with self._cond:
            depth = self._queued_total
        cache = plan_cache_stats()
        lookups = cache["hits"] + cache["misses"]
        out = {
            "config": dataclasses.asdict(self.config),
            "queue_depth": depth,
            "frames_served": frames_served,
            "requests": totals,
            "plan_cache": {**cache, "hit_rate": (cache["hits"] / lookups
                                                 if lookups else 0.0)},
            "kernel_launches": launch_counts(),
            "programs": programs,
        }
        if self._pool is not None:
            out["pool"] = self._pool.stats()
        return out
