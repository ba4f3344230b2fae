"""The serving runtime: a multi-program router + async micro-batching
scheduler over a pool of device-bound executables.

    submit() ──> per-program FIFO queues ──> scheduler ──placement──┐
    (any thread;   bounded: admission         (collect, shed,       │
     returns a      control + back-            pad to bucket)       v
     Future)        pressure)              per-device queues + workers
                                            (steal when idle; a bound
                                             view each; pipelined)
                                                       │
                                   shared done queue ──┴──> completer
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
* **Device pool** — :meth:`Server.start` binds every hosted executable to
  each of ``devices`` devices (``Executable.bind``: its own stream, pinned
  staging ring, one CUDA graph per bucket, captured while warming), and
  the pool places closed batches on per-device queues, steals for idle
  workers, and pipelines ``max_inflight`` batches per device
  (``serve.pool``). With ``device="cpu"`` (asked for explicitly),
  ``devices=N`` runs N emulated CPU workers.
* **Admission control + backpressure** — queued frames are bounded by
  ``max_queue``: ``submit(block=False)`` raises :class:`AdmissionError`
  when full, ``block=True`` (default) waits for room.
* **Deadline shedding** — a request whose ``deadline_ms`` has passed when
  its batch is formed fails with :class:`DeadlineExceeded`.
* **Stop** — ``stop(drain=True)`` serves the backlog first,
  ``drain=False`` fails it with :class:`ServerClosed`.
* **Test seams** — every timestamp and timed wait goes through an
  injectable :class:`~repro_torch.serve.clock.Clock`, and
  :class:`Hooks` exposes the batch-close decision and the device execute
  call (fault injection, emulated devices).
* **Observability** (``repro_torch.obs``) — every request carries a
  ``trace_id`` (``<program>/req-<seq>``); once answered, its latency is
  stitched into the trace as queue-wait → batch-assembly → device → split
  spans on a lane of its own, from the server clock's timestamps. Per
  program :class:`~repro_torch.obs.SLO` objectives are watched on every
  outcome; a breach, a worker failure or a stop that strands batches
  counts, logs (``Server.log``, a structured JSON-lines log) and takes a
  rate-limited flight-recorder dump. ``health()``, ``readiness()``,
  ``prometheus_metrics()`` and ``stats()`` are served over HTTP by the
  admin endpoint (``ServeConfig(admin_port=)``, ``serve.admin``).

Every hook observes shapes, counts and host timestamps: none reads a
tensor, so none adds work to a captured graph, and a flight dump is host
memory only.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import queue as queue_mod
import threading
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.program import (Executable, Options, Program,
                                      resolve_device)
from repro_torch.obs.slo import SLO, SLOMonitor
from repro_torch.serve import batcher
from repro_torch.serve import pool as pool_mod
from repro_torch.serve.clock import Clock
from repro_torch.serve.metrics import ProgramMetrics

# Chrome-trace lane ids of the per-request timelines: a request's spans are
# recorded after it is answered (its life crosses three threads), so they
# go on a synthetic lane per request, not on a live thread's span stack.
_REQ_LANE_BASE = 1 << 20


class AdmissionError(RuntimeError):
    """The bounded request queue is full (non-blocking submit, or the
    blocking wait timed out)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before the device got to it."""


class ServerClosed(RuntimeError):
    """The server is stopped (or stopping) and not accepting work."""


@dataclasses.dataclass
class Hooks:
    """Injectable observation and override points.

    ``batch_close``  ``(program, reason, frames)``, called the moment a
                     micro-batch stops collecting; reason is ``"full"``,
                     ``"speculative"`` (a device was idle), ``"window"``
                     (``max_wait_ms`` elapsed) or ``"stop"`` (draining).
    ``execute``      wraps every device execution as ``execute(program,
                     device, frames, bucket, default)``: ``default()`` runs
                     the bound view (and returns its pending result).
                     Return an array to substitute the result, call
                     ``default()`` to pass through, or raise to fail exactly
                     that batch with a :class:`WorkerError`.
    """

    batch_close: Optional[Callable[[str, str, int], None]] = None
    execute: Optional[Callable] = None


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
                       drained while a device is idle.
    ``devices``        pool width: one bound view of every program per
                       device (``None``: 1). On ``cuda`` it is checked
                       against ``torch.cuda.device_count()`` at
                       :meth:`Server.start`; on the CPU it is that many
                       emulated workers.
    ``placement``      ``least_loaded`` or ``round_robin``
                       (``serve.pool.PLACEMENTS``); a policy object can be
                       given as ``Server(placement=...)``.
    ``device``         where the pool runs (``cuda``, the first of
                       ``devices`` cards; ``cpu`` only if asked), and where
                       programs compile when ``register`` gets no options.
    ``admin_port``     serve the admin endpoint (``/healthz`` ``/readyz``
                       ``/metrics`` ``/statusz`` ``/tracez``,
                       ``serve.admin``) on this port while the server runs;
                       ``0`` binds an ephemeral port (``Server.admin.port``),
                       ``None`` none.
    ``admin_host``     its bind address (loopback by default).
    ``log_path``       the structured JSON-lines log's file (``None``: the
                       in-memory tail only, ``Server.log``).
    ``flight_dump_dir``  where triggered flight dumps are written (``None``:
                       kept in memory only, ``Server.flight_dumps()``).
    ``flight_dump_interval_s``  least time between two triggered dumps;
                       suppressed triggers are counted.
    ``flight_dump_keep``  how many dumps the in-memory ring keeps.
    """

    max_batch: int = 8
    max_wait_ms: float = 2.0
    max_queue: int = 256
    max_inflight: int = 2
    batch_buckets: Optional[Tuple[int, ...]] = None
    default_deadline_ms: Optional[float] = None
    speculative_close: bool = True
    devices: Optional[int] = None
    placement: str = "least_loaded"
    device: str = "cuda"
    admin_port: Optional[int] = None
    admin_host: str = "127.0.0.1"
    log_path: Optional[str] = None
    flight_dump_dir: Optional[str] = None
    flight_dump_interval_s: float = 30.0
    flight_dump_keep: int = 4

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
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.placement not in pool_mod.PLACEMENTS:
            raise ValueError(
                f"unknown placement {self.placement!r}; known: "
                f"{sorted(pool_mod.PLACEMENTS)}")
        if self.admin_port is not None and not (0 <= self.admin_port <= 65535):
            raise ValueError(
                f"admin_port must be in [0, 65535], got {self.admin_port}")
        if self.flight_dump_interval_s < 0:
            raise ValueError(
                f"flight_dump_interval_s must be >= 0, got "
                f"{self.flight_dump_interval_s}")
        if self.flight_dump_keep < 1:
            raise ValueError(
                f"flight_dump_keep must be >= 1, got {self.flight_dump_keep}")
        resolve_device(self.device)


@dataclasses.dataclass
class _Request:
    frames: np.ndarray                # [n, H, W, C]
    n: int
    future: Future
    t_submit: float
    deadline: Optional[float]         # absolute, server-clock seconds
    trace_id: str = ""                # per-request id, across threads
    seq: int = 0                      # request ordinal (trace lane id)


@dataclasses.dataclass
class HostedProgram:
    """One program slot in the router: executable + queue + metrics.

    ``executable`` is the unbound one ``register`` compiled; ``bound`` holds
    the pool's view of it, one ``Executable.bind`` per device (set by
    :meth:`Server.start`).
    """

    name: str
    program: Program
    executable: Executable
    buckets: Tuple[int, ...]
    queue: deque = dataclasses.field(default_factory=deque)
    metrics: ProgramMetrics = dataclasses.field(default_factory=ProgramMetrics)
    bound: Tuple[Executable, ...] = ()
    slo: Optional[SLOMonitor] = None  # rolling-window objectives (obs.slo)


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
    ``clock``, ``hooks`` and ``placement`` (a policy object overriding
    ``config.placement``) are test seams.
    """

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 clock: Optional[Clock] = None,
                 hooks: Optional[Hooks] = None, placement=None):
        self.config = config or ServeConfig()
        self._clock = clock or Clock()
        self._hooks = hooks or Hooks()
        self._ndev = self.config.devices or 1
        self._placement = (placement if placement is not None
                           else pool_mod.PLACEMENTS[self.config.placement]())
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
        self._req_seq = itertools.count()
        self.log = obs.StructuredLog(path=self.config.log_path)
        self.admin = None                      # serve.admin.AdminServer
        # triggered flight dumps: rate-limited, an in-memory ring and
        # optional files
        self._dump_lock = threading.Lock()
        self._flight_dumps: deque = deque(maxlen=self.config.flight_dump_keep)
        self._last_dump_t: Optional[float] = None
        self._dump_seq = 0
        self._dumps_suppressed = 0
        self._last_dump_reason: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------

    def register(self, name: str, program: Program,
                 options: Optional[Options] = None,
                 buckets: Optional[Sequence[int]] = None,
                 slo: Optional[SLO] = None) -> HostedProgram:
        """Host ``program`` under ``name``; compiles it now (on the
        config's device when no ``options`` are given). ``slo`` declares
        rolling-window objectives for it: a breach counts
        ``slo.breach.<name>``, logs and triggers a flight dump."""
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
                               metrics=ProgramMetrics(name=name),
                               slo=SLOMonitor(name, slo) if slo else None)
        self._programs[name] = hosted
        return hosted

    def _pool_devices(self) -> Tuple[torch.device, ...]:
        """The pool's devices: ``devices`` cards from ``config.device`` on;
        on the CPU, that many emulated workers on the one CPU device."""
        base = torch.device(self.config.device)
        if base.type != "cuda":
            return (base,) * self._ndev
        first = base.index or 0
        local = torch.cuda.device_count()
        if first + self._ndev > local:
            raise ValueError(
                f"devices={self._ndev} from {base} but only {local} local "
                f"CUDA device(s)")
        return tuple(torch.device("cuda", first + i)
                     for i in range(self._ndev))

    def start(self, warm: bool = True) -> "Server":
        """Bind every hosted executable to each pool device and launch the
        workers and the scheduler/completer threads; with ``warm``, run
        every (device, bucket) once first, which captures the bound views'
        CUDA graphs."""
        if self._started:
            raise RuntimeError("server already started")
        if not self._programs:
            raise RuntimeError("no programs registered")
        devices = self._pool_devices()
        # the staging ring is as deep as the per-device pipeline: a worker
        # may have max_inflight batches dispatched but not yet awaited
        slots = max(2, self.config.max_inflight)
        for hosted in self._programs.values():
            hosted.bound = tuple(hosted.executable.bind(d, staging_slots=slots)
                                 for d in devices)
        if warm:
            for hosted in self._programs.values():
                for exe in hosted.bound:
                    exe.warm(hosted.buckets)
        self._warmed = warm
        self._pool = pool_mod.Pool(
            self._ndev, self._placement, self._done, clock=self._clock,
            execute_hook=self._hooks.execute,
            pipeline=self.config.max_inflight,
            names=[str(d) if d.type == "cuda" else f"{d}#{i}"
                   for i, d in enumerate(devices)])
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
        if self.config.admin_port is not None:
            from repro_torch.serve.admin import AdminServer
            self.admin = AdminServer(self, port=self.config.admin_port,
                                     host=self.config.admin_host).start()
        self.log.info("serve.start", devices=self._ndev,
                      programs=sorted(self._programs),
                      admin_port=self.admin.port if self.admin else None)
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
        # the admin endpoint outlives the serving threads, so a probe while
        # stopping reads "unhealthy"; it goes down last
        if self.admin is not None:
            self.admin.stop(timeout)
        self.log.info("serve.stop", drain=drain)

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
        if queued or inflight:
            self.log.error("serve.stop.stranded",
                           queued=len(queued), inflight=len(inflight))
            self._flight_dump("stop_timeout")
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
        seq = next(self._req_seq)
        req = _Request(frames, n, Future(), t_submit,
                       t_submit + deadline_ms / 1e3
                       if deadline_ms is not None else None,
                       trace_id=f"{name}/req-{seq}", seq=seq)
        if obs.recording():
            obs.event("serve.submit", attrs={"program": name, "frames": n},
                      trace_id=req.trace_id)
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
                                              cfg.speculative_close,
                                              devices=self._ndev):
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
                        self._observe_slo(hosted, "shed", t)
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
                    t_fail = self._clock.now()
                    for _ in range(failed):
                        self._observe_slo(hosted, "failed", t_fail)
                    self.log.error(
                        "serve.worker.failure", program=hosted.name,
                        device=item.device, requests=failed,
                        error=str(item.error))
                    # the incident the flight recorder is for: keep the
                    # moments before it (host memory only: after a sticky
                    # CUDA error no device call works)
                    self._flight_dump(f"worker_error:{hosted.name}")
                    continue
                hosted.metrics.record_batch(
                    batcher.padded_slots(batch.n, batch.bucket),
                    batch.t_dispatch, frames=batch.n)
                for part, req in zip(
                        batcher.split_results(item.out, [r.n for r in live]),
                        live):
                    if not _settle(req.future, result=part):
                        continue           # a timed-out stop() failed it
                    t_done = self._clock.now()
                    hosted.metrics.record_served(t_done - req.t_submit,
                                                 req.n, t_done)
                    self._observe_slo(hosted, "served", t_done,
                                      latency_ms=(t_done - req.t_submit) * 1e3)
                    if obs.recording():
                        self._emit_request_timeline(
                            hosted, req, batch.bucket, item.device,
                            batch.t_closed, batch.t_dispatch, item.t_ready,
                            t_done)
            finally:
                with self._cond:
                    self._active_batches -= 1
                    self._cond.notify_all()

    @staticmethod
    def _emit_request_timeline(hosted: HostedProgram, req: _Request,
                               bucket: int, device: int, t_closed: float,
                               t_dispatch: float, t_ready: float,
                               t_done: float) -> None:
        """One request's latency as four spans on its own lane, all with
        its ``trace_id``: queue-wait, batch-assembly, device (dispatch to
        the answer waited for on the host), split. The device phase names
        the pool device that ran it."""
        lane = _REQ_LANE_BASE + req.seq
        attrs = {"program": hosted.name, "frames": req.n, "bucket": bucket,
                 "device": device}
        for name, t0, t1 in (
                ("serve.request.queue_wait", req.t_submit, t_closed),
                ("serve.request.batch_assembly", t_closed, t_dispatch),
                ("serve.request.device", t_dispatch, t_ready),
                ("serve.request.split", t_ready, t_done)):
            obs.span_at(name, t0, t1, attrs=attrs, trace_id=req.trace_id,
                        lane_tid=lane, lane=req.trace_id)

    # -- SLOs and incident capture -------------------------------------------

    def _observe_slo(self, hosted: HostedProgram, kind: str, t: float,
                     latency_ms: Optional[float] = None) -> None:
        """Feed one request outcome to the program's SLO monitor, if any,
        and handle every breach its evaluation reports."""
        if hosted.slo is None:
            return
        for breach in hosted.slo.observe(kind, t, latency_ms=latency_ms):
            self._handle_breach(hosted, breach)

    def _handle_breach(self, hosted: HostedProgram, breach: Dict) -> None:
        """One SLO breach: counter, event, structured log line, dump."""
        obs.counter(f"slo.breach.{hosted.name}").inc()
        obs.event("serve.slo.breach",
                  attrs={"program": hosted.name, **breach})
        self.log.warning("serve.slo.breach", program=hosted.name, **breach)
        self._flight_dump(
            f"slo:{hosted.name}:{breach['objective']}", detail=breach)

    def _flight_dump(self, reason: str,
                     detail: Optional[Dict] = None) -> Optional[Dict]:
        """Dump the flight recorder, at most once per
        ``config.flight_dump_interval_s``. Returns the dump, or None when
        no recorder is installed or the rate limit suppressed it.

        The ``flight.trigger`` event is recorded before the dump, so the
        dump shows where in the retained history the incident sits
        (``check_trace.py --flight`` wants spans from before it)."""
        fl = obs.get_flight()
        if fl is None:
            return None
        t = self._clock.now()
        with self._dump_lock:
            if (self._last_dump_t is not None
                    and t - self._last_dump_t
                    < self.config.flight_dump_interval_s):
                self._dumps_suppressed += 1
                return None
            self._last_dump_t = t
            self._last_dump_reason = reason
            self._dump_seq += 1
            seq = self._dump_seq
        obs.event("flight.trigger", attrs={"reason": reason,
                                           **(detail or {})})
        dump = fl.dump(reason=reason)
        path = None
        if self.config.flight_dump_dir is not None:
            slug = "".join(c if c.isalnum() else "-" for c in reason)[:48]
            path = os.path.join(self.config.flight_dump_dir,
                                f"flight-{seq:03d}-{slug}.json")
            os.makedirs(self.config.flight_dump_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(dump, f)
        with self._dump_lock:
            self._flight_dumps.append(
                {"seq": seq, "reason": reason, "t": t, "path": path,
                 "records": dump["otherData"]["records"], "dump": dump})
        self.log.info("serve.flight.dump", reason=reason, path=path,
                      records=dump["otherData"]["records"])
        return dump

    def flight_dumps(self) -> list:
        """The retained triggered dumps, oldest first (metadata + dump)."""
        with self._dump_lock:
            return list(self._flight_dumps)

    # -- health and the admin surface ----------------------------------------

    def health(self) -> Dict[str, object]:
        """The ``/healthz`` answer: started, not stopping, and every serving
        thread running (a pool that lost one worker still serves, but is
        reported unhealthy)."""
        pool = self._pool
        with self._cond:
            stopping = self._stopping
        checks = {
            "started": self._started,
            "not_stopping": not stopping,
            "scheduler_alive": (self._scheduler is not None
                                and self._scheduler.is_alive()),
            "completer_alive": (self._completer is not None
                                and self._completer.is_alive()),
            "pool_workers": pool.workers_alive() if pool is not None else 0,
            "pool_size": pool.size if pool is not None else 0,
        }
        healthy = bool(
            checks["started"] and checks["not_stopping"]
            and checks["scheduler_alive"] and checks["completer_alive"]
            and pool is not None and pool.healthy())
        return {"healthy": healthy, "checks": checks}

    def readiness(self) -> Dict[str, object]:
        """The ``/readyz`` answer: healthy, every bound view has its graph
        for every bucket (a first replay would otherwise pay the capture),
        and the admission queue has room."""
        h = self.health()
        with self._cond:
            depth = self._queued_total
        checks = {
            "warmed": self._warmed and all(
                exe.captured(hosted.buckets)
                for hosted in self._programs.values()
                for exe in hosted.bound),
            "queue_depth": depth,
            "max_queue": self.config.max_queue,
            "queue_has_room": depth < self.config.max_queue,
        }
        ready = bool(h["healthy"] and checks["warmed"]
                     and checks["queue_has_room"])
        return {"ready": ready, "checks": {**h["checks"], **checks}}

    def prometheus_metrics(self) -> str:
        """Every registry the server touches in one exposition: the
        process-wide ``obs.REGISTRY`` (plan cache, conv dispatch, SLO
        breaches), each hosted program's and the pool's."""
        parts = [obs.prometheus_text()]
        for hosted in self._programs.values():
            parts.append(obs.prometheus_text(hosted.metrics.registry))
        if self._pool is not None:
            parts.append(obs.prometheus_text(self._pool.registry))
        return "".join(parts)

    # -- observability -----------------------------------------------------

    def stats(self, verbose: bool = False) -> Dict[str, object]:
        """JSON-able snapshot: per-program counters, latency percentiles,
        achieved frames/s and padding waste, each program's modeled device
        FPS/W from its power report (and the measured rate against it),
        the plan cache, the pool's per-device rows and the kernel launch
        counts, the conv dispatch counts, the flight dumps and each
        program's SLO window. ``verbose`` adds each program's
        batch-occupancy and padding-waste histograms and the whole
        ``obs.REGISTRY`` (``serve.format_stats`` renders them)."""
        from repro_torch.core.plan import plan_cache_stats
        from repro_torch.kernels import launch_counts
        programs = {}
        totals = {"submitted": 0, "served": 0, "shed_deadline": 0,
                  "rejected": 0, "failed": 0}
        frames_served = 0
        for name, hosted in self._programs.items():
            snap = hosted.metrics.snapshot()
            r = hosted.executable.report
            # the measured rate at the modeled device power: the drift
            # isolates host and scheduling losses from the power model
            e_frame = (r.avg_power_w / r.fps) if r.fps else 0.0
            measured = ((snap["achieved_fps"] / 1e3) / r.avg_power_w
                        if r.avg_power_w else 0.0)
            snap["model"] = {"fps": r.fps, "avg_power_w": r.avg_power_w,
                             "kfps_per_w": r.kfps_per_w,
                             "energy_per_frame_j": e_frame,
                             "modeled_energy_j":
                                 e_frame * snap["frames_served"]}
            snap["measured_kfps_per_w"] = measured
            snap["kfps_per_w_drift"] = (measured / r.kfps_per_w
                                        if r.kfps_per_w else 0.0)
            snap["buckets"] = list(hosted.buckets)
            if hosted.slo is not None:
                snap["slo"] = hosted.slo.state(self._clock.now())
            if verbose:
                snap["histograms"] = hosted.metrics.histograms()
            programs[name] = snap
            for k in totals:
                totals[k] += snap["requests"][k]
            frames_served += snap["frames_served"]
        with self._cond:
            depth = self._queued_total
        cache = plan_cache_stats()
        lookups = cache["hits"] + cache["misses"]
        strategies = {
            kind: c.get() for kind in ("resident", "strip", "fused",
                                       "reference")
            if (c := obs.REGISTRY.get(f"dispatch.conv.{kind}")) is not None}
        out = {
            "config": dataclasses.asdict(self.config),
            "queue_depth": depth,
            "frames_served": frames_served,
            "requests": totals,
            "plan_cache": {**cache, "hit_rate": (cache["hits"] / lookups
                                                 if lookups else 0.0)},
            "conv_dispatch": strategies,
            "kernel_launches": launch_counts(),
            "programs": programs,
        }
        if self._pool is not None:
            out["pool"] = self._pool.stats()
        with self._dump_lock:
            out["flight"] = {
                "dumps": self._dump_seq,
                "suppressed": self._dumps_suppressed,
                "last_reason": self._last_dump_reason,
                "retained": [{k: v for k, v in d.items() if k != "dump"}
                             for d in self._flight_dumps],
            }
        fl = obs.get_flight()
        if fl is not None:
            out["flight"]["recorder"] = fl.stats()
        if verbose:
            out["obs"] = obs.REGISTRY.snapshot()
        return out
