"""The device worker: one CUDA device, one warmed Executable per program.

    scheduler ──> device queue ──> worker thread ──> done queue ──> completer
                                   (dispatch, then
                                    wait on the previous batch)

* **Per-device pipelining** — the worker dispatches a batch (the kernels
  are queued on the device asynchronously), then waits for the *previous*
  batch's result while the new one computes (``pipeline >= 2``; 1 runs
  each batch synchronously). The wait is a device-to-host copy
  (``.cpu()``), on the worker thread, so the completer never waits on the
  device.
* **Fault isolation** — an exception while executing a batch fails exactly
  that batch's requests with a typed :class:`WorkerError` (the original
  exception chained as ``__cause__``); the worker keeps running.

Results are bitwise equal to direct execution: the worker runs the
per-frame-calibrated ``Executable.run_padded``, under which each frame's
result is a pure function of that frame.

The reference runtime's multi-device pool (placement, work stealing) is
not ported: this pool has exactly one worker.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.serve.clock import Clock


class WorkerError(RuntimeError):
    """The device worker failed to execute a batch; only that batch's
    requests receive this error."""

    def __init__(self, message: str, program: str = "", device: int = -1):
        super().__init__(message)
        self.program = program
        self.device = device


@dataclasses.dataclass(eq=False)
class Batch:
    """One closed micro-batch in flight (identity semantics)."""

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
    out: Optional[np.ndarray]         # host-side result (None on error)
    error: Optional[BaseException]
    t_ready: float


_STOP = object()


class Pool:
    """One device worker + its queue; finished batches go to ``done``."""

    def __init__(self, done: queue_mod.Queue, clock: Optional[Clock] = None,
                 pipeline: int = 2):
        self._done = done
        self._clock = clock or Clock()
        self._pipeline = max(int(pipeline), 1)
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._inflight: List[Batch] = []
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._t_start: Optional[float] = None
        self._batches = 0
        self._frames = 0
        self._failures = 0
        self._busy_s = 0.0
        self._last_ready: Optional[float] = None

    def start(self) -> "Pool":
        self._t_start = self._clock.now()
        self._thread = threading.Thread(target=self._run,
                                        name="repro-torch-serve-device0",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain the queue, finish pending batches, join the worker. Every
        dispatched batch's completion is on ``done`` when this returns,
        provided the worker joined (check :meth:`alive`)."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def take_outstanding(self):
        """Reclaim what a timed-out :meth:`stop` left: ``(queued, inflight)``
        — queued batches are removed (they will never reach ``done``),
        in-flight ones may still complete, so settle them idempotently."""
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            return queued, list(self._inflight)

    def dispatch(self, batch: Batch) -> None:
        with self._cond:
            self._queue.append(batch)
            self._cond.notify_all()

    def _next(self, block: bool):
        with self._cond:
            while True:
                if self._queue:
                    return self._queue.popleft()
                if self._stopping:
                    return _STOP
                if not block:
                    return None
                self._cond.wait()

    def _run(self) -> None:
        pending = None                 # (batch, device result)
        while True:
            nxt = self._next(block=pending is None)
            if nxt is None:            # idle: finish the in-flight batch
                self._finish(*pending)
                pending = None
                continue
            if nxt is _STOP:
                if pending is not None:
                    self._finish(*pending)
                return
            out = self._dispatch_one(nxt)
            if pending is not None:
                self._finish(*pending)
                pending = None
            if out is not None:
                if self._pipeline > 1:
                    pending = (nxt, out)
                else:
                    self._finish(nxt, out)

    def _dispatch_one(self, batch: Batch):
        batch.t_dispatch = self._clock.now()
        with self._cond:
            self._inflight.append(batch)
        try:
            return batch.hosted.executable.run_padded(batch.frames,
                                                      batch.bucket)
        except Exception as e:          # noqa: BLE001 — isolate the batch
            self._fail(batch, e)
            return None

    def _finish(self, batch: Batch, out) -> None:
        """Wait for the device result (``.cpu()``); hand it to ``done``."""
        try:
            out_np = out.cpu().numpy()
        except Exception as e:          # noqa: BLE001 — isolate the batch
            self._fail(batch, e)
            return
        t_ready = self._clock.now()
        with self._cond:
            self._inflight.remove(batch)
            # the device is serial: a pipelined batch's busy time starts
            # when its predecessor finished, not when it was dispatched
            t0 = batch.t_dispatch
            if self._last_ready is not None and self._last_ready > t0:
                t0 = self._last_ready
            self._last_ready = t_ready
            self._busy_s += t_ready - t0
            self._batches += 1
            self._frames += batch.n
        self._done.put(Done(batch, out_np, None, t_ready))

    def _fail(self, batch: Batch, exc: BaseException) -> None:
        with self._cond:
            self._inflight.remove(batch)
            self._failures += 1
        err = WorkerError(
            f"device 0 failed executing a bucket-{batch.bucket} batch of "
            f"{batch.hosted.name!r}: {exc}", program=batch.hosted.name,
            device=0)
        err.__cause__ = exc
        self._done.put(Done(batch, None, err, self._clock.now()))

    def stats(self) -> dict:
        wall = None
        if self._t_start is not None:
            wall = max(self._clock.now() - self._t_start, 1e-9)
        with self._cond:
            return {
                "devices": 1,
                "pipeline": self._pipeline,
                "batches": self._batches,
                "frames": self._frames,
                "failures": self._failures,
                "queued_batches": len(self._queue),
                "inflight_batches": len(self._inflight),
                "busy_s": self._busy_s,
                "occupancy": self._busy_s / wall if wall else 0.0,
            }
