"""Host data pipeline with background prefetch.

  * deterministic batch(step) — restart-safe: no hidden iterator state,
    the checkpoint stores only the step counter;
  * per-process slicing: each process materializes only its rows of the
    global batch (``process_slice``: the rank and world size of
    ``torch.distributed`` when it is initialized, else 0 and 1); with
    ``mesh=`` and ``placements=`` (``launch.shardings.batch_shardings``,
    the counterpart of the reference's ``shardings=``) each batch becomes
    DTensors, every rank uploading only its slice;
  * prefetch: a worker thread makes ``batch_fn(step)`` ahead of the
    consumer, ``prefetch`` batches deep.

With ``device`` a CUDA device the worker also uploads each batch: numpy
arrays to pinned memory, then a non-blocking copy on the pipeline's own
stream, whose completion an event records. ``next()`` makes the
consumer's current stream wait on that event (no host wait) and marks the
tensors as used on that stream, so the caching allocator does not hand
their memory to the copy stream while the consumer still reads them.
With ``device="cpu"`` the arrays become tensors (``torch.from_numpy``);
with no device they are returned as ``batch_fn`` made them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import distribute, local_tensor


class DataPipeline:
    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 device=None, prefetch: int = 2, start_step: int = 0,
                 mesh=None, placements: Optional[Dict] = None):
        self.batch_fn = batch_fn
        self.device = None if device is None else torch.device(device)
        self.mesh, self.placements = mesh, placements
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None
                        and self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _upload(self, host_batch: Dict[str, np.ndarray]):
        """-> (batch, the copy's event or None)."""
        if self.device is None:
            return host_batch, None
        if self._stream is None:
            return {k: self._put(k, v) for k, v in host_batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: self._put(k, v, non_blocking=True)
                   for k, v in host_batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, key: str, v: np.ndarray, non_blocking: bool = False):
        """``v`` on the device: this rank's slice as a DTensor under
        ``placements``, else the whole array (through pinned memory when
        ``non_blocking``)."""
        if self.placements is not None:
            return distribute(v, self.mesh, self.placements[key],
                              self.device, non_blocking=non_blocking)
        t = torch.as_tensor(v)
        if non_blocking:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=non_blocking)

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            item = (step, *self._upload(self.batch_fn(step)))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=1.0)
                    step += 1
                    break
                except queue.Full:
                    continue

    def next(self):
        """-> (step, batch), in step order from ``start_step``."""
        step, batch, event = self._q.get()
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                local_tensor(t).record_stream(consumer)
        return step, batch

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    @staticmethod
    def process_slice(global_batch: int, process_index: int | None = None,
                      process_count: int | None = None) -> slice:
        """The rows of the global batch this process materializes."""
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        pi = process_index if process_index is not None else (
            dist.get_rank() if live else 0)
        pc = process_count if process_count is not None else (
            dist.get_world_size() if live else 1)
        per = global_batch // pc
        return slice(pi * per, (pi + 1) * per)
