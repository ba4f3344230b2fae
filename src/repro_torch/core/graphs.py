"""A bound view's host path: its own stream, its weights made once, a ring
of pinned staging buffers and one CUDA graph per batch bucket.

The port's counterpart of the reference's device-bound ``Executable`` and
of its executor, which XLA compiles once per plan and batch shape. PyTorch
runs eagerly; a CUDA graph is how it gets "compiled once per shape"
without ``torch.compile``, whose inductor fuses elementwise chains and may
contract FMAs, which breaks bitwise parity. A graph replays exactly the
kernels and copies the eager executor launched while it was captured, so
its answers are the eager ones, bit for bit.

    Binding(plan, params, device, backend, staging_slots)
        params on the device once; each conv and dense weight quantized once
        (``plan.quantized_weights``), and the levels laid out once for
        the kernel that runs each layer (the int8 strip conv's, and
        photonic_mvm's for the dense layers and resident convs); the
        chain kernel's range check run once over every fused segment,
        unless the plan verifier has proven it
        (``CompiledPlan.exact_proven``), so no capture reads the device for
        it.
    Binding.run_padded(frames, bucket) -> HostResult
        per chunk of ``bucket`` frames: the chunk into a pinned staging
        slot, the slot into the bucket's static input (H2D), ``replay()``,
        the static output into a pinned host tensor from PyTorch's caching
        host allocator (D2H) -- all on the binding's stream -- and an event
        behind the last copy; waiting on it copies the answer out to
        pageable memory and hands the pinned tensor back to the cache.
    Binding.warm(buckets)
        runs each bucket once, which captures its graph.

On the CPU (which a caller asks for explicitly) there is nothing to pin or
capture: the ring holds numpy buffers and each chunk runs eagerly.

Hazards the design rules out:

* the static output is overwritten by the next replay, and a pool worker
  dispatches batch N+1 before it waits for batch N. Every D2H copy is
  enqueued on the stream right behind its replay, before this call
  returns, into a host tensor of its own, and the answer handed back is
  copied out of that, so no result aliases a static output, a staging
  slot or a pinned buffer that the allocator will hand out again;
* a staging slot is rewritten only after the event recorded behind its
  last H2D copy has completed;
* kernels built and lookup tables copied on first use (``kernels._build``,
  ``compressive._bilinear_taps``, ``ca_pool.ops._coefficients``) would be
  synchronous work inside a capture: the eager run before each capture
  makes them exist first.

A capture or replay that fails raises; nothing falls back to the eager
path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.kernels import credit_launches, recording_launches

# Automatic garbage collection is held off while any thread captures: a
# collection that ran inside a capture, in the capturing thread, would
# destroy the graphs of views that only a dead reference cycle still held
# there, and a graph destroyed in a capturing thread invalidates the
# capture (cudaErrorStreamCaptureInvalidated; the card showed it when a
# server started right after another had stopped). The count lets
# captures on several devices' threads overlap.
_capture_gc = threading.Lock()
_capture_holds = 0
_capture_gc_was_on = False


@contextlib.contextmanager
def _no_collection():
    global _capture_holds, _capture_gc_was_on
    with _capture_gc:
        if _capture_holds == 0:
            _capture_gc_was_on = gc.isenabled()
            gc.disable()
        _capture_holds += 1
    try:
        yield
    finally:
        with _capture_gc:
            _capture_holds -= 1
            if _capture_holds == 0 and _capture_gc_was_on:
                gc.enable()


class HostResult:
    """A batch's answer on its way to host memory.

    ``wait()`` blocks on the CUDA event recorded behind the batch's
    device-to-host copy (not on the whole device) and returns the answer as
    numpy; ``np.asarray(result)`` does the same. On CUDA the answer is
    copied out of its pinned buffer into pageable memory, and the pinned
    buffer goes back to PyTorch's caching host allocator: callers may hold
    answers for as long as they like without holding pinned memory, and
    the next batch's buffer is a cached block, not a new page-locked
    allocation (milliseconds each on the H100's host, PERF.md).
    """

    def __init__(self, parts: List[Tuple[torch.Tensor, int]],
                 event: Optional[torch.cuda.Event] = None):
        self._parts = parts           # (host tensor [bucket, ...], real rows)
        self._event = event
        self._out: Optional[np.ndarray] = None

    def wait(self) -> np.ndarray:
        if self._out is None:
            if self._event is not None:
                self._event.synchronize()
            arrays = [t[:real].numpy() for t, real in self._parts]
            if len(arrays) > 1:
                self._out = np.concatenate(arrays)
            elif self._event is not None:
                self._out = arrays[0].copy()
            else:
                self._out = arrays[0]
            self._parts = None
        return self._out

    def __array__(self, dtype=None, copy=None):
        out = self.wait()
        return out if dtype is None else out.astype(dtype)


@dataclasses.dataclass(eq=False)
class _Slot:
    """One host staging buffer: ``array`` (on CUDA a view of the pinned
    ``tensor``) and the event behind the last H2D copy out of it."""

    array: np.ndarray
    tensor: Optional[torch.Tensor] = None
    event: Optional[torch.cuda.Event] = None


@dataclasses.dataclass(eq=False)
class BucketGraph:
    """One bucket's captured executor: replaying ``graph`` runs the plan on
    ``static_in`` into ``static_out``. ``launches`` is what the capture
    recorded per kernel; each replay credits it to the launch counts and
    adds one to ``replays``."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: Dict[str, int]
    replays: int = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        credit_launches(self.launches)


class Binding:
    """The state of one bound view (see the module docstring). One caller
    at a time: a pool worker owns its bound view."""

    def __init__(self, plan: plan_mod.CompiledPlan, params: Dict[str, Dict],
                 device: torch.device, backend: str, staging_slots: int):
        if staging_slots < 1:
            raise ValueError(
                f"staging_slots must be >= 1, got {staging_slots}")
        self.plan = plan
        self.params = params
        self.device = device
        self.backend = backend
        self.staging_slots = int(staging_slots)
        self.staging: Dict[tuple, List[_Slot]] = {}
        self.graphs: Dict[int, BucketGraph] = {}
        self.stream: Optional[torch.cuda.Stream] = None
        if device.type != "cuda":
            self.weights = plan_mod.quantized_weights(
                plan.steps, params, plan.consts, plan.strip_routes)
            return
        self.stream = torch.cuda.Stream(device)
        # the params were copied on the device's current stream
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(self.stream):
            self.weights = plan_mod.quantized_weights(
                plan.steps, params, plan.consts, plan.strip_routes)
            if backend == "kernel" and not plan.exact_proven:
                self._check_segments()
        self.stream.synchronize()
        # the buckets replay one after another on one stream, so their
        # graphs may share one memory pool
        self._pool = torch.cuda.graph_pool_handle()

    def _check_segments(self) -> None:
        """The chain kernel's float32 range check, once per fused segment
        over the view's fixed weights (it may read the device), for a plan
        the verifier has not proven."""
        from repro_torch.kernels.conv_bank.fused import check_exact
        steps = self.plan.steps
        for seg in self.plan.fused_segments:
            stages = []
            for s in steps[seg.start:seg.start + seg.length]:
                wq, ws, _ = self.weights[s.name]
                stages.append((s.geom, wq, ws, None))
            check_exact(stages, self.plan.consts["a_qmax"])

    def execute(self, frames: torch.Tensor) -> torch.Tensor:
        """The eager per-frame executor on this view's params and weights."""
        return plan_mod._execute(self.plan, self.params, frames,
                                 per_frame=True, backend=self.backend,
                                 weights=self.weights)

    # -- CUDA graphs ---------------------------------------------------------

    def graph(self, bucket: int) -> BucketGraph:
        """The bucket's graph, captured on first use."""
        g = self.graphs.get(bucket)
        if g is None:
            g = self.graphs[bucket] = self._capture(bucket)
        return g

    def _capture(self, bucket: int) -> BucketGraph:
        shape = (bucket, *self.plan.frame_shape)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            static_in = torch.zeros(shape, dtype=torch.float32,
                                    device=self.device)
            # eager first: builds and loads the kernels, fills the cached
            # device tables, sets the kernels' shared-memory attributes
            self.execute(static_in)
        self.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with _no_collection(), torch.cuda.device(self.device), \
                recording_launches() as tally:
            with torch.cuda.graph(graph, pool=self._pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                static_out = self.execute(static_in)
        return BucketGraph(graph, static_in, static_out, dict(tally))

    # -- staging ring --------------------------------------------------------

    def _new_slot(self, shape: Tuple[int, ...]) -> _Slot:
        if self.stream is None:
            return _Slot(np.zeros(shape, np.float32))
        t = torch.zeros(shape, dtype=torch.float32, pin_memory=True)
        return _Slot(t.numpy(), t, torch.cuda.Event())

    def _slot(self, bucket: int, frame_shape: Tuple[int, ...]) -> _Slot:
        """The next slot of the (bucket, frame shape) ring, after the event
        behind its last H2D copy has completed. The whole ring is allocated
        at its first use (page-locking is slow: at warm-up, not while
        serving)."""
        key = (bucket, frame_shape)
        ring = self.staging.get(key)
        if ring is None:
            ring = self.staging[key] = [
                self._new_slot((bucket, *frame_shape))
                for _ in range(self.staging_slots)]
        slot = ring.pop(0)
        if slot.event is not None:
            slot.event.synchronize()
        ring.append(slot)
        return slot

    def run_padded(self, frames: np.ndarray, bucket: int) -> HostResult:
        """``frames`` [n, H, W, C] float32 in ``bucket``-sized chunks, each
        zero-padded to the bucket; the answer is pending on the stream."""
        parts = []
        for off in range(0, frames.shape[0], bucket):
            chunk = frames[off:off + bucket]
            real = chunk.shape[0]
            slot = self._slot(bucket, chunk.shape[1:])
            slot.array[:real] = chunk
            slot.array[real:] = 0.0
            if self.stream is None:
                parts.append((self.execute(torch.from_numpy(slot.array)),
                              real))
                continue
            g = self.graph(bucket)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                g.static_in.copy_(slot.tensor, non_blocking=True)
                slot.event.record(self.stream)
                g.replay()
                host = torch.empty(g.static_out.shape, dtype=torch.float32,
                                   pin_memory=True)
                host.copy_(g.static_out, non_blocking=True)
            parts.append((host, real))
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(self.stream)
        return HostResult(parts, event)

    def warm(self, buckets: Sequence[int]) -> None:
        """Run a zero batch at each bucket (capturing its graph on CUDA)
        and wait for it."""
        for b in sorted({int(b) for b in buckets}):
            if b < 1:
                raise ValueError(f"bucket must be >= 1, got {b}")
            self.run_padded(np.zeros((b, *self.plan.frame_shape),
                                     np.float32), b).wait()
