"""Micro-batching primitives: batch buckets, padding accounting, splitting.

Pure, thread-free helpers the scheduler (``serve.server``) composes:

* a server compiles each hosted program at a small set of **batch
  buckets** (powers of two up to ``max_batch`` by default) instead of
  running every queue length it ever observes;
* a collected micro-batch of ``n`` frames is padded up to the smallest
  bucket that holds it (``Executable.run_padded`` does the zero-padding —
  per-frame calibration makes the pad frames provably inert);
* results come back as one array and are **split** per-request by each
  request's frame count;
* a collecting batch **closes speculatively** (``should_close_early``)
  when the device pipeline is idle — the hold-open window only pays off
  while a previous batch is still computing.

The pad -> bucket -> split round trip is bitwise equal to running every
request directly (tests/test_torch_serve.py pins it). A copy of the
reference package's module.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch import obs


def power_of_two_buckets(max_batch: int) -> Tuple[int, ...]:
    """The default bucket ladder: 1, 2, 4, ... capped by ``max_batch``.

    ``max_batch`` itself is always a bucket (so a full collection window
    never pays padding), even when it is not a power of two.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = {max_batch}
    b = 1
    while b < max_batch:
        buckets.add(b)
        b <<= 1
    return tuple(sorted(buckets))


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``n`` frames; the largest if none does
    (the caller then runs in largest-bucket chunks — ``run_padded``)."""
    if n < 1:
        raise ValueError(f"cannot bucket {n} frames")
    best = max(buckets)
    for b in sorted(buckets):
        if b >= n:
            best = b
            break
    if obs.recording():
        obs.event("batcher.pick_bucket",
                  attrs={"frames": n, "bucket": best,
                         "pad": padded_slots(n, best) - n})
    return best


def padded_slots(n: int, bucket: int) -> int:
    """Device batch slots consumed serving ``n`` real frames at ``bucket``
    (chunked when ``n > bucket``) — the padding-waste numerator's basis."""
    return -(-n // bucket) * bucket


def should_close_early(queued_frames: int, cap: int, inflight_batches: int,
                       speculative: bool = True, devices: int = 1) -> bool:
    """Close a collecting micro-batch now instead of waiting out the window?

    The hold-open window (``max_wait_ms``) exists to let a batch fill while
    the device is busy with the previous one — coalescing there is free.
    When the device pipeline is *idle*, holding the batch open buys nothing:
    every waited millisecond is pure added latency, because the device could
    already be computing. So the scheduler closes speculatively as soon as
    the queue is drained (everything currently queued is collected, i.e. the
    batch stopped growing) and some device is idle — with a pool of
    ``devices`` workers, that is whenever fewer batches are in flight than
    there are devices to run them.

    Pure predicate so the policy is testable without threads; the server
    supplies its live counters and the ``ServeConfig.speculative_close``
    switch.
    """
    return (speculative and inflight_batches < max(devices, 1)
            and 0 < queued_frames < cap)


def split_results(out: np.ndarray, counts: Sequence[int]) -> list:
    """Split a stacked result [sum(counts), ...] back per request, as
    zero-copy views of ``out`` (a bound view's result is a host tensor of
    that batch alone, so no later batch writes under them)."""
    total = int(sum(counts))
    if out.shape[0] != total:
        raise ValueError(
            f"result batch {out.shape[0]} != sum of request sizes {total}")
    parts, off = [], 0
    for n in counts:
        parts.append(out[off:off + n])
        off += n
    if obs.recording():
        obs.event("batcher.split",
                  attrs={"requests": len(counts), "frames": total})
    return parts
