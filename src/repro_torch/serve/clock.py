"""Injectable time source for the serving runtime.

Every timestamp and timed condition-wait inside a :class:`~repro.serve.
Server` goes through one :class:`Clock` object, so tests can substitute a
:class:`VirtualClock` and assert scheduling *decisions* (which close
reason fired, how long the window was held) instead of racing the wall
clock — the deflaking contract for the timing tests in
``tests/test_torch_serve.py``.

The default :class:`Clock` is ``time.perf_counter`` plus a plain
``Condition.wait``. A copy of the reference package's module.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class Clock:
    """Real time: ``perf_counter`` + real condition waits (the default)."""

    def now(self) -> float:
        """Monotonic seconds."""
        return time.perf_counter()

    def wait(self, cond: threading.Condition, timeout: Optional[float] = None
             ) -> bool:
        """Wait on ``cond`` (which the caller holds) up to ``timeout``."""
        return cond.wait(timeout)


class VirtualClock(Clock):
    """Deterministic test clock: timed waits advance virtual time instantly.

    * ``now()`` returns the virtual time (starts at ``start`` seconds).
    * A **timed** ``wait`` advances the virtual clock by the full timeout
      and returns without sleeping — so "the scheduler held the batch
      window open for 400 ms" is observable as a 0.4 s virtual-time jump
      that costs the test microseconds of real time.
    * An **untimed** ``wait`` (waiting for work to arrive) blocks for
      real, because the thing it waits for — a submit from another
      thread — happens in real time.

    The jump-on-wait model means a virtual-clocked scheduler never
    coalesces two requests submitted "during" a hold window (the window
    elapses the moment it starts); the deflaked tests assert close
    *reasons* and virtual durations, not coalescing counts.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        """Manually advance virtual time (e.g. to expire a deadline)."""
        if dt < 0:
            raise ValueError(f"cannot advance time backwards ({dt})")
        with self._lock:
            self._t += dt
            return self._t

    def wait(self, cond: threading.Condition, timeout: Optional[float] = None
             ) -> bool:
        if timeout is None:
            return cond.wait()
        with self._lock:
            self._t += max(timeout, 0.0)
        # poll the condition without sleeping: racing notifies that are
        # already pending still land, but virtual time has moved on
        return cond.wait(0.0)
