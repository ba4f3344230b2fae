"""Fault tolerance: restartable training, straggler detection, preemption.

  * **checkpoint/restart** — ``RestartableLoop`` drives train steps with a
    ``CheckpointManager``; a crash resumes from the last complete step,
    and the continuation is bitwise the uninterrupted run's because a
    batch is a pure function of its step (and the step itself
    deterministic: on the card, under ``torch.use_deterministic_algorithms``
    where an op accumulates with atomics).
  * **preemption handling** — with ``handle_sigterm``, SIGTERM makes the
    loop save the state after the step in flight, then exit with 143.
  * **straggler mitigation** — ``StragglerMonitor`` keeps an EWMA of step
    times; a step slower than ``threshold`` x the EWMA is flagged, a
    callback fires, and the outlier is kept out of the EWMA.
  * **failure simulation** — ``FailureInjector`` raises at step k, once,
    for tests and drills.

Step times are the host's clock around ``batch_fn`` and ``step_fn``: on
the card a step that reads nothing back measures its launches only.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint.ckpt import CheckpointManager


class FailureInjector:
    """Raise RuntimeError at a chosen step (deterministic drills)."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step \
                and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float
    ratio: float


class StragglerMonitor:
    """EWMA step-time tracker; flags outliers (straggling hosts/steps)."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup_steps
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.events: list[StragglerEvent] = []
        self._n = 0

    def record(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        self._n += 1
        if self.ewma is None:
            self.ewma = step_time
            return None
        if self._n > self.warmup and step_time > self.threshold * self.ewma:
            ev = StragglerEvent(step, step_time, self.ewma,
                                step_time / self.ewma)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            return ev                      # the outlier stays out of the EWMA
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return None


class RestartableLoop:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with
    checkpoint/restart.

    ``state`` is a tree of tensors (params, optimizer state with its step
    counter). ``batch_fn(step)`` must be deterministic: a restart replays
    the exact stream.
    """

    def __init__(self, step_fn: Callable[[Any, Dict], Any],
                 batch_fn: Callable[[int], Dict],
                 ckpt: CheckpointManager,
                 injector: Optional[FailureInjector] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 handle_sigterm: bool = False):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.injector = injector
        self.monitor = monitor or StragglerMonitor()
        self._preempted = False
        if handle_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):
        self._preempted = True

    def run(self, state: Any, start_step: int, num_steps: int):
        """Restores the latest checkpoint (onto the devices of ``state``'s
        leaves) if there is one, then runs to ``num_steps``. Returns
        (final_state, last_step, metrics_history)."""
        restored = self.ckpt.restore_latest(state)
        if restored[0] is not None:
            start_step, state = restored
        history = []
        step = start_step
        saved = None
        while step < num_steps:
            if self.injector:
                self.injector.maybe_fail(step)
            t0 = time.time()
            batch = self.batch_fn(step)
            state, metrics = self.step_fn(state, batch)
            dt = time.time() - t0
            self.monitor.record(step, dt)
            history.append(metrics)
            step += 1
            if self._preempted:
                self.ckpt.save(step, state, force=True)
                raise SystemExit(143)
            if self.ckpt.save(step, state) is not None:
                saved = step
        if saved != step:                  # the last step's, once
            self.ckpt.save(step, state, force=True)
        return state, step, history
