"""repro_torch's fault tolerance (``distributed/fault_tolerance.py``) on
the CPU: every case of the reference's ``tests/test_fault_tolerance.py``,
each also run through the reference's module on the same toy loop (the
values of a restart within 1e-6, the reference test's bound; the
monitor's events and EWMA equal), and the SIGTERM path: the state after
the step in flight is saved, then the loop exits with 143.
"""

from __future__ import annotations

import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.distributed import fault_tolerance as jft
from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     RestartableLoop,
                                                     StragglerMonitor)


def _make_loop(tmp_path, fail_at=None, interval=2, **kw):
    """A deterministic toy training loop: state['x'] += mean(batch)."""

    def step_fn(state, batch):
        x = state["x"] + torch.mean(batch["v"])
        return {"x": x, "step": state["step"] + 1}, {"x": float(x)}

    def batch_fn(step):
        rng = np.random.default_rng(step)     # pure function of step
        return {"v": torch.from_numpy(rng.standard_normal(4).astype(
            np.float32))}

    ckpt = CheckpointManager(tmp_path, keep=3, save_interval_steps=interval)
    return RestartableLoop(step_fn, batch_fn, ckpt,
                           injector=FailureInjector(fail_at), **kw)


def _make_reference_loop(tmp_path, fail_at=None, interval=2):
    def step_fn(state, batch):
        x = state["x"] + jnp.mean(batch["v"])
        return {"x": x, "step": state["step"] + 1}, {"x": float(x)}

    def batch_fn(step):
        rng = np.random.default_rng(step)
        return {"v": jnp.asarray(rng.standard_normal(4), jnp.float32)}

    ckpt = JCheckpointManager(tmp_path, keep=3, save_interval_steps=interval)
    return jft.RestartableLoop(step_fn, batch_fn, ckpt,
                               injector=jft.FailureInjector(fail_at))


def _state0():
    return {"x": torch.zeros(()), "step": torch.zeros((), dtype=torch.int32)}


def test_crash_and_restart_bit_exact(tmp_path):
    # uninterrupted reference run
    ref_state, _, ref_hist = _make_loop(tmp_path / "ref").run(_state0(), 0,
                                                              10)
    # crashing run: fails at step 7 (last complete ckpt at step 6)
    loop = _make_loop(tmp_path / "crash", fail_at=7)
    with pytest.raises(RuntimeError, match="injected failure"):
        loop.run(_state0(), 0, 10)
    assert latest_step(tmp_path / "crash") == 6
    # restart: resumes from the checkpoint, replays deterministically
    final, last, hist = _make_loop(tmp_path / "crash").run(_state0(), 0, 10)
    assert last == 10 and int(final["step"]) == 10
    assert torch.equal(final["x"], ref_state["x"])
    assert hist == ref_hist[6:]
    # the reference's loop over the same stream
    jstate, jlast, _ = _make_reference_loop(tmp_path / "jax").run(
        {"x": jnp.zeros(()), "step": jnp.zeros((), jnp.int32)}, 0, 10)
    assert jlast == last
    np.testing.assert_allclose(float(final["x"]), float(jstate["x"]),
                               rtol=1e-6)


def test_restart_skips_completed_work(tmp_path):
    _make_loop(tmp_path).run(_state0(), 0, 10)
    # a fresh loop over the same dir should do zero extra steps
    _, last, history = _make_loop(tmp_path).run(_state0(), 0, 10)
    assert last == 10 and history == []
    _make_reference_loop(tmp_path / "jax").run(
        {"x": jnp.zeros(()), "step": jnp.zeros((), jnp.int32)}, 0, 10)
    _, jlast, jhistory = _make_reference_loop(tmp_path / "jax").run(
        {"x": jnp.zeros(()), "step": jnp.zeros((), jnp.int32)}, 0, 10)
    assert (jlast, jhistory) == (last, history)


def test_the_last_step_is_saved_once(tmp_path, monkeypatch):
    saves = []
    loop = _make_loop(tmp_path, interval=5)
    save = loop.ckpt.save
    monkeypatch.setattr(loop.ckpt, "save", lambda step, tree, **kw: (
        saves.append((step, kw.get("force", False))), save(step, tree,
                                                           **kw))[1])
    loop.run(_state0(), 0, 10)
    written = [s for s, force in saves
               if force or loop.ckpt.should_save(s)]
    assert written == [5, 10]
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()) \
        == [5, 10]


def test_sigterm_saves_then_exits_143(tmp_path):
    previous = signal.getsignal(signal.SIGTERM)
    try:
        loop = _make_loop(tmp_path, interval=100, handle_sigterm=True)
        step_fn = loop.step_fn

        def preempted_at_3(state, batch):
            if int(state["step"]) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(state, batch)

        loop.step_fn = preempted_at_3
        with pytest.raises(SystemExit) as exc:
            loop.run(_state0(), 0, 10)
        assert exc.value.code == 143
        # the step in flight finished and was saved
        assert latest_step(tmp_path) == 4
        final, last, _ = _make_loop(tmp_path).run(_state0(), 0, 10)
        ref, _, _ = _make_loop(tmp_path / "ref").run(_state0(), 0, 10)
        assert last == 10 and torch.equal(final["x"], ref["x"])
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=2)
    jmon = jft.StragglerMonitor(threshold=2.0, warmup_steps=2)
    for i in range(8):
        assert mon.record(i, 0.1) is None and jmon.record(i, 0.1) is None
    ev = mon.record(8, 0.5)                       # 5x the EWMA
    assert ev is not None and ev.ratio > 2.0
    assert len(mon.events) == 1
    # outlier must not poison the EWMA
    assert mon.ewma == pytest.approx(0.1, rel=1e-6)
    jev = jmon.record(8, 0.5)
    assert (ev.step, ev.step_time, ev.ewma, ev.ratio) == \
        (jev.step, jev.step_time, jev.ewma, jev.ratio)
    assert mon.ewma == jmon.ewma


def test_straggler_callback():
    hits, jhits = [], []
    mon = StragglerMonitor(threshold=1.5, warmup_steps=1,
                           on_straggler=hits.append)
    jmon = jft.StragglerMonitor(threshold=1.5, warmup_steps=1,
                                on_straggler=jhits.append)
    for m in (mon, jmon):
        m.record(0, 0.1)
        m.record(1, 0.1)
        m.record(2, 1.0)
    assert len(hits) == 1 and hits[0].step == 2
    assert [(h.step, h.ratio) for h in hits] == \
        [(h.step, h.ratio) for h in jhits]


def test_injector_fires_once():
    inj = FailureInjector(3)
    inj.maybe_fail(2)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        inj.maybe_fail(3)
    inj.maybe_fail(3)                              # second pass: no raise
    FailureInjector(None).maybe_fail(3)
