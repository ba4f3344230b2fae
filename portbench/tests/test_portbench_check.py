"""The correctness check at a small size on the CPU: a sound run is
correct; the control (the reference one precision step down) fails the
configured limit on every seed; and each fault a serving cell can have,
planted under the server, turns ``correct`` false."""

import numpy as np
import pytest
import torch

from portbench import control, harness, manifest
from portbench.tests.conftest import small_config, small_workload

CELL = "vgg9-ca-w4a4.tiles256-closed"
CONFIGS = ("vgg16-w4a4", "vgg9-ca-w4a4")


def _run(seed):
    cfg = small_config(manifest.config("vgg9-ca-w4a4"))
    wl = small_workload(manifest.workload(CELL))
    return harness.run(CELL, seed, 1.0, False, device="cpu", cfg=cfg, wl=wl)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_control_fails_the_limit_on_every_seed(name):
    cfg = small_config(manifest.config(name))
    limit = cfg["check"]["logit_gap"]
    for seed in (1, 2, 2**31 + 3):
        got = control.readings(cfg, seed, 8, torch.device("cpu"), 8)
        for name, numbers in got.items():
            assert numbers["correct"] is False, (seed, name, numbers)
            assert numbers["logit_gap"] > limit, (seed, name, numbers)


def test_a_sound_run_is_correct():
    out = _run(11)
    assert out["correct"] is True
    assert out["checks"]["logit_gap"]["value"] == 0.0
    assert out["checks"]["unanswered"]["value"] == 0
    assert list(out)[-1] == "checks"


def _altered(monkeypatch):
    """An answer altered where it is produced: the first frame's logits
    reversed in every batch the bound view executes."""
    from repro_torch.core import graphs
    execute = graphs.Binding.execute

    def broken(self, frames):
        out = execute(self, frames).clone()
        out[0] = out[0].flip(-1)
        return out
    monkeypatch.setattr(graphs.Binding, "execute", broken)


def _not_a_number(monkeypatch):
    """An answer that is not a number: the first frame's logits NaN in
    every batch the bound view executes."""
    from repro_torch.core import graphs
    execute = graphs.Binding.execute

    def broken(self, frames):
        out = execute(self, frames).clone()
        out[0] = float("nan")
        return out
    monkeypatch.setattr(graphs.Binding, "execute", broken)


def _half_left_out(monkeypatch):
    """Half of the batch left out: the second half of a batch's frames
    answered with the mean of the first half's answers."""
    from repro_torch.core.program import Executable
    run_padded = Executable.run_padded

    def broken(self, frames, bucket):
        out = np.array(np.asarray(run_padded(self, frames, bucket)))
        h = -(-len(out) // 2)
        out[h:] = out[:h].mean(axis=0)
        return out
    monkeypatch.setattr(Executable, "run_padded", broken)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: every batch after the
    first answered with the previous batch's output (a replay that never
    ran)."""
    from repro_torch.core import graphs
    execute = graphs.Binding.execute
    last = {}

    def broken(self, frames):
        out = execute(self, frames)
        prev = last.get(tuple(out.shape))
        last[tuple(out.shape)] = out
        return out if prev is None else prev
    monkeypatch.setattr(graphs.Binding, "execute", broken)


@pytest.mark.parametrize("plant", [_altered, _not_a_number, _half_left_out,
                                   _state_unchanged],
                         ids=["answer_altered", "answer_not_a_number",
                              "half_batch_left_out", "state_unchanged"])
def test_a_planted_fault_makes_the_run_incorrect(plant, monkeypatch):
    plant(monkeypatch)
    out = _run(12)
    assert out["correct"] is False
    gap = out["checks"]["logit_gap"]
    assert not gap["value"] <= gap["limit"]
