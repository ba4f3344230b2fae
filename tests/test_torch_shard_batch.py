"""repro_torch's ``Options(shard_batch=, mesh=)`` on the CPU, against the
unsharded run and the reference backend of ``repro``.

``mesh=("cpu", "cpu")`` emulates two shards (as ``ServeConfig(devices=N)``
emulates workers): ``Executable.run`` (per-tensor calibration) splits the
batch on axis 0, runs the shards in lockstep, and each CRC requant takes
the max across shards, so LeNet, VGG9-CA and an imaging pipeline are
bitwise the unsharded run and the reference's ``Executable.run`` (a dim
frame in the batch makes the batch-wide max matter), the reference run op
by op (``jax.disable_jit``): jitted, XLA's simplifier moves one of
LeNet's logits here by an ulp against both (ROADMAP Queue 3). The no-op
cases: one device, a batch the devices do not divide,
``shard_batch=False``, and ``run_per_frame``. A shard that raises fails
the call; eight shard threads under a microsecond switch interval stay
bitwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
from repro.core import quant as jquant
from repro.models import vision as jvision
from repro_torch import Options, Program
from repro_torch.core import plan as plan_mod
from repro_torch.core import quant as tquant
from repro_torch.models import vision as tvision
from repro_torch.weights import params_from_numpy
from test_torch_program import numpy_params

CPU = Options(scheme=tquant.W4A4, device="cpu")
SHARDED = dataclasses.replace(CPU, shard_batch=True, mesh=("cpu", "cpu"))
REFERENCE = repro.Options(scheme=jquant.W4A4, backend="reference")


def _frames(hwc, n=4, seed=1):
    f = np.random.default_rng(seed).random((n, *hwc)).astype(np.float32)
    f[1] *= 0.05
    return f


def _programs(name):
    if name in ("lenet", "vgg9"):
        p = numpy_params(name, seed=3)
        return (tvision.vision_program(name, params=params_from_numpy(
                    p, "cpu")),
                jvision.vision_program(name,
                                       params=jax.tree.map(jnp.asarray, p)))
    return (Program.from_pipeline(name, 32, 32, 3),
            repro.Program.from_pipeline(name, 32, 32, 3))


@pytest.fixture
def batches(monkeypatch):
    """The batch sizes ``plan._execute`` runs, per call."""
    seen = []
    real = plan_mod._execute

    def spy(plan, params, frames, *a, **k):
        seen.append(int(frames.shape[0]))
        return real(plan, params, frames, *a, **k)
    monkeypatch.setattr(plan_mod, "_execute", spy)
    return seen


@pytest.mark.parametrize("name", ["lenet", "vgg9", "edge_detect"])
def test_sharded_run_is_bitwise_the_unsharded_and_the_reference(name,
                                                                 batches):
    prog, jprog = _programs(name)
    f = _frames(prog.input_hwc)
    with jax.disable_jit():
        want = np.asarray(jprog.compile(REFERENCE).run(f))
    base = prog.compile(CPU).run(f)
    assert batches == [4]
    got = prog.compile(SHARDED).run(f)
    assert batches == [4, 2, 2]              # two shards of two frames
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    ref_backend = prog.compile(dataclasses.replace(
        SHARDED, backend="reference")).run(f)
    np.testing.assert_array_equal(ref_backend.numpy(), want)


@pytest.mark.parametrize("options,n", [
    (dataclasses.replace(CPU, shard_batch=True, mesh=("cpu",)), 4),
    (dataclasses.replace(CPU, shard_batch=True,
                         mesh=("cpu", "cpu", "cpu")), 4),
    (dataclasses.replace(CPU, shard_batch=True), 4),   # no CUDA devices
    (dataclasses.replace(CPU, mesh=("cpu", "cpu")), 4),
])
def test_shard_batch_is_a_no_op_where_it_cannot_split(options, n, batches):
    prog, _ = _programs("lenet")
    f = _frames(prog.input_hwc, n=n)
    got = prog.compile(options).run(f)
    assert batches == [n]
    np.testing.assert_array_equal(got.numpy(),
                                  prog.compile(CPU).run(f).numpy())


def test_run_per_frame_ignores_shard_batch(batches):
    prog, _ = _programs("lenet")
    f = _frames(prog.input_hwc)
    got = prog.compile(SHARDED).run_per_frame(f)
    assert batches == [4]
    np.testing.assert_array_equal(
        got.numpy(), prog.compile(CPU).run_per_frame(f).numpy())


def test_options_name_the_shards():
    assert [d.type for d in SHARDED.shard_devices()] == ["cpu", "cpu"]
    assert SHARDED.mesh == ("cpu", "cpu")
    assert "shard_batch=2dev" in SHARDED.describe()
    assert CPU.shard_devices() == ()
    assert "shard_batch" not in CPU.describe()


def test_a_failing_shard_fails_the_call(monkeypatch):
    prog, _ = _programs("lenet")
    exe = prog.compile(SHARDED)
    real = plan_mod._execute
    calls = []

    def flaky(plan, params, frames, *a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("shard fails")
        return real(plan, params, frames, *a, **k)
    monkeypatch.setattr(plan_mod, "_execute", flaky)
    with pytest.raises(ValueError, match="shard fails"):
        exe.run(_frames(prog.input_hwc))


def test_many_shards_meet_under_a_short_switch_interval():
    """Eight shard threads (as many as this host's cores, or more) meet at
    every requant's hub with the interpreter switching threads every
    microsecond: each of five runs is bitwise the unsharded run (a hub
    that mixed two requants' maxima would move a scale)."""
    import sys
    prog, _ = _programs("lenet")
    f = _frames(prog.input_hwc, n=16)
    want = prog.compile(CPU).run(f).numpy()
    exe = prog.compile(dataclasses.replace(CPU, shard_batch=True,
                                           mesh=("cpu",) * 8))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(exe.run(f).numpy(), want)
    finally:
        sys.setswitchinterval(old)


def test_each_shard_thread_enters_its_shard_s_device(monkeypatch):
    """Every shard's thread runs under ``_on_device`` of its own shard's
    device (on CUDA a new thread starts on device 0)."""
    from repro_torch.core import program as program_mod
    entered = []
    real = program_mod._on_device

    def spy(device):
        entered.append(device)
        return real(device)
    monkeypatch.setattr(program_mod, "_on_device", spy)
    prog, _ = _programs("lenet")
    prog.compile(SHARDED).run(_frames(prog.input_hwc))
    assert sorted(map(str, entered)) == ["cpu", "cpu"]

