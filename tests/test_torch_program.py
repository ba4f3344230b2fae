"""repro_torch Program / Executable on the CPU against the JAX reference.

LeNet and VGG9-CA, under W4A4 and MX_43, with one set of numpy weights
(random non-zero biases included) handed to both packages: the port's
``run`` and ``run_per_frame`` — through the kernel wrappers' CPU path and
through the reference backend — are bitwise equal to the reference
package's ``Executable.run`` / ``run_per_frame`` on its reference backend.
Plans (steps, conv strategies, fused segments) and power reports are
equal too, apart from ``report.verification``: the port has no plan
verifier yet.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import quant as jquant
from repro.models import vision as jvision
from repro_torch import Options, Program
from repro_torch.core import quant as tquant
from repro_torch.core.plan import ConvStep, padtype_to_pads
from repro_torch.kernels import dispatch
from repro_torch.models import vision as tvision
from repro_torch.weights import params_from_numpy

SCHEMES = {"w4a4": (jquant.W4A4, tquant.W4A4),
           "mx43": (jquant.MX_43, tquant.MX_43)}
MODELS = ("lenet", "vgg9")


def numpy_params(name, seed=0):
    """N(0, 1/fan_in) weights and non-zero biases, as the reference's
    initializer shapes them."""
    rng = np.random.default_rng(seed)
    params = {}
    for layer in jvision.VISION_MODELS[name]():
        if hasattr(layer, "kernel"):
            shape = (layer.kernel, layer.kernel, layer.c_in, layer.c_out)
            fan_in, n = layer.kernel ** 2 * layer.c_in, layer.c_out
        elif hasattr(layer, "fan_in"):
            shape, fan_in, n = (layer.fan_in, layer.fan_out), layer.fan_in, \
                layer.fan_out
        else:
            continue
        params[layer.name] = {
            "w": (rng.standard_normal(shape) / math.sqrt(fan_in))
            .astype(np.float32),
            "b": (rng.standard_normal(n) * 0.05).astype(np.float32)}
    return params


def frames(name, n=3, seed=1):
    rng = np.random.default_rng(seed)
    f = rng.random((n, *jvision.MODEL_INPUT_HWC[name])).astype(np.float32)
    f[1] *= 0.05            # a dim frame: per-tensor calibration couples it
    return f


@pytest.fixture(scope="module")
def pair():
    """(jax Program, port Program) per model, on the same weights."""
    out = {}
    for i, name in enumerate(MODELS):
        p = numpy_params(name, seed=i)
        out[name] = (
            jvision.vision_program(name, params=jax.tree.map(jnp.asarray, p)),
            tvision.vision_program(name, params=params_from_numpy(p, "cpu")))
    return out


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """The reference's outputs, computed once per (model, scheme)."""
    out = {}
    for name in MODELS:
        jprog, _ = pair[name]
        f = frames(name)
        for key, (js, _) in SCHEMES.items():
            exe = jprog.compile(repro.Options(scheme=js, backend="reference"))
            out[name, key] = (np.asarray(exe.run(f)),
                              np.asarray(exe.run_per_frame(f)), exe)
    return out


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("name", MODELS)
def test_run_and_run_per_frame_bitwise_equal_to_reference(
        pair, jax_outputs, name, scheme, backend):
    _, tprog = pair[name]
    exe = tprog.compile(Options(scheme=SCHEMES[scheme][1], device="cpu",
                                backend=backend))
    want_run, want_pf, _ = jax_outputs[name, scheme]
    f = frames(name)
    np.testing.assert_array_equal(exe.run(f).numpy(), want_run)
    np.testing.assert_array_equal(exe.run_per_frame(f).numpy(), want_pf)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("name", MODELS)
def test_plans_and_reports_equal_reference(pair, jax_outputs, name, scheme):
    _, tprog = pair[name]
    exe = tprog.compile(Options(scheme=SCHEMES[scheme][1], device="cpu"))
    jexe = jax_outputs[name, scheme][2]
    assert [type(s).__name__ for s in exe.plan.steps] == \
        [type(s).__name__ for s in jexe.plan.steps]
    assert [dataclasses.asdict(s) for s in exe.plan.steps] == \
        [dataclasses.asdict(s) for s in jexe.plan.steps]
    assert [dataclasses.asdict(s) for s in exe.plan.fused_segments] == \
        [dataclasses.asdict(s) for s in jexe.plan.fused_segments]
    mine, theirs = (dataclasses.asdict(exe.report),
                    dataclasses.asdict(jexe.report))
    assert mine.pop("verification") == []
    theirs.pop("verification")
    assert mine == theirs
    assert exe.plan.out_features == jexe.plan.out_features


def test_lenet_fuses_its_conv_pair_and_vgg9_fuses_nothing(pair):
    lenet = pair["lenet"][1].compile(Options(device="cpu")).plan
    vgg9 = pair["vgg9"][1].compile(Options(device="cpu")).plan
    assert [s.names for s in lenet.fused_segments] == [("conv1", "conv2")]
    assert lenet.fused_segments[0].vmem_bytes == 23512
    assert vgg9.fused_segments == ()
    assert all(s.strategy.kind == "resident" for s in vgg9.steps
               if isinstance(s, ConvStep))


@pytest.mark.parametrize("name", MODELS)
def test_run_padded_equals_batch1_runs(pair, name):
    _, tprog = pair[name]
    exe = tprog.compile(Options(device="cpu"))
    f = frames(name, n=5, seed=4)
    singles = torch.cat([exe.run_per_frame(f[i:i + 1]) for i in range(5)])
    for bucket in (2, 8):
        assert torch.equal(exe.run_padded(f, bucket), singles)
    # per-tensor calibration couples batch neighbours; per-frame does not
    assert not torch.equal(exe.run(f), singles)
    assert torch.equal(exe.run(f[:1]), singles[:1])


def test_forced_strip_runs_plain_accumulate_on_cpu(pair):
    """A forced strip strategy runs the strip kernels' plain versions on the
    CPU and still equals the reference."""
    jprog, tprog = pair["lenet"]
    f = frames("lenet")
    jexe = jprog.compile(repro.Options(scheme=jquant.W4A4,
                                       backend="reference",
                                       conv_strategy="strip"))
    exe = tprog.compile(Options(device="cpu", conv_strategy="strip"))
    assert all(s.strategy.kind == "strip" for s in exe.plan.steps
               if isinstance(s, ConvStep))
    np.testing.assert_array_equal(exe.run(f).numpy(), np.asarray(jexe.run(f)))


def test_unported_pieces_raise(monkeypatch):
    from repro_torch import serve
    # the multi-device pool is ported: devices beyond the local CUDA count
    # raise ValueError at start (one card faked; nothing touches it)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    server = serve.Server(serve.ServeConfig(device="cuda", devices=2))
    server.register("lenet", Program.from_model("lenet"),
                    Options(device="cpu"))
    with pytest.raises(ValueError, match="local CUDA device"):
        server.start()
    with pytest.raises(ValueError, match="backend"):
        Options(device="cpu", backend="pallas")


def test_padtype_to_pads_matches_lax():
    for hw, k, s in (((28, 28), 5, 1), ((15, 16), 3, 2), ((10, 7), 2, 1),
                     ((8, 8), 4, 4)):
        for padding in ("SAME", "VALID"):
            want = jax.lax.padtype_to_pads(hw, (k, k), (s, s), padding)
            assert padtype_to_pads(hw, k, s, padding) == \
                tuple((int(a), int(b)) for a, b in want)


def test_strategy_selection_matches_reference():
    from repro.kernels import dispatch as jdispatch
    for args in ((16, 16, 1, 64, 3), (224, 224, 64, 64, 3), (8, 8, 3, 3, 5),
                 (64, 64, 3, 3, 3, 1, 3)):
        for mode in dispatch.CONV_STRATEGIES:
            assert dataclasses.asdict(dispatch.select_conv_strategy(
                *args, mode=mode)) == dataclasses.asdict(
                jdispatch.select_conv_strategy(
                    *args, mode=mode, budget=jdispatch.DEFAULT_CONV_VMEM_BUDGET))
