"""VGG16 through repro_torch on the CPU, against the JAX reference.

* VGG16 with its full channel widths at a 32x32x3 input (``vgg16_ir(
  in_hw=32)``), one set of seeded numpy weights carried to both packages
  (``params_from_numpy``), W4A4 and MX_43, 2 frames: the port's
  ``run_per_frame`` (the kernel wrappers' CPU path) is bitwise equal to
  the reference backend's, under the default budget (every conv
  resident at this size) and under a small ``conv_vmem_budget`` that
  sends every conv down the strip route on both sides;
* the plans (steps, strategies, fused segments) and power reports equal
  the reference's, at 224x224x3 and at 32x32x3;
* ``kernels/edge_shapes.py``'s ``VGG16_SHAPES`` are the distinct shapes of
  the 224x224x3 plan's kernel calls;
* ``serve_vision`` offers the reference's ``--model`` choices and its
  ``--scheme`` / ``--size`` defaults (its parser read without running it).
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
from repro.core import quant as jquant
from repro.models import vision as jvision
from repro_torch import Options, Program
from repro_torch.core import quant as tquant
from repro_torch.core.plan import ConvStep, DenseStep
from repro_torch.kernels.edge_shapes import VGG16_SHAPES
from repro_torch.models import vision as tvision
from repro_torch.weights import params_from_numpy

SCHEMES = {"w4a4": (jquant.W4A4, tquant.W4A4),
           "mx43": (jquant.MX_43, tquant.MX_43)}
SMALL_HW = 32
STRIP_BUDGET = 32 << 10            # under every conv's im2col at 32x32


def numpy_params(layers, seed=2):
    """N(0, 1/fan_in) weights and non-zero biases for ``layers``."""
    rng = np.random.default_rng(seed)
    params = {}
    for layer in layers:
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


@pytest.fixture(scope="module")
def small_pair():
    """(jax Program, port Program) of VGG16 at 32x32x3, same weights."""
    p = numpy_params(jvision.vgg16_ir(in_hw=SMALL_HW))
    hwc = (SMALL_HW, SMALL_HW, 3)
    return (repro.Program(tuple(jvision.vgg16_ir(in_hw=SMALL_HW)),
                          jax.tree.map(jnp.asarray, p), hwc, name="vgg16"),
            Program(tuple(tvision.vgg16_ir(in_hw=SMALL_HW)),
                    params_from_numpy(p, "cpu"), hwc, name="vgg16"))


def _frames(n=2, seed=5):
    f = np.random.default_rng(seed).random(
        (n, SMALL_HW, SMALL_HW, 3)).astype(np.float32)
    f[1] *= 0.1                         # a dim frame: calibration matters
    return f


def _strategies(plan):
    """The conv steps' strategies (either package's plan)."""
    return [s.strategy.kind for s in plan.steps
            if type(s).__name__ == "ConvStep"]


@pytest.mark.parametrize("budget", [None, STRIP_BUDGET],
                         ids=["default_budget", "all_strip"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_run_per_frame_bitwise_equal_to_reference(small_pair, scheme,
                                                  budget):
    jprog, prog = small_pair
    js, ts = SCHEMES[scheme]
    exe = prog.compile(Options(scheme=ts, device="cpu",
                               conv_vmem_budget=budget, verify="on"))
    jexe = jprog.compile(repro.Options(scheme=js, backend="reference",
                                       conv_vmem_budget=budget))
    want = ["resident" if budget is None else "strip"] * 13
    assert _strategies(exe.plan) == _strategies(jexe.plan) == want
    assert exe.report.verification == jexe.report.verification == []
    f = _frames()
    got = exe.run_per_frame(f).numpy()
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, np.asarray(jexe.run_per_frame(f)))


@pytest.mark.parametrize("hw,budget", [(224, None), (SMALL_HW, None),
                                       (SMALL_HW, STRIP_BUDGET)])
def test_plans_and_reports_equal_reference(hw, budget):
    layers = tvision.vgg16_ir(in_hw=hw)
    exe = Program(layers, {}, (hw, hw, 3), name="vgg16").compile(
        Options(device="cpu", conv_vmem_budget=budget))
    jexe = repro.Program(jvision.vgg16_ir(in_hw=hw), {}, (hw, hw, 3),
                         name="vgg16").compile(repro.Options(
                             scheme=jquant.W4A4, backend="reference",
                             conv_vmem_budget=budget))
    assert [type(s).__name__ for s in exe.plan.steps] == \
        [type(s).__name__ for s in jexe.plan.steps]
    assert [dataclasses.asdict(s) for s in exe.plan.steps] == \
        [dataclasses.asdict(s) for s in jexe.plan.steps]
    assert exe.plan.fused_segments == () == jexe.plan.fused_segments
    assert dataclasses.asdict(exe.report) == dataclasses.asdict(jexe.report)
    if hw == 224:
        # the reference pins this split (test_conv_strategy.py)
        assert _strategies(exe.plan) == ["strip"] * 10 + ["resident"] * 3


def test_vgg16_shapes_are_the_plans():
    """``VGG16_SHAPES`` lists every distinct kernel call of the 224x224x3
    plan, by the layers that make it, in plan order."""
    plan = tvision.vision_program("vgg16", params={}).compile(
        Options(device="cpu")).plan
    strip, mvm = {}, {}
    for s in plan.steps:
        if isinstance(s, ConvStep) and s.strategy.kind == "strip":
            g, st = s.geom, s.strategy
            key = (st.n_strips * st.strip_rows, st.strip_rows,
                   g.conv_hw()[1], g.c_in, g.c_out, g.kernel, g.stride)
            strip.setdefault(key, []).append(s.name)
        elif isinstance(s, ConvStep):
            g = s.geom
            h, w = g.conv_hw()
            key = (h * w, g.kernel * g.kernel * g.c_in, g.c_out)
            mvm.setdefault(key, []).append(s.name)
    fan_in = 512 * 7 * 7
    for s in plan.steps:
        if isinstance(s, DenseStep):
            layer = next(l for l in plan.layers
                         if getattr(l, "name", None) == s.name)
            assert layer.fan_in == fan_in
            mvm.setdefault((1, fan_in, layer.fan_out), []).append(s.name)
            fan_in = layer.fan_out
    assert VGG16_SHAPES["conv_strip"] == [
        ("+".join(names), *key) for key, names in strip.items()]
    assert VGG16_SHAPES["photonic_mvm"] == [
        ("+".join(names), *key) for key, names in mvm.items()]


def _parser(main):
    """The ArgumentParser ``main`` builds, caught as it parses (nothing
    after the parse runs)."""
    class Caught(Exception):
        pass

    def catch(self, *args, **kw):
        raise Caught(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        main([])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("main never parsed its arguments")


def test_serve_vision_parser_matches_reference():
    from repro.launch import serve_vision as jserve
    from repro_torch.launch import serve_vision
    mine, theirs = (_parser(m.main) for m in (serve_vision, jserve))

    def action(parser, flag):
        return next(a for a in parser._actions if flag in a.option_strings)

    for flag in ("--model", "--scheme", "--size", "--batch", "--batches"):
        a, b = action(mine, flag), action(theirs, flag)
        assert a.default == b.default, flag
        assert list(a.choices or ()) == list(b.choices or ()), flag
    assert list(action(mine, "--model").choices) == \
        ["lenet", "vgg16", "vgg9"]
    assert action(mine, "--scheme").default == "mx43"
    assert action(mine, "--size").default == 64


def test_serve_vision_serves_vgg16_on_the_cpu(capsys):
    """``serve_vision`` serves VGG16 at 224x224x3 (seeded weights, the default
    MX_43) through ``serve.Server`` on the CPU, asked for explicitly."""
    from repro_torch.launch import serve_vision
    fps = serve_vision.main(["--device", "cpu", "--model", "vgg16",
                             "--batch", "1", "--batches", "2"])
    printed = capsys.readouterr().out
    assert fps > 0
    assert "model=vgg16" in printed and "scheme=MX [4:4][3:4]" in printed
    assert "conv10=strip(2x24rows) conv11=resident" in printed
