"""``Program.then`` and ``infer_output_hwc`` of repro_torch on the CPU,
against the JAX reference.

* ``infer_output_hwc`` equals the reference's, and the shapes the compiled
  plans produce, for LeNet, VGG9, VGG16 and four pipelines;
* ``then`` refuses a shape mismatch, suffixes colliding layer names in the
  IR and the params as the reference does, and compiles one plan;
* the reference's acceptance chain, denoise_gauss -> edge_detect ->
  sharpen at 32x32x3, is bitwise equal to the reference chain's
  ``run_per_frame`` (reference backend), with the same plan steps and
  fused segments, and its bound CPU view equals it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro
from repro.core import quant as jquant
from repro.core.program import infer_output_hwc as jax_infer
from repro.models.vision import vision_program as jax_vision_program
from repro_torch import Options, Program
from repro_torch.core import plan as plan_mod
from repro_torch.core import quant as tquant
from repro_torch.core.program import infer_output_hwc
from repro_torch.models.vision import vision_program

CPU = Options(scheme=tquant.W4A4, device="cpu")
REFERENCE = repro.Options(scheme=jquant.W4A4, backend="reference")
CHAIN = (("denoise_gauss", 3), ("edge_detect", 3), ("sharpen", 1))


def _frames(hw, n=3, seed=0, c=3):
    f = np.random.default_rng(seed).random((n, hw, hw, c)).astype(np.float32)
    f[1] *= 0.05
    return f


def _chain(make, hw):
    first, second, third = (make(n, hw, hw, c) for n, c in CHAIN)
    return first.then(second).then(third)


@pytest.mark.parametrize("model", ["lenet", "vgg9", "vgg16"])
def test_infer_output_hwc_of_models(model):
    prog = vision_program(model, params={})
    jprog = jax_vision_program(model, params={})
    got = infer_output_hwc(prog.layers, prog.input_hwc)
    assert got == jax_infer(jprog.layers, jprog.input_hwc)
    plan = prog.compile(CPU).plan
    assert got == (1, 1, plan.out_features)
    assert prog.output_hwc == got


@pytest.mark.parametrize("name", ["edge_detect", "denoise_box",
                                  "compress_recon", "sharpen"])
def test_infer_output_hwc_of_pipelines(name):
    prog = Program.from_pipeline(name, 32, 32, 3)
    jprog = repro.Program.from_pipeline(name, 32, 32, 3)
    got = infer_output_hwc(prog.layers, prog.input_hwc)
    assert got == jax_infer(jprog.layers, jprog.input_hwc)
    out = prog.compile(CPU).run_per_frame(_frames(32))
    assert tuple(out.shape[1:]) == got


def test_then_rejects_a_shape_mismatch():
    den = Program.from_pipeline("denoise_box", 32, 32, 3)
    edge16 = Program.from_pipeline("edge_detect", 16, 16, 3)
    with pytest.raises(ValueError, match="cannot chain"):
        den.then(edge16)
    with pytest.raises(ValueError, match="cannot chain"):
        vision_program("lenet", params={}).then(den)


def test_then_renames_collisions_in_ir_and_params():
    e3 = Program.from_pipeline("edge_detect", 32, 32, 3)
    e1 = Program.from_pipeline("edge_detect", 32, 32, 1)
    twice = e3.then(e1).then(e1)
    jtwice = (repro.Program.from_pipeline("edge_detect", 32, 32, 3)
              .then(repro.Program.from_pipeline("edge_detect", 32, 32, 1))
              .then(repro.Program.from_pipeline("edge_detect", 32, 32, 1)))
    names = [l.name for l in twice.layers if hasattr(l, "name")]
    assert names == ["grad", "edge_mag", "grad.2", "edge_mag.2", "grad.3",
                     "edge_mag.3"]
    assert names == [l.name for l in jtwice.layers if hasattr(l, "name")]
    assert sorted(twice.params) == sorted(jtwice.params)
    for k in twice.params:
        np.testing.assert_array_equal(twice.params[k]["w"].numpy(),
                                      np.asarray(jtwice.params[k]["w"]))
    assert twice.name == "edge_detect>edge_detect>edge_detect"
    assert twice.then(e1, name="x").name == "x"


def test_then_compiles_one_plan():
    chain = _chain(Program.from_pipeline, 32)
    jchain = _chain(repro.Program.from_pipeline, 32)
    exe = chain.compile(CPU)
    jexe = jchain.compile(REFERENCE)
    assert isinstance(exe.plan, plan_mod.CompiledPlan)
    assert len(exe.plan.schedules) == len(jexe.plan.schedules)
    assert exe.report.fps == pytest.approx(jexe.report.fps, rel=1e-12)
    assert exe.plan.frame_shape == (32, 32, 3)


@pytest.fixture(scope="module")
def chain_case():
    f = _frames(32, n=4, seed=7)
    jexe = _chain(repro.Program.from_pipeline, 32).compile(REFERENCE)
    return f, jexe, np.asarray(jexe.run_per_frame(f))


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_acceptance_chain_bitwise_equal_to_reference(chain_case, backend):
    f, jexe, want = chain_case
    exe = _chain(Program.from_pipeline, 32).compile(
        dataclasses.replace(CPU, backend=backend))
    assert [dataclasses.asdict(s) for s in exe.plan.steps] == \
        [dataclasses.asdict(s) for s in jexe.plan.steps]
    assert [dataclasses.asdict(s) for s in exe.plan.fused_segments] == \
        [dataclasses.asdict(s) for s in jexe.plan.fused_segments]
    assert len(exe.plan.fused_segments) == 1
    np.testing.assert_array_equal(exe.run_per_frame(f).numpy(), want)


def test_acceptance_chain_bound_view_bitwise_equal_to_reference(chain_case):
    f, _, want = chain_case
    bound = _chain(Program.from_pipeline, 32).compile(CPU).bind("cpu")
    np.testing.assert_array_equal(np.asarray(bound.run_padded(f, 8)), want)
    np.testing.assert_array_equal(bound.run_per_frame(f).numpy(), want)


def test_chain_at_256_fuses_less_than_the_reference():
    """The port fuses a run only while it fits one CTA's shared memory: at
    256x256 the chain's grad -> edge_mag -> sharpen run does not (the
    reference fuses it), and the steps are otherwise the same."""
    exe = _chain(Program.from_pipeline, 256).compile(CPU)
    jexe = _chain(repro.Program.from_pipeline, 256).compile(REFERENCE)
    assert [s.names for s in jexe.plan.fused_segments] == \
        [("grad", "edge_mag", "sharpen")]
    assert exe.plan.fused_segments == ()
    assert [dataclasses.asdict(s) for s in exe.plan.steps] == \
        [dataclasses.asdict(s) for s in jexe.plan.steps]


def test_graph_capture_holds_off_garbage_collection():
    """A bound view captures with automatic collection off (a collection
    inside a capture could destroy another view's graphs in the capturing
    thread and invalidate it); overlapping holds on two threads turn it
    back on only when the last ends, and only if it was on."""
    import gc
    import threading
    from repro_torch.core import graphs
    assert gc.isenabled()
    entered, release = threading.Event(), threading.Event()

    def other():
        with graphs._no_collection():
            entered.set()
            release.wait(10)

    t = threading.Thread(target=other)
    with graphs._no_collection():
        assert not gc.isenabled()
        t.start()
        assert entered.wait(10)
    assert not gc.isenabled()          # the other thread still captures
    release.set()
    t.join(10)
    assert not t.is_alive() and gc.isenabled()
    gc.disable()
    try:
        with graphs._no_collection():
            pass
        assert not gc.isenabled()      # off before, off after
    finally:
        gc.enable()
