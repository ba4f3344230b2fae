"""repro_torch's LightatorDevice and the last of the reference's public API,
on the CPU, against the JAX reference.

One set of seeded numpy weights (``weights.params_from_numpy``) and frames
drive both packages' ``LightatorDevice``:

* the port's ``run_eager`` is bitwise equal to the port's ``run`` (logits,
  and reports equal field for field), its report equal to both of the
  reference's, and its logits bitwise equal to the reference's compiled
  ``run`` on its reference backend and to its ``run_eager`` wherever
  those two agree on this host; where they do not (XLA's host-dependent
  avg-pool order), to one of them, with the count of differing logits
  printed. Cases: LeNet under W4A4, W3A4 and MX_43, LeNet with a CA front
  end at 32x32, VGG9-CA at 32x32 and VGG16 at 32x32 with its full channel
  widths;
* ``run_eager`` launches none of the port's kernels; the two rejections
  (depthwise convs, ``UpsampleSpec``) raise the reference's messages;
* the deprecated shims: ``compile_model`` / ``execute`` bitwise equal to
  ``Program(...).compile(...).run``, ``compile_model(fc_batch=0)``
  raising, every deprecated name warning once, ``executor()`` cached;
  ``HostedProgram.queued_frames`` and the package's lazy ``obs``.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accelerator as jacc
from repro.core import plan as jplan
from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.models import vision as jvision
from repro.serve import server as jserver
from repro_torch import Options, Program
from repro_torch.core import accelerator as tacc
from repro_torch.core import optical_core as tocore
from repro_torch.core import plan as tplan
from repro_torch.core import power_model as tpmod
from repro_torch.core import quant as tquant
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import vision as tvision
from repro_torch.weights import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCHEMES = {"w4a4": (jquant.W4A4, tquant.W4A4),
           "w3a4": (jquant.W3A4, tquant.W3A4),
           "mx43": (jquant.MX_43, tquant.MX_43)}
# case -> (IR builder name, kwargs, frame HWC, scheme)
CASES = {
    "lenet-w4a4": ("lenet_ir", {}, (28, 28, 1), "w4a4"),
    "lenet-w3a4": ("lenet_ir", {}, (28, 28, 1), "w3a4"),
    "lenet-mx43": ("lenet_ir", {}, (28, 28, 1), "mx43"),
    "lenet_ca": ("lenet_ir", {"in_hw": 32, "use_ca": True}, (32, 32, 1),
                 "w4a4"),
    "vgg9_ca": ("vgg9_ir", {"in_hw": 32}, (32, 32, 3), "w4a4"),
    "vgg16_32": ("vgg16_ir", {"in_hw": 32}, (32, 32, 3), "w4a4"),
}


def numpy_params(layers, seed):
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


def frames(hwc, n=3, seed=1):
    f = np.random.default_rng(seed).random((n, *hwc)).astype(np.float32)
    f[1:2] *= 0.05          # a dim frame: per-tensor calibration couples it
    return f


def on_crc_grid(f):
    """``f`` with its largest pixel set to 15/16: the CRC's per-tensor
    scale is then 1/16, every dequantized intensity a multiple of it, and
    the CA's window sums exact in any order. XLA sums a 16-wide
    single-channel row pairwise (``test_torch_compressive``), where the
    port sums row-major, so with other frames the reference's CA is ulps
    from the port's at 32x32x1, and the reference's own eager and compiled
    runs of this model differ on some hosts."""
    f = np.minimum(f, np.float32(15 / 16))
    f.flat[0] = np.float32(15 / 16)
    return f


def _ir(case):
    builder, kw, hwc, scheme = CASES[case]
    return (getattr(jvision, builder)(**kw), getattr(tvision, builder)(**kw),
            hwc, scheme)


@pytest.fixture(scope="module")
def runs():
    """Per case: the port's run_eager and run (with the eager run's kernel
    launches), and the reference's run_eager and compiled run."""
    dev = tacc.LightatorDevice(device="cpu")
    jdev = jacc.LightatorDevice()
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for i, case in enumerate(CASES):
            jlayers, layers, hwc, scheme = _ir(case)
            js, ts = SCHEMES[scheme]
            p = numpy_params(layers, seed=i)
            f = frames(hwc, n=2 if case == "vgg16_32" else 3, seed=i + 1)
            if case == "lenet_ca":
                f = on_crc_grid(f)
            reset_launch_counts()
            eager = dev.run_eager(layers, p, f, ts)
            eager_launches = sum(launch_counts().values())
            jparams = jax.tree.map(jnp.asarray, p)
            with jdispatch.use_backend("reference"):
                jeager = jdev.run_eager(jlayers, jparams, jnp.asarray(f), js)
                jrun = jdev.run(jlayers, jparams, jnp.asarray(f), js)
            out[case] = {
                "eager": eager, "launches": eager_launches,
                "run": dev.run(layers, params_from_numpy(p, "cpu"),
                               torch.from_numpy(f), ts),
                "jeager": (np.asarray(jeager[0]), jeager[1]),
                "jrun": (np.asarray(jrun[0]), jrun[1])}
    return out


def _report(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("case", CASES)
def test_run_eager_bitwise_equal_to_run(runs, case):
    (le, re_), (lc, rc) = runs[case]["eager"], runs[case]["run"]
    assert le.dtype == torch.float32 and bool(torch.isfinite(le).all())
    assert torch.equal(le, lc)
    assert _report(re_) == _report(rc)


@pytest.mark.parametrize("case", CASES)
def test_run_eager_report_equals_the_reference(runs, case):
    _, rep = runs[case]["eager"]
    assert _report(rep) == _report(runs[case]["jrun"][1])
    assert _report(rep) == _report(runs[case]["jeager"][1])


@pytest.mark.parametrize("case", CASES)
def test_run_eager_logits_bitwise_equal_to_the_reference(runs, case, capsys):
    """Where the reference's run_eager equals its compiled run on this host,
    the port's run_eager equals both. Where the two differ, the reference
    disagrees with itself: its avg pool takes XLA's reduce order, which
    depends on the host and, compiled, on what XLA fuses into the reduce
    (``relu`` then ``mean(axis=(2, 4))``). The port sums each window
    row-major and divides once; it must then equal one of the two, and the
    count of logits the other differs in is printed."""
    got = runs[case]["eager"][0].numpy()
    jeager, jrun = runs[case]["jeager"][0], runs[case]["jrun"][0]
    if np.array_equal(jeager, jrun):
        np.testing.assert_array_equal(got, jrun)
        return
    held = "compiled" if np.array_equal(got, jrun) else "eager"
    other = jeager if held == "compiled" else jrun
    with capsys.disabled():
        print(f"\n{case}: the reference's run_eager and compiled run differ "
              f"in {int((jeager != jrun).sum())} of {jrun.size} logits on "
              f"this host; the port equals its {held} run (the other "
              f"differs from it in {int((got != other).sum())})")
    np.testing.assert_array_equal(got, jrun if held == "compiled" else jeager)


@pytest.mark.parametrize("case", CASES)
def test_run_eager_launches_no_kernel(runs, case):
    assert runs[case]["launches"] == 0


def test_rejections_carry_the_reference_messages():
    dev, jdev = tacc.LightatorDevice(device="cpu"), jacc.LightatorDevice()
    img = frames((8, 8, 3), n=1)
    cases = [
        ([tacc.ConvSpec("dw", 3, 3, depthwise=True)],
         [jacc.ConvSpec("dw", 3, 3, depthwise=True)], NotImplementedError),
        ([tacc.UpsampleSpec()], [jacc.UpsampleSpec()], TypeError)]
    for layers, jlayers, exc in cases:
        with pytest.raises(exc) as got:
            dev.run_eager(layers, {}, img, tquant.W4A4)
        with pytest.raises(exc) as want:
            jdev.run_eager(jlayers, {}, jnp.asarray(img), jquant.W4A4)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="depthwise convs run on "
                       "the compiled path only"):
        dev.run_eager(cases[0][0], {}, img, tquant.W4A4)
    with pytest.raises(TypeError, match="unknown layer IR"):
        dev.run_eager(cases[1][0], {}, img, tquant.W4A4)


def test_device_options_reach_the_plan_and_the_eager_report():
    """The constructor's strategy arguments (the reference's process-wide
    switches) shape both passes alike."""
    layers = tvision.lenet_ir()
    p = numpy_params(layers, seed=3)
    f = frames((28, 28, 1))
    dev = tacc.LightatorDevice(device="cpu", conv_strategy="strip")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        lc, rc = dev.run(layers, p, f, tquant.W4A4)
    le, re_ = dev.run_eager(layers, p, f, tquant.W4A4)
    assert {v["kind"] for v in re_.conv_strategy.values()} == {"strip"}
    assert re_.fused_segments == []
    assert torch.equal(le, lc) and _report(re_) == _report(rc)
    with pytest.raises(ValueError, match="conv strategy"):
        tacc.LightatorDevice(device="cpu", conv_strategy="tiled")


def test_compile_model_and_execute_equal_the_program_api():
    layers = tuple(tvision.lenet_ir())
    p = params_from_numpy(numpy_params(layers, seed=4), "cpu")
    f = torch.from_numpy(frames((28, 28, 1), n=4, seed=5))
    exe = Program(layers, p, (28, 28, 1)).compile(
        Options(scheme=tquant.W4A4, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        plan = tplan.compile_model(layers, f.shape, tquant.W4A4)
        positional = tplan.compile_model(
            layers, f.shape, tquant.W4A4, tocore.DEFAULT_OC,
            tpmod.DEFAULT_CIRCUIT, tpmod.LIGHTATOR_PROFILE, 512.0, 256.0, 1)
        assert plan is positional is exe.plan
        assert torch.equal(tplan.execute(plan, p, f), exe.run(f))
        with pytest.raises(ValueError, match="fc_batch"):
            tplan.compile_model(layers, f.shape, tquant.W4A4, fc_batch=0)


def test_executor_is_cached_per_key():
    layers = tuple(tvision.lenet_ir())
    p = params_from_numpy(numpy_params(layers, seed=6), "cpu")
    f = torch.from_numpy(frames((28, 28, 1), n=2, seed=7))
    plan = tplan._compile_model(layers, f.shape, tquant.W4A4)
    f1 = plan.executor()
    assert plan.executor() is f1
    assert plan.executor(per_frame=True) is plan.executor(per_frame=True)
    assert plan.executor(per_frame=True) is not f1
    assert torch.equal(f1(p, f), tplan._execute(plan, p, f))
    assert torch.equal(plan.executor(per_frame=True)(p, f),
                       tplan._execute(plan, p, f, per_frame=True))


def test_each_deprecated_name_warns_once(monkeypatch, capsys):
    monkeypatch.setattr(tplan, "_DEPRECATION_WARNED", set())
    layers = tuple(tvision.lenet_ir())
    p = numpy_params(layers, seed=8)
    f = frames((28, 28, 1), n=1)
    dev = tacc.LightatorDevice(device="cpu")
    tp = params_from_numpy(p, "cpu")
    argv = ["--smoke", "--batch", "1", "--prompt-len", "2", "--gen", "1",
            "--device", "cpu"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            plan = tplan.compile_model(layers, f.shape, tquant.W4A4)
            tplan.execute(plan, tp, torch.from_numpy(f))
            dev.run(layers, p, f, tquant.W4A4)
            toks = tserve.main(argv)
    names = [str(w.message).split(" is deprecated")[0] for w in caught
             if issubclass(w.category, DeprecationWarning)]
    assert sorted(names) == ["LightatorDevice.run", "core.plan.compile_model",
                             "core.plan.execute", "launch.serve.main"]
    assert tuple(toks.shape) == (1, 3)
    assert "[serve] arch=smollm-360m-smoke quant=none" in \
        capsys.readouterr().out


def test_serve_generate_is_greedy_generate(monkeypatch):
    from repro_torch.configs import smoke_variant
    monkeypatch.setattr(tplan, "_DEPRECATION_WARNED", set())
    cfg = dataclasses.replace(smoke_variant("smollm-360m"), quant_scheme="w4a4")
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 3))).to(torch.int32)
    with pytest.warns(DeprecationWarning, match="launch.serve.generate"):
        toks = tserve.generate(params, cfg, prompt, 2)
    assert torch.equal(toks, tlm.greedy_generate(params, cfg, prompt, 2))


def test_hosted_program_queued_frames():
    from repro_torch import serve
    server = serve.Server(serve.ServeConfig(device="cpu"))
    hosted = server.register("lenet", Program.from_model("lenet"),
                             Options(device="cpu"))
    jhosted = jserver.HostedProgram("lenet", None, None, (1,))
    assert hosted.queued_frames == jhosted.queued_frames == 0
    hosted.metrics.add_queued(5)
    jhosted.metrics.add_queued(5)
    assert hosted.queued_frames == jhosted.queued_frames == 5


def test_package_exports_obs_lazily():
    """``repro_torch.obs`` resolves on a bare ``import repro_torch``, as
    ``repro.obs`` does, without importing the rest of the package."""
    code = ("import sys, repro_torch\n"
            "print(repro_torch.obs.__name__, 'repro_torch.core.program' in "
            "sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["repro_torch.obs", "False"]
    import repro_torch
    with pytest.raises(AttributeError, match="not_a_name"):
        getattr(repro_torch, "not_a_name")


def test_eager_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tacc.LightatorDevice()
