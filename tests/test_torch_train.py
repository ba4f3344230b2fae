"""repro_torch's training slice on the CPU against the JAX reference.

The same numpy weights and procedural data, made from a seed, go through
both packages:

* ``apply_vision``: the QAT loss and its gradients for LeNet W4A4 and a
  narrow VGG9-CA-shaped IR at batch 8;
* 20 LeNet QAT steps in both: each loss falls, the test accuracies agree
  within 0.05;
* ``fit_recon_head``: the head after 5 SGD steps, and the PSNR gain of the
  full schedule within 0.1 dB of the reference's;
* deployment: the port's trained weights through ``params_to_numpy`` into
  the reference's ``run_per_frame`` on its reference backend, bitwise
  equal to the port's ``run_per_frame``;
* the trainer (``launch/train_vision.py``): its CLI and the accuracy
  trend's CSV lines under ``bench_accuracy``'s names.

Each tolerance is stated where it is used, with its reason.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import accelerator as jacc
from repro.core import quant as jq
from repro.imaging import (PIPELINES as JPIPELINES, apply_float as japply,
                           fit_recon_head as jfit, gray_target as jgray,
                           psnr as jpsnr)
from repro.kernels.photonic_mvm import ref as jref
from repro.models import vision as jvision
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro_torch import Options, Program
from repro_torch.core import accelerator as tacc
from repro_torch.core import quant as tq
from repro_torch.data.synthetic import synthetic_digits, synthetic_textures
from repro_torch.imaging import (PIPELINES as TPIPELINES,
                                 apply_float as tapply,
                                 fit_recon_head as tfit,
                                 gray_target as tgray, psnr as tpsnr)
from repro_torch.kernels.conv_bank.ref import float32_convs
from repro_torch.launch import train_vision as tv
from repro_torch.models import vision as tvision
from repro_torch.nn import layers as TL
from repro_torch.weights import params_from_numpy, params_to_numpy


def numpy_params(layers, seed):
    """N(0, 1/fan_in) weights and small non-zero biases for any IR."""
    rng = np.random.default_rng(seed)
    params = {}
    for layer in layers:
        if hasattr(layer, "kernel"):
            shape = (layer.kernel, layer.kernel, layer.c_in, layer.c_out)
            fan_in, n = layer.kernel ** 2 * layer.c_in, layer.c_out
        elif hasattr(layer, "fan_in"):
            shape, fan_in, n = (layer.fan_in, layer.fan_out), \
                layer.fan_in, layer.fan_out
        else:
            continue
        params[layer.name] = {
            "w": (rng.standard_normal(shape) / math.sqrt(fan_in))
            .astype(np.float32),
            "b": (rng.standard_normal(n) * 0.05).astype(np.float32)}
    return params


def narrow_vgg9(acc):
    """VGG9-CA's shape (CA 32->16 gray, six 3x3 convs with a max pool after
    every second, three dense layers) at 8-16 channels, in ``acc``'s IR."""
    layers = [acc.CASpec(pool=2, rgb_to_gray=True)]
    for i, (ci, co) in enumerate([(1, 8), (8, 8), (8, 16), (16, 16),
                                  (16, 16), (16, 16)]):
        layers.append(acc.ConvSpec(f"conv{i + 1}", ci, co, kernel=3,
                                   pool=("max", 2) if i % 2 else None))
    return layers + [acc.FlattenSpec(), acc.DenseSpec("fc1", 64, 32),
                     acc.DenseSpec("fc2", 32, 32),
                     acc.DenseSpec("fc3", 32, 10, act="none")]


MODELS = {"lenet": (jvision.lenet_ir, tvision.lenet_ir, (28, 28, 1)),
          "narrow_vgg9": (lambda: narrow_vgg9(jacc),
                          lambda: narrow_vgg9(tacc), (32, 32, 3))}


def _jax_loss(layers, xb, yb, scheme, aux=False):
    """The reference example's step loss (with ``aux``, also the logits)."""
    def loss_fn(p):
        logits = jvision.apply_vision(p, layers, xb, scheme)
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, yb[:, None], -1)[:, 0]
        loss = jnp.mean(logz - gold)
        return (loss, logits) if aux else loss
    return loss_fn


def _reference_value_and_grad(loss_fn, params):
    """``value_and_grad(loss_fn, has_aux=True)(params)``, compiled with
    XLA's algebraic simplifier off.

    Eagerly the reference divides by the 1/15 CRC step, as the port does;
    under a plain ``jit`` the simplifier turns that division by a constant
    into a reciprocal multiply, an ulp off for many quotients, and through
    a deep enough net some code then steps (the reference's jitted
    gradients of the narrow VGG9's conv1-conv4 then differ from its own
    eager ones far beyond the float sums' order). With the pass off the
    compiled gradients stay within the float sums' order of the eager
    ones, at a fraction of the eager run's compile time (every op of an
    eager run compiles on its own).
    """
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return fn.lower(params).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(params)


# -- apply_vision -------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
def test_apply_vision_loss_and_grads_against_jax(model):
    """Same weights, same 8 frames, W4A4. The reference's fake-quant steps
    are bitwise to the port's (``test_torch_qat.py``); the float convs and
    matmuls between them sum in another order, an ulp here and there,
    which the next CRC step rounds away unless a code lies within an ulp
    of a tie. So: the logits within 1e-5 of their largest, the loss within
    1e-6 relative, each gradient within 2e-5 of its largest entry (the
    backward's sums compound the forward's). The reference runs through
    :func:`_reference_value_and_grad`."""
    jl_fn, tl_fn, hwc = MODELS[model]
    jlayers, tlayers = jl_fn(), tl_fn()
    p = numpy_params(jlayers, seed=3)
    rng = np.random.default_rng(4)
    x = rng.random((8, *hwc)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    (jloss, jlogits), jgrads = _reference_value_and_grad(_jax_loss(
        jlayers, jnp.asarray(x), jnp.asarray(y), jq.W4A4, aux=True), jp)
    jlogits = np.asarray(jlogits)

    tp = {k: {kk: torch.from_numpy(v.copy()).requires_grad_()
              for kk, v in d.items()} for k, d in p.items()}
    with float32_convs():
        logits = tvision.apply_vision(tp, tlayers, torch.from_numpy(x),
                                      tq.W4A4)
        loss = tv.cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=0,
                               atol=1e-5 * np.abs(jlogits).max())
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    for name, d in tp.items():
        for key, t in d.items():
            want = np.asarray(jgrads[name][key])
            assert np.abs(want).max() > 0, (name, key)
            np.testing.assert_allclose(
                t.grad.numpy(), want, rtol=0,
                atol=2e-5 * np.abs(want).max(), err_msg=f"{name}.{key}")


def test_apply_vision_float_forward_and_kernel_dense_head():
    """With no scheme it is the float forward (against the reference's,
    within the sums' order). The kernel-mode evaluation: the W4A4 QAT
    forward up to the flatten, then each dense layer through
    ``dense(mode="kernel")`` (photonic_mvm on signed codes), bitwise equal
    to the reference's ``photonic_mvm_ref`` on the same input and, like
    fake-quant at inference, the same predictions."""
    jlayers, tlayers = jvision.lenet_ir(), tvision.lenet_ir()
    p = numpy_params(jlayers, seed=5)
    x = np.random.default_rng(6).random((8, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda q: jvision.apply_vision(
        q, jlayers, jnp.asarray(x)))(jax.tree.map(jnp.asarray, p)))
    tp = params_from_numpy(p, "cpu")
    got = tvision.apply_vision(tp, tlayers, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    fake = tvision.apply_vision(tp, tlayers, torch.from_numpy(x), tq.W4A4)
    first = next(i for i, l in enumerate(tlayers)
                 if isinstance(l, tacc.DenseSpec))
    kern = tvision.apply_vision(tp, tlayers[:first], torch.from_numpy(x),
                                tq.W4A4)
    for layer in tlayers[first:]:
        y = TL.dense(tp[layer.name], kern, quant=tq.W4A4, mode="kernel")
        want = np.asarray(jref.photonic_mvm_ref(
            jnp.asarray(kern.numpy()), jnp.asarray(p[layer.name]["w"]),
            jq.W4A4, 1.0 / 15.0)) + p[layer.name]["b"]
        np.testing.assert_array_equal(y.numpy(), want, err_msg=layer.name)
        kern = torch.relu(y) if layer.act == "relu" else y
    assert torch.equal(fake.argmax(-1), kern.argmax(-1))
    np.testing.assert_allclose(kern.numpy(), fake.numpy(), rtol=0,
                               atol=1e-4 * float(fake.abs().max()))


# -- 20 LeNet steps in both packages -------------------------------------------

STEPS, BATCH, N_TRAIN = 20, 64, 512


@pytest.fixture(scope="module")
def lenet_runs():
    """(reference losses, reference test accuracy, the port's TrainRun, its
    test accuracy, the initial numpy weights): LeNet W4A4 trained 20 steps
    by both packages from the same weights on the same 512 digits."""
    layers = jvision.lenet_ir()
    p0 = numpy_params(layers, seed=0)
    xtr, ytr = synthetic_digits(N_TRAIN, seed=1)
    xte, yte = synthetic_digits(256, seed=2)
    cfg = JAdamWConfig(lr=2e-3, weight_decay=0.0)
    params = jax.tree.map(jnp.asarray, p0)
    opt = jadamw_init(params, cfg)

    @jax.jit
    def step(params, opt, xb, yb):
        loss, grads = jax.value_and_grad(_jax_loss(layers, xb, yb,
                                                   jq.W4A4))(params)
        params, opt, _ = jadamw_update(params, grads, opt, cfg)
        return params, opt, loss

    losses = []
    for i in range(STEPS):
        lo = (i * BATCH) % N_TRAIN
        params, opt, loss = step(params, opt, jnp.asarray(xtr[lo:lo + BATCH]),
                                 jnp.asarray(ytr[lo:lo + BATCH]))
        losses.append(float(loss))
    logits = jvision.apply_vision(params, layers, jnp.asarray(xte), jq.W4A4)
    jacc_ = float(jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(yte)))
    run = tv.train("lenet", tq.W4A4, STEPS, BATCH, device="cpu",
                   params=params_from_numpy(p0, "cpu"), n_train=N_TRAIN)
    return losses, jacc_, run, tv.evaluate(run, xte, yte), p0


def test_lenet_qat_steps_fall_and_agree_with_jax(lenet_runs):
    """The first step sees the same weights and batch: its loss within
    1e-4 relative (the reference's jitted step divides by the 1/15 CRC
    step as a reciprocal multiply, an ulp off the eager division both
    packages' functions compute). After 20 steps the two runs have
    drifted apart by rounding, so they agree on what training is for:
    each loss falls, and the test accuracies are within 0.05."""
    jlosses, jacc_, run, acc, _ = lenet_runs
    assert len(run.losses) == STEPS and run.clock == "host"
    assert all(math.isfinite(v) for v in run.losses)
    assert run.losses[0] == pytest.approx(jlosses[0], rel=1e-4)
    assert jlosses[-1] < jlosses[0] and run.losses[-1] < run.losses[0]
    assert abs(acc - jacc_) <= 0.05, (acc, jacc_)
    assert acc > 0.3                 # well above chance (0.1) for both


@pytest.mark.parametrize("scheme", ["w4a4", "mx43"])
def test_trained_weights_served_bitwise_by_the_reference(lenet_runs, scheme):
    """The port's trained LeNet, through ``params_to_numpy``, runs in the
    reference's ``run_per_frame`` (its reference backend) bitwise equal to
    the port's ``run_per_frame`` on the same frames."""
    js, ts = {"w4a4": (jq.W4A4, tq.W4A4), "mx43": (jq.MX_43, tq.MX_43)}[scheme]
    run = lenet_runs[2]
    trained = params_to_numpy(run.params)
    assert not np.array_equal(trained["fc1"]["w"], lenet_runs[4]["fc1"]["w"])
    frames, _ = synthetic_digits(6, seed=9)
    got = Program.from_model("lenet", params=run.params).compile(
        Options(scheme=ts, device="cpu")).run_per_frame(frames).numpy()
    jprog = jvision.vision_program("lenet",
                                   params=jax.tree.map(jnp.asarray, trained))
    want = np.asarray(jprog.compile(repro.Options(
        scheme=js, backend="reference")).run_per_frame(frames))
    np.testing.assert_array_equal(got, want)


def test_trained_vgg9_served_bitwise_by_the_reference():
    """Full-width VGG9-CA trained 2 steps at batch 8 on the port: its
    weights served by the reference bitwise equal to the port."""
    run = tv.train("vgg9", tq.W4A4, 2, 8, device="cpu")
    assert all(math.isfinite(v) for v in run.losses)
    frames, _ = synthetic_textures(3, n_classes=10, seed=9)
    got = Program.from_model("vgg9", params=run.params).compile(
        Options(scheme=tq.W4A4, device="cpu")).run_per_frame(frames).numpy()
    jprog = jvision.vision_program("vgg9", params=jax.tree.map(
        jnp.asarray, params_to_numpy(run.params)))
    want = np.asarray(jprog.compile(repro.Options(
        scheme=jq.W4A4, backend="reference")).run_per_frame(frames))
    np.testing.assert_array_equal(got, want)


def test_params_to_numpy_is_the_reverse_of_params_from_numpy():
    p = numpy_params(tvision.lenet_ir(), seed=1)
    t = params_from_numpy(p, "cpu")
    t["fc1"]["w"].requires_grad_()
    back = params_to_numpy(t)
    for layer, d in p.items():
        for k, v in d.items():
            assert back[layer][k].dtype == np.float32
            np.testing.assert_array_equal(back[layer][k], v)
    back["fc1"]["w"][0, 0] = 99.0                  # a copy, not a view
    assert float(t["fc1"]["w"][0, 0].detach()) != 99.0


# -- fit_recon_head -----------------------------------------------------------

@pytest.fixture(scope="module")
def recon():
    frames, _ = synthetic_textures(4, n_classes=10, seed=3)
    jlayers, jparams = JPIPELINES["compress_recon_deconv"].build(32, 32, 3)
    tlayers, tparams = TPIPELINES["compress_recon_deconv"].build(32, 32, 3)
    return frames, (jlayers, jparams), (tlayers, tparams)


def test_fit_recon_head_five_steps_against_jax(recon):
    """Five SGD steps from the identity head: the head within 1e-4 of its
    largest tap. The float path (CA, bilinear, two convs) sums in another
    order and the reference's gradient is jitted; five steps at lr 0.3
    carry those ulps forward."""
    frames, (jl, jpar), (tl, tpar) = recon
    want = jfit(jl, jpar, jnp.asarray(frames), steps=5)
    got = tfit(tl, tpar, frames, steps=5, device="cpu")
    for name in ("rec1", "rec2"):
        w = np.asarray(want[name]["w"])
        np.testing.assert_allclose(got[name]["w"].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    # the inputs are not mutated
    assert float(tpar["rec1"]["w"][1, 1, 0, 0]) == 1.0
    assert float(tpar["rec1"]["w"].abs().sum()) == 1.0


def test_fit_recon_head_psnr_gain_against_jax(recon):
    """The full schedule (150 steps): the PSNR gain over the identity head
    within 0.1 dB of the reference's, and a gain in both."""
    frames, (jl, jpar), (tl, tpar) = recon
    jx = jnp.asarray(frames)
    jtarget, ttarget = jgray(jx), tgray(frames)
    jgain = float(jpsnr(jtarget, japply(jl, jfit(jl, jpar, jx), jx), 1.0)
                  - jpsnr(jtarget, japply(jl, jpar, jx), 1.0))
    fitted = tfit(tl, tpar, frames, device="cpu")
    tgain = float(tpsnr(ttarget, tapply(tl, fitted, frames), 1.0)
                  - tpsnr(ttarget, tapply(tl, tpar, frames), 1.0))
    assert jgain > 0.5 and tgain > 0.5
    assert abs(tgain - jgain) <= 0.1, (tgain, jgain)


# -- the trainer --------------------------------------------------------------

def test_accuracy_trend_prints_bench_accuracy_lines(capsys):
    """bench_accuracy's five scheme lines and its trend line, under its
    names (2 steps here: the format, not the trend)."""
    accs = tv.accuracy_trend(steps=2, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    names = ["fp32", "4:4", "3:4", "2:4", "MX43"]
    assert [ln.split(",")[0] for ln in lines] == \
        [f"bench_accuracy.lenet_digits.{n}" for n in names] + \
        ["bench_accuracy.trend"]
    assert sorted(accs) == sorted(names)
    assert lines[0].split(",")[2].startswith("acc=")
    assert lines[-1].startswith("bench_accuracy.trend,0.0,w4_ge_w2=")


def test_cli_trains_and_deploys_on_the_cpu(capsys):
    tv.main(["--model", "lenet", "--scheme", "w4a4", "--steps", "3",
             "--device", "cpu"])
    out = capsys.readouterr().out
    row = next(ln for ln in out.splitlines() if ln.startswith("[4:4]"))
    acc, served, power, kfps, us, ms = (float(v) for v in row.split()[1:])
    assert 0 <= acc <= 1 and 0 <= served <= 1
    assert power > 0 and kfps > 0 and us > 0 and ms > 0
    assert "step ms by host" in out


def test_train_rejects_an_untrainable_model():
    with pytest.raises(ValueError, match="no training data"):
        tv.dataset("vgg16", 4, 0)
