"""repro_torch imaging pipelines on the CPU against the JAX reference.

* all 8 ``PIPELINES`` at 32x32x3 and 64x64x3, and at 32x32x3 with a pinned
  4 KB conv budget that sends every conv down the strip path: the port's
  ``run`` and ``run_per_frame``, through the kernel wrappers' CPU path and
  through the reference backend, are bitwise equal to the reference
  package's compiled reference backend — with one stated exception below;
* the bilinear and nearest upsample against ``jax.image.resize``;
* the CA's RGB->gray front at p = 1 on 256x256 frames;
* ``apply_float``, ``psnr`` and ``ssim`` against the reference's at 1e-5;
* the fusion capacity rule: the port never plans a segment the chain
  kernel cannot hold in one block's shared memory;
* pipelines served through ``serve.Server`` on the CPU equal batch-1 runs.

The exception: XLA's CPU dot takes another summation order for the resize
at some small shapes. At a 16-wide input with batch >= 2 or 3 channels
(the upsample of a 32x32 ``compress_recon`` frame is [3, 16, 16, 1]) its W
pass rounds each product before the sum, where the port (and XLA at 32,
64, 128 and 256 wide, the served sizes among them) chains FMAs: the
upsample differs by 1 ulp on about 8% of the outputs, so a CRC scale can
be 1 ulp off and a few codes cross a rounding boundary. There both runs
are held to one code step; at 64x64 they are bitwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import quant as jquant
from repro.core.compressive import compressive_acquire as jax_ca
from repro.core.compressive import upsample_reconstruct as jax_upsample
from repro.imaging import PIPELINES as JPIPELINES
from repro.imaging import apply_float as jax_apply_float
from repro.imaging import metrics as jmetrics
from repro.imaging import pipelines as jpipelines
from repro_torch import Options, Program, serve
from repro_torch.core import quant as tquant
from repro_torch.core.compressive import (compressive_acquire,
                                          upsample_reconstruct)
from repro_torch.imaging import (PIPELINES, apply_float, gray_target, psnr,
                                 recon_head_identity_params, ssim)
from repro_torch.kernels.conv_bank.fused import SMEM_PER_BLOCK, smem_layout

NAMES = sorted(PIPELINES)
UPSAMPLING = ("compress_recon", "compress_recon_deconv")


def frames(hw, n=3, seed=0):
    rng = np.random.default_rng(seed + hw)
    f = rng.random((n, hw, hw, 3)).astype(np.float32)
    f[1] *= 0.05            # a dim frame: per-tensor calibration couples it
    return f


@pytest.fixture(scope="module")
def jax_outputs():
    """The reference's run / run_per_frame per (pipeline, case), once."""
    cache = {}

    def get(name, hw, budget):
        key = (name, hw, budget)
        if key not in cache:
            exe = JPIPELINES[name].program(hw, hw, 3).compile(repro.Options(
                scheme=jquant.W4A4, backend="reference",
                conv_vmem_budget=budget))
            f = frames(hw)
            cache[key] = (np.asarray(exe.run(f)),
                          np.asarray(exe.run_per_frame(f)), exe)
        return cache[key]
    return get


CASES = {"32": (32, None), "64": (64, None), "32_strip": (32, 4096)}


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", NAMES)
def test_pipeline_bitwise_equal_to_reference(jax_outputs, name, case,
                                             backend):
    hw, budget = CASES[case]
    want_run, want_pf, jexe = jax_outputs(name, hw, budget)
    exe = Program.from_pipeline(name, hw, hw).compile(Options(
        scheme=tquant.W4A4, device="cpu", backend=backend,
        conv_vmem_budget=budget))
    assert [dataclasses.asdict(s) for s in exe.plan.steps] == \
        [dataclasses.asdict(s) for s in jexe.plan.steps]
    if budget is not None:
        assert all(s.strategy.kind == "strip" for s in exe.plan.steps
                   if hasattr(s, "strategy"))
    f = frames(hw)
    got_run, got_pf = exe.run(f).numpy(), exe.run_per_frame(f).numpy()
    if hw == 32 and name in UPSAMPLING:
        # XLA's 16-wide resize order (module docstring): a CRC scale may be
        # 1 ulp off, and a few codes one step off
        for got, want, step in (
                (got_run, want_run, want_run.max() / 15.0),
                (got_pf, want_pf,
                 want_pf.reshape(len(f), 1, 1, 1, -1).max(axis=-1) / 15.0)):
            diff = np.abs(got - want)
            assert np.all(diff <= step * (1 + 1e-6))
            assert np.mean(diff > 1e-6 * want.max()) < 0.01
    else:
        np.testing.assert_array_equal(got_run, want_run)
        np.testing.assert_array_equal(got_pf, want_pf)


# (batch, n, c, bitwise): at 16 wide XLA's order depends on the batch and
# channels (the module docstring); there the port is within 1 ulp
UPSAMPLES = [(1, 16, 1, True), (1, 16, 3, False), (2, 16, 1, False),
             (2, 32, 1, True), (2, 32, 3, True), (2, 128, 1, True),
             (2, 128, 3, True), (1, 256, 1, True)]


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("b,n,c,bitwise", UPSAMPLES)
def test_upsample_bitwise_equal_to_jax_resize(b, n, c, bitwise, method):
    x = np.random.default_rng(n + c).random((b, n, n, c)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax_upsample(a, 2, method))(x))
    got = upsample_reconstruct(torch.from_numpy(x), 2, method).numpy()
    assert got.shape == (b, 2 * n, 2 * n, c)
    if bitwise or method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_ca_gray_front_bitwise_at_256():
    """CA at p = 1, C = 3 on its scaled input, as the plan runs it."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 16, (2, 256, 256, 3)).astype(np.float32)
    s = (rng.random((2, 1, 1, 1)) + 0.01).astype(np.float32)
    for scale in (s, s[0, 0, 0, 0]):
        want = jax.jit(lambda a, b: jax_ca(a * b, 1, True))(x, scale)
        got = compressive_acquire(torch.from_numpy(x)
                                  * torch.from_numpy(np.asarray(scale)), 1,
                                  True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_apply_float_and_metrics_match_reference(name):
    f = frames(32, n=2, seed=3)
    prog = PIPELINES[name].program(32, 32)
    jprog = JPIPELINES[name].program(32, 32)
    got = apply_float(prog.layers, prog.params, f)
    want = np.asarray(jax_apply_float(jprog.layers, jprog.params, f))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    quant = Program.from_pipeline(name, 32, 32).compile(
        Options(device="cpu")).run(f)
    jq = np.asarray(quant)
    for mine, theirs in ((psnr(got, quant), jmetrics.psnr(want, jq)),
                         (psnr(got, quant, 1.0),
                          jmetrics.psnr(want, jq, 1.0)),
                         (ssim(got, quant), jmetrics.ssim(want, jq))):
        np.testing.assert_allclose(float(mine), float(theirs), rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_params_and_targets_match_reference():
    for name in NAMES:
        _, params = PIPELINES[name].build(16, 16, 3)
        _, jparams = JPIPELINES[name].build(16, 16, 3)
        assert params.keys() == jparams.keys()
        for layer in params:
            np.testing.assert_array_equal(params[layer]["w"].numpy(),
                                          np.asarray(jparams[layer]["w"]))
    head = recon_head_identity_params()
    for layer, p in jpipelines.recon_head_identity_params().items():
        np.testing.assert_array_equal(head[layer]["w"].numpy(),
                                      np.asarray(p["w"]))
    f = frames(16)
    np.testing.assert_array_equal(
        gray_target(f).numpy(),
        np.asarray(jax.jit(jpipelines.gray_target)(jnp.asarray(f))))
    with pytest.raises(ValueError, match="unknown pipeline"):
        Program.from_pipeline("emboss", 16, 16)
    with pytest.raises(ValueError, match="channels"):
        PIPELINES["sharpen"].program(16, 16, 2)


def test_fusion_capacity_follows_shared_memory():
    """edge_detect at 256x256: the reference fuses grad+edge_mag (its 4 MiB
    VMEM budget); the chain kernel cannot hold 786,560 bytes in one block,
    so auto fuses nothing and fuse='on' refuses at compile time. At 64x64
    both plans fuse the same segment."""
    big = Program.from_pipeline("edge_detect", 256, 256)
    jbig = JPIPELINES["edge_detect"].program(256, 256, 3)
    jexe = jbig.compile(repro.Options(scheme=jquant.W4A4))
    assert [s.names for s in jexe.plan.fused_segments] == \
        [("grad", "edge_mag")]
    exe = big.compile(Options(device="cpu"))
    assert exe.plan.fused_segments == ()
    assert exe.report.fused_segments == []
    geoms = [s.geom for s in exe.plan.steps if hasattr(s, "geom")]
    assert smem_layout(geoms)[2] == 786560 > SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="786560 bytes"):
        big.compile(Options(device="cpu", fuse="on"))
    small = Program.from_pipeline("edge_detect", 64, 64).compile(
        Options(device="cpu"))
    jsmall = JPIPELINES["edge_detect"].program(64, 64, 3).compile(
        repro.Options(scheme=jquant.W4A4))
    assert [dataclasses.asdict(s) for s in small.plan.fused_segments] == \
        [dataclasses.asdict(s) for s in jsmall.plan.fused_segments]
    assert len(small.plan.fused_segments) == 1
    # the auto plans at the served size: nothing fuses, strategies as the
    # reference's
    for name in NAMES:
        plan = Program.from_pipeline(name, 256, 256).compile(
            Options(device="cpu")).plan
        jplan = JPIPELINES[name].program(256, 256, 3).compile(
            repro.Options(scheme=jquant.W4A4)).plan
        assert plan.fused_segments == ()
        assert [dataclasses.asdict(s) for s in plan.steps] == \
            [dataclasses.asdict(s) for s in jplan.steps]


def test_auto_fusion_splits_a_run_at_the_capacity():
    """Buffer 0 holds the even inter-stage frames and buffer 1 the odd:
    a wide input and a wide third output fit apart but not together."""
    from repro_torch.kernels import dispatch
    pads = ((1, 1), (1, 1))
    a = dispatch.ChainGeom("a", 32, 32, 48, 1, 3, 1, pads, act="relu")
    b = dispatch.ChainGeom("b", 32, 32, 1, 1, 3, 1, pads, act="relu")
    c = dispatch.ChainGeom("c", 32, 32, 1, 48, 3, 1, pads, act="relu")
    d = dispatch.ChainGeom("d", 32, 32, 48, 1, 3, 1, pads, act="relu")
    assert smem_layout([a, b])[2] <= SMEM_PER_BLOCK
    assert smem_layout([a, b, c])[2] > SMEM_PER_BLOCK
    segs = dispatch.select_fused_segments([a, b, c, d, None, b])
    # c overflows a+b: a+b closes and c starts the next run
    assert [s.names for s in segs] == [("a", "b"), ("c", "d")]
    with pytest.raises(ValueError, match="bytes of shared memory"):
        dispatch.select_fused_segments([a, b, c], mode="on")


def test_served_pipelines_equal_batch1_runs_on_cpu():
    names = ("denoise_box", "compress_recon_deconv")
    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=1.0,
                                            device="cpu"))
    for name in names:
        server.register(name, Program.from_pipeline(name, 16, 16),
                        Options(device="cpu"))
    server.start()
    try:
        reqs = [(names[i % 2], frames(16, n=2 + i % 3, seed=i))
                for i in range(6)]
        outs = [f.result(timeout=120) for f in
                [server.submit(n, f) for n, f in reqs]]
    finally:
        server.stop()
    for (name, f), out in zip(reqs, outs):
        exe = Program.from_pipeline(name, 16, 16).compile(
            Options(device="cpu"))
        singles = np.concatenate([exe.run_per_frame(f[i:i + 1]).numpy()
                                  for i in range(len(f))])
        np.testing.assert_array_equal(np.asarray(out), singles)
