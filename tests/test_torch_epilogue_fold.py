"""The executor's epilogue folded into the int8 strip conv's store, and its
one-launch cluster form, on the CPU.

A dense conv on the int8 strip route whose requant takes an act of
``dispatch.FUSABLE_ACTS`` and a max pool (or none) runs as one call
(``dispatch.conv_int_epilogue``): the conv's store writes y -- the plan's
``acc * (act_scale * ws) + bias``, the act, the clamp at 0, unpooled --
and each CTA's max of it, and the epilogue's pass 2 max-pools that y as
it writes the codes. Every other per-frame requant that fits runs as one
launch, a thread-block cluster a frame, each CTA holding its slice of y.

Held here, bitwise: the folded call's plain version against the
reference package's conv and its jitted epilogue; the split (the
store's y and per-CTA maxima over ``igemm_config``'s tiles, then pass 2
pooling from the unpooled y, through the wrapper and the kernel's walk
emulated) against ``epilogue_ref``, NaN and inf included; the cluster
kernel's slices, emulated, at every cluster size it takes; the plan's
``folded_epilogues``; and ``epilogue_config``'s choice at every call
shape of the VGG16, vision and imaging paths and ``EPILOGUE_EDGES``.
The kernels run only on the card (``test_torch_gpu.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels import dispatch as jdispatch
from repro.core import quant as jquant
from repro_torch import Options, Program
from repro_torch.analysis import verifier
from repro_torch.core import plan as tplan
from repro_torch.core.accelerator import ConvSpec, DenseSpec, FlattenSpec
from repro_torch.core.quant import W4A4
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.conv_bank import strip
from repro_torch.kernels.edge_shapes import (EPILOGUE_EDGES,
                                             EPILOGUE_NAN_EDGES,
                                             epilogue_case, epilogue_nan_case)
from repro_torch.kernels.epilogue import ops
from repro_torch.kernels.epilogue.ref import epilogue_ref
from repro_torch.weights import params_from_numpy
from test_torch_epilogue import (A_QMAX, _emulated_launch, _EmulatedPair,
                                 _jax_layer, _reference, _seeded_params)

ACTS = ("relu", "none")
POOLS = (("max", 2), None)


def _fold_inputs(seed, batch, h=8, w=8, ci=16, co=32, per_frame=True):
    """W4A4 codes [batch, h, w, ci] and levels [3, 3, ci, co], act_scale
    (one a frame or one), ws and bias, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (batch, h, w, ci)).astype(np.float32)
    wq = rng.integers(-7, 8, (3, 3, ci, co)).astype(np.float32)
    s = rng.uniform(0.001, 0.01, (batch, 1, 1, 1)).astype(np.float32)
    s = s if per_frame else s[:1].reshape(())
    ws = rng.uniform(0.01, 0.2, (co,)).astype(np.float32)
    bias = rng.normal(0, 0.3, co).astype(np.float32)
    return codes, wq, s, ws, bias


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("act", ACTS)
def test_folded_call_plain_equals_the_reference_conv_and_epilogue(
        act, pool, per_frame, batch):
    codes, wq, s, ws, bias = _fold_inputs(batch + 7, batch,
                                          per_frame=per_frame)
    pads = ((1, 1), (1, 1))
    t = torch.from_numpy
    got = dispatch.conv_int_epilogue(
        t(codes), t(s), t(wq), t(ws), t(bias), 1, pads, act, pool,
        a_qmax=A_QMAX, per_frame=per_frame)
    with jdispatch.use_backend("reference"):
        acc = jdispatch.conv_int(jnp.asarray(codes), jnp.asarray(wq), 1,
                                 pads)
    want = _reference(acc, jnp.asarray(s), jnp.asarray(ws),
                      jnp.asarray(bias), jnp.float32(A_QMAX), act, pool,
                      per_frame, True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _split(monkeypatch, acc, fold, pool, per_frame, operand=None):
    """The folded call's split on an accumulate: the store's plain version
    (y and each CTA's max over the int8 kernel's tiles), then pass 2
    through the wrapper and the emulated kernel, pooling the unpooled y."""
    b, h, w, c = acc.shape
    cfg = strip.igemm_config(b, h, w, 16, c, 3, 1)
    y, partials = strip.fold_ref(acc, fold, cfg)
    assert partials.shape == (b, strip.fold_partials(b, cfg))
    pair = _EmulatedPair()
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "library", lambda name, sigs: pair)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    reset_launch_counts()
    try:
        got = ops.launch_folded(y, partials, pool, A_QMAX, per_frame, None,
                                operand)
        assert launch_counts()["epilogue"] == 1
    finally:
        reset_launch_counts()
    assert pair.launches == ["quant"]
    return got


@pytest.mark.parametrize("operand", [None, (3, ((1, 1), (1, 1)))])
@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("act", dispatch.FUSABLE_ACTS)
def test_fold_split_emulated_equals_the_plain_version(monkeypatch, act, pool,
                                                      per_frame, operand):
    # 3 frames of 18 x 20 x 40: column tiles and channel blocks that do
    # not divide the output, partials over several CTAs a frame
    rng = np.random.default_rng(len(act) + (pool is None) + 2 * per_frame)
    acc = torch.from_numpy(rng.integers(-600, 601, (3, 18, 20, 40))
                           .astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.001, 0.01, (3, 1, 1, 1))
                         .astype(np.float32))
    s = s if per_frame else s.reshape(-1)[0]
    ws = torch.from_numpy(rng.uniform(0.01, 0.2, 40).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, 40).astype(np.float32))
    got = _split(monkeypatch, acc, strip.Fold(s, ws, bias, act), pool,
                 per_frame, operand)
    want = epilogue_ref(acc, s, ws, bias, act, pool, A_QMAX, per_frame,
                        None, operand)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("i", [i for i, (_, pool) in
                               enumerate(EPILOGUE_NAN_EDGES)
                               if pool is None or pool[0] == "max"])
def test_fold_split_emulated_keeps_a_nan_as_the_plain_version(
        monkeypatch, i, per_frame):
    # EPILOGUE_NAN_EDGES' NaN and +inf (its avg-pooled edge does not fold)
    act, pool = EPILOGUE_NAN_EDGES[i]
    x, s, ws, bias = epilogue_nan_case(EPILOGUE_NAN_EDGES[i], per_frame,
                                       torch.Generator().manual_seed(i),
                                       "cpu")[:4]
    got = _split(monkeypatch, x, strip.Fold(s, ws, bias, act), pool,
                 per_frame)
    want = epilogue_ref(x, s, ws, bias, act, pool, A_QMAX, per_frame)
    assert bool(want[1].isnan().any()) == (act != "sign")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _cluster_config(args, cluster):
    g = ops.geometry(args[0].contiguous(), args[5], args[9])
    vec = ops.epilogue_config(g.b, g.n, g.c, g.aligned, g.op_words, g.p,
                              True).vec
    return ops.EpilogueConfig(vec, cluster=cluster, smem=ops.cluster_smem(
        g.n, g.c, vec, cluster, g.op_words > 0))


@pytest.mark.parametrize("cluster", ops.CLUSTERS)
@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("i", range(len(EPILOGUE_EDGES)))
def test_cluster_slices_emulated_equal_the_plain_version(monkeypatch, i,
                                                         per_frame, cluster):
    # per tensor the cluster form takes one frame
    edge = EPILOGUE_EDGES[i] if per_frame else (1,) + EPILOGUE_EDGES[i][1:]
    args = epilogue_case(edge, per_frame, torch.Generator().manual_seed(i),
                         "cpu")
    got = _emulated_launch(monkeypatch, args, _cluster_config(args, cluster))
    want = epilogue_ref(*args)
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
    assert got[1].shape == want[1].shape and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cluster", ops.CLUSTERS)
@pytest.mark.parametrize("i", range(len(EPILOGUE_NAN_EDGES)))
def test_cluster_slices_emulated_keep_a_nan_as_the_plain_version(
        monkeypatch, i, cluster):
    args = epilogue_nan_case(EPILOGUE_NAN_EDGES[i], True,
                             torch.Generator().manual_seed(i), "cpu")
    got = _emulated_launch(monkeypatch, args, _cluster_config(args, cluster))
    want = epilogue_ref(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


FOLD_LAYERS = (ConvSpec("conv1", 3, 16, pool=("max", 2)),
               ConvSpec("conv2", 16, 32, act="none"),
               ConvSpec("conv3", 32, 32, pool=("avg", 2)),
               ConvSpec("conv4", 32, 16, act="tanh"),
               ConvSpec("conv5", 16, 16, act="sign", pool=("max", 2)),
               FlattenSpec(), DenseSpec("fc1", 2 * 2 * 16, 10, act="none"))


def _fold_program():
    return Program(FOLD_LAYERS, params_from_numpy(
        _seeded_params(FOLD_LAYERS, 9), "cpu"), (16, 16, 3), name="fold")


def test_plan_records_the_folded_epilogues():
    # conv2 and conv5 fold; conv1 is on the float route, conv3's avg pool
    # and conv4's tanh keep the pair and the torch ops
    plan = _fold_program().compile(Options(
        scheme=W4A4, device="cpu", conv_vmem_budget=2048,
        verify="off")).plan
    assert plan.strip_routes["conv1"] == "float"
    assert plan.folded_epilogues == ("conv2", "conv5")
    assert set(plan.folded_epilogues) <= set(plan.int_operands)
    vgg = Program.from_model("vgg16", params={}).compile(
        Options(scheme=W4A4, device="cpu", verify="off")).plan
    assert vgg.folded_epilogues == tuple(f"conv{i}" for i in range(1, 11))
    # the verifier counts the fold's warp maxima in the int8 CTA
    g = vgg.steps[0].geom
    cfg = strip.igemm_config(8, 224, 224, 4, 64, 3, 1)
    assert verifier._int_smem(cfg, g.kernel, g.stride, True) == \
        cfg.smem + strip.IGEMM_FOLD_RED


@pytest.mark.parametrize("per_frame", [True, False])
def test_folded_run_equals_the_reference_backend_and_package(per_frame):
    prog = _fold_program()
    exe = prog.compile(Options(scheme=W4A4, device="cpu",
                               conv_vmem_budget=2048, verify="off"))
    frames = torch.from_numpy(np.random.default_rng(13).random(
        (3, 16, 16, 3)).astype(np.float32))
    folds = []
    real = dispatch.conv_int_epilogue

    def spy(*a, **kw):
        folds.append((kw["x_operand"], kw["operand"] is not None))
        return real(*a, **kw)

    dispatch.conv_int_epilogue = spy
    try:
        reset_launch_counts()
        got = tplan._execute(exe.plan, exe.params(), frames,
                             per_frame=per_frame)
    finally:
        dispatch.conv_int_epilogue = real
    assert sum(launch_counts().values()) == 0           # the CPU: plain
    # conv2 takes conv1's operand and hands conv3 its own; conv5 takes
    # the operand conv4's torch ops wrote and writes float codes
    assert folds == [(True, True), (True, False)]
    ref = tplan._execute(exe.plan, exe.params(), frames,
                         per_frame=per_frame, backend="reference")
    assert torch.equal(got, ref)
    jexe = repro.Program(
        tuple(_jax_layer(l) for l in FOLD_LAYERS),
        {n: {k: jnp.asarray(v) for k, v in p.items()}
         for n, p in _seeded_params(FOLD_LAYERS, 9).items()},
        (16, 16, 3)).compile(repro.Options(scheme=jquant.W4A4,
                                           backend="reference",
                                           conv_vmem_budget=2048))
    run = jexe.run_per_frame if per_frame else jexe.run
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(run(frames.numpy())))


def _path_requants():
    """(program, requant) of every requant of the VGG16, vision and
    imaging (256x256) paths, from the verifier's layer walk."""
    progs = [Program.from_model(m, params={})
             for m in ("vgg16", "lenet", "vgg9")]
    progs += [Program.from_pipeline(p, 256, 256) for p in (
        "edge_detect", "prewitt_edge", "sharpen", "unsharp_mask",
        "denoise_gauss", "denoise_box", "compress_recon",
        "compress_recon_deconv")]
    for prog in progs:
        plan = prog.compile(Options(scheme=W4A4, device="cpu",
                                    verify="off")).plan
        for r in verifier._epilogue_requants(plan):
            yield prog.name, r


def _form(cfg):
    return f"cluster{cfg.cluster}" if cfg.cluster else "pair"


def test_epilogue_config_at_every_path_call_and_edge():
    requants = list(_path_requants())
    assert len(requants) > 30
    for name, (step, n, c, p, words) in requants:
        for b in (1, 8):
            cfg = ops.epilogue_config(b, n, c, True, words, p, True)
            assert cfg.vec == (4 if c % 4 == 0 or (p == 1 and n % 4 == 0)
                               else 1)
            if ops.CLUSTER_MIN <= n <= ops.CLUSTER_MAX:
                # one launch: about CLUSTER_SLICE elements a CTA, 4 CTAs
                # at least, 16 at most, a power of two
                want = max(4, -(-n // ops.CLUSTER_SLICE))
                assert cfg.cluster == min(
                    [cl for cl in ops.CLUSTERS if cl >= want] or [16]), (
                        name, step)
                assert cfg.smem == ops.cluster_smem(n, c, cfg.vec,
                                                    cfg.cluster, words > 0)
                assert cfg.smem <= ops.SMEM_MAX
            else:
                assert cfg.cluster == 0, (name, step)
            # per tensor at batch > 1 and a max across shards: the pair
            pair = ops.epilogue_config(8, n, c, True, words, p, False)
            assert pair.cluster == 0
            assert ops.epilogue_config(b, n, c, True, words, p, False,
                                       True).cluster == 0
    forms = {(name, step): _form(ops.epilogue_config(8, n, c, True, words,
                                                     p, True))
             for name, (step, n, c, p, words) in requants}
    # the card's fastest at each (PERF.md): VGG16's frames, conv11
    # and conv12 the pair; conv13, the flatten, fc1 and fc2 a cluster; the
    # imaging path's 3-channel 256x256 frames the pair, its 1-channel ones
    # 16 CTAs a frame, a 128x128 CA output 8; LeNet's small calls the pair
    assert [forms["vgg16", s] for s in ("frames", "conv11", "conv12",
                                         "conv13", "FlattenStep", "fc1",
                                         "fc2")] == [
        "pair", "pair", "pair", "cluster16", "cluster16", "cluster4",
        "cluster4"]
    assert forms["edge_detect", "frames"] == "pair"
    assert forms["edge_detect", "CAStep"] == "cluster16"
    assert forms["compress_recon", "CAStep"] == "cluster8"
    assert forms["compress_recon", "UpsampleStep"] == "cluster16"
    assert {f for (n, _), f in forms.items() if n == "lenet"} == {"pair"}
    # VGG16's folded convs: pass 2 alone, pooling the conv's y
    for w_out, co in ((224, 64), (56, 256)):
        cfg = ops.epilogue_config(8, w_out * w_out * co, co, True, 0, 2,
                                  True, fold=True)
        assert cfg.cluster == 0 and cfg.vec == 4
    for edge in EPILOGUE_EDGES:
        args = epilogue_case(edge, True, torch.Generator().manual_seed(0),
                             "cpu")
        g = ops.geometry(args[0].contiguous(), args[5], args[9])
        cfg = ops.epilogue_config(g.b, g.n, g.c, g.aligned, g.op_words,
                                  g.p, True)
        if cfg.cluster:
            slice_ = ops.cluster_slice(g.n, g.c, cfg.vec, cfg.cluster,
                                       g.op_words > 0)
            assert slice_ * cfg.cluster >= g.n and slice_ % cfg.vec == 0
    # a frame past the cluster form's range takes the pair
    big = 224 * 224 * 64
    assert ops.epilogue_config(1, big, 64, True, 0, 1, True).cluster == 0
