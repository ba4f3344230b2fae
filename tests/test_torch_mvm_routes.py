"""photonic_mvm's routes on the CPU: the route rule, the laid-out levels,
each route's K loop and its warps' reduction emulated, the laid-out
levels against the JAX package's Pallas kernel in interpret mode, the
plan's levels laid out at bind, and the verifier's audit of every launch.

The kernels run only on the card (``tests/test_torch_gpu.py``); here their
launch rule (``photonic_mvm.ops.mvm_config``) and the index arithmetic of
their K loops are held against the plain version, bitwise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.photonic_mvm.ops import photonic_mvm_prequant
from repro_torch import Options, Program
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import ConvStep, DenseStep
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.edge_shapes import (MVM_EDGES, SIGNED_MVM_SHAPES,
                                             VGG16_SHAPES)
from repro_torch.kernels.photonic_mvm import ops
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref

# photonic_mvm's calls at bucket 8 on the vision (VGG9-CA, LeNet) and
# imaging (the eight pipelines at 256x256) paths, from their compiled plans
VISION_CALLS = [(2048, 9, 64), (2048, 576, 64), (512, 576, 128),
                (512, 1152, 128), (128, 1152, 256), (128, 2304, 256),
                (8, 1024, 512), (8, 512, 512), (8, 512, 100), (8, 400, 120),
                (8, 120, 84), (8, 84, 10)]
IMAGING_CALLS = [(524288, 9, 2), (524288, 2, 1), (524288, 9, 1),
                 (524288, 9, 4)]
VGG16_CALLS = [(m * b, k, n) for b in (1, 2, 4, 8)
               for _, m, k, n in VGG16_SHAPES["photonic_mvm"]]
ALL_CALLS = sorted(set(
    VGG16_CALLS + VISION_CALLS + IMAGING_CALLS
    + [e[:3] for e in MVM_EDGES + SIGNED_MVM_SHAPES]))


def _launcher_takes(cfg, m, k, n) -> bool:
    """``mvm_int_launch``'s checks, restated from ``csrc/photonic_mvm.cu``."""
    if cfg.route == "skinny":
        return cfg.bn == n <= 8 and k <= 32
    if cfg.route == "gemm":
        return (cfg.bm, cfg.bn) == (16, 64)
    if cfg.route == "stream":
        return cfg.bn == 16 and cfg.bm in (8, 16) and m <= cfg.bm
    return (cfg.route == "wgmma" and (cfg.bm, cfg.bn) == (64, 64)
            and k >= 16 and k % 16 == 0)


@pytest.mark.parametrize("m,k,n", ALL_CALLS)
def test_every_path_call_and_edge_takes_one_route_the_launcher_takes(m, k,
                                                                     n):
    cfg = ops.mvm_config(m, k, n)
    assert _launcher_takes(cfg, m, k, n)
    # the route is a function of the shape alone, and one route a shape
    want = ("skinny" if n <= 8 and k <= 32 else "stream" if m <= 16
            else "wgmma" if k and k % 16 == 0 else "gemm")
    assert cfg.route == want
    # no CTA has an empty K range: each takes every box, one at least
    assert ops.k_pad(k) // ops.KBOX >= 1
    assert cfg.smem <= 232448


def test_vgg16_takes_the_stream_and_wgmma_routes_at_every_bucket():
    for b in (1, 2, 4, 8):
        convs, *fcs = [ops.mvm_config(m * b, k, n) for _, m, k, n in
                       VGG16_SHAPES["photonic_mvm"]]
        assert convs.route == "wgmma"
        assert [c.route for c in fcs] == ["stream"] * 3
    # bucket 8: conv11-13 fill the card with 64 x 64 tiles, fc1 and fc2
    # stream 256 tiles of 16 channels, fc3 63; bucket 1's M = 196 takes
    # 32 tiles, each over all of K
    assert ops.mvm_config(1568, 4608, 512).ctas == 200
    assert ops.mvm_config(8, 25088, 4096).ctas == 256
    assert ops.mvm_config(8, 4096, 1000).ctas == 63
    assert ops.mvm_config(196, 4608, 512).ctas == 32


@pytest.mark.parametrize("k,n", [(0, 3), (1, 1), (31, 9), (128, 16),
                                 (129, 5), (4608, 20), (300, 1000)])
def test_laid_out_levels_transpose_back_and_pad_with_zeros(k, n):
    w = torch.from_numpy(np.random.default_rng(k + n).integers(
        -127, 128, (k, n)).astype(np.int8))
    mw = ops.mvm_weights(w)
    kp = mw.k_pad
    assert mw.wt.dtype == torch.int8 and mw.wt.is_contiguous()
    assert mw.wt.shape == (n, kp) and mw.n == n and mw.k == k
    assert kp % 128 == 0 and kp >= max(k, 1) and kp - k < 128 + (k == 0)
    assert torch.equal(mw.levels(), w)
    assert torch.equal(mw.wt.t()[:k], w)
    assert not mw.wt[:, k:].any()
    # float-carried integer levels are cast as the plan's int8 levels are
    assert torch.equal(ops.mvm_weights(w.float()).wt, mw.wt)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-15, 16, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    ws = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    return a, w, ws


def _dequant(acc, act_scale, ws):
    out = acc.double().float() * act_scale
    return out if ws is None else out * ws.reshape(1, -1)


def _emulate(a, mw, cfg):
    """The raw int32 accumulate as the route's CTAs and warps take it,
    each 32-byte K step of a tile counted once: stream (16 channels a CTA;
    16 warps, warp w box w // 2 of each 8-box stage, steps 2 (w & 1) and
    + 1; the warps' sums), wgmma (64 x 64 tiles, four 32-byte steps a box)
    and gemm (16 x 64 tiles, 32-byte steps over K)."""
    m, k = a.shape
    n, kp = mw.n, mw.k_pad
    ap = F.pad(a.long(), (0, kp - k))       # codes past K read as zero
    wt = mw.wt.long()
    acc = torch.zeros((m, n), dtype=torch.int64)
    seen = torch.zeros((n, kp), dtype=torch.int64)

    def step(rows, cols, k0):
        seen[cols, k0:k0 + 32] += 1
        return ap[rows, k0:k0 + 32] @ wt[cols, k0:k0 + 32].t()

    def i32(t):
        assert t.abs().max() < 2 ** 31 if t.numel() else True
        return t

    boxes = kp // 128
    if cfg.route == "stream":
        rows = slice(0, m)
        for n0 in range(0, n, 16):
            cols = slice(n0, min(n0 + 16, n))
            warps = [0] * 16
            for s0 in range(0, boxes, 8):
                for w in range(16):
                    box = s0 + w // 2
                    if box < boxes:
                        for j in (0, 1):
                            warps[w] = i32(warps[w] + step(
                                rows, cols,
                                box * 128 + (2 * (w & 1) + j) * 32))
            acc[rows, cols] = i32(sum(warps))
    else:
        bm, bn = cfg.bm, cfg.bn
        units = boxes if cfg.route == "wgmma" else -(-max(k, 1) // 32)
        unit = 128 if cfg.route == "wgmma" else 32
        for m0 in range(0, m, bm):
            for n0 in range(0, n, bn):
                rows = slice(m0, min(m0 + bm, m))
                cols = slice(n0, min(n0 + bn, n))
                part = 0
                for u in range(units):
                    for k0 in range(u * unit, (u + 1) * unit, 32):
                        part = i32(part + step(rows, cols, k0))
                acc[rows, cols] = part
    # every 32-byte step of K, up to its 32-byte end, taken once a tile
    k_steps = -(-max(k, 1) // 32) * 32
    tiles_m = 1 if cfg.route == "stream" else -(-m // cfg.bm)
    assert (seen[:, :k_steps] == tiles_m).all()
    return acc


@pytest.mark.parametrize("m,k,n", [
    (8, 25088, 40), (1, 4096, 100), (9, 4096, 60), (16, 777, 129),
    (8, 2304, 100), (13, 1001, 50), (1, 4097, 3), (16, 8192, 30),
    (196, 4608, 70), (129, 2304, 4), (100, 4096, 90), (300, 16, 70),
    (17, 4608, 65), (2048, 576, 64), (33, 777, 129), (2048, 9, 64)])
def test_each_routes_k_loop_and_reduction_emulated_equal_plain(m, k, n):
    a, w, ws = _operands(m, k, n, m * 31 + k + n)
    mw = ops.mvm_weights(w)
    cfg = ops.mvm_config(m, k, n)
    acc = _emulate(a, mw, cfg)
    for scales, act in ((None, 1.0), (ws, 0.37)):
        assert torch.equal(_dequant(acc, act, scales),
                           mvm_int_ref(a, w, scales, act))


@pytest.mark.parametrize("cfg,m", [
    (ops.MvmConfig("gemm", 16, 64), 70), (ops.MvmConfig("wgmma", 64, 64), 16),
    (ops.MvmConfig("stream", 16, 16), 8)], ids=["gemm", "wgmma", "stream"])
def test_forced_routes_emulated_equal_plain(cfg, m):
    """Each route at a shape the rule gives another (70 rows: wgmma; 16
    and 8: the stream with one n8 tile)."""
    a, w, ws = _operands(m, 3008, 37, 9)
    acc = _emulate(a, ops.mvm_weights(w), cfg)
    assert torch.equal(_dequant(acc, 0.37, ws), mvm_int_ref(a, w, ws, 0.37))


@pytest.mark.parametrize("m,k,n", [(1, 31, 9), (5, 300, 77), (17, 129, 130),
                                   (70, 16, 3)])
def test_matmul_int_on_laid_out_levels_equals_pallas_interpret(m, k, n):
    a, w, _ = _operands(m, k, n, 3 * m + k)
    want = np.asarray(photonic_mvm_prequant(
        jnp.asarray(a.numpy()), jnp.asarray(w.numpy()),
        jnp.ones((n,), jnp.float32), act_scale=1.0, bm=8, bn=128, bk=128))
    reset_launch_counts()
    mw = ops.mvm_weights(w)
    got = dispatch.matmul_int(a.float(), w, "kernel", levels=mw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.mvm_int_laid(a, mw).numpy(), want)
    assert torch.equal(got, dispatch.matmul_int(a.float(), w, "kernel"))
    assert launch_counts()["photonic_mvm"] == 0      # the CPU: plain


def test_mvm_int_laid_rejects_codes_that_do_not_chain():
    a, w, ws = _operands(4, 40, 3, 1)
    mw = ops.mvm_weights(w)
    with pytest.raises(ValueError, match="do not chain"):
        ops.mvm_int_laid(a[:, :39], mw)
    with pytest.raises(ValueError, match="scales"):
        ops.mvm_int_laid(a, mw, ws[:2])


def _programs():
    from repro_torch.models.vision import VISION_MODELS, init_vision, vgg16_ir
    lenet = VISION_MODELS["lenet"]()
    vgg16 = tuple(vgg16_ir(in_hw=32))
    return [Program(tuple(lenet), init_vision(
                torch.Generator().manual_seed(3), tuple(lenet)),
                (28, 28, 1), name="lenet"),
            Program(vgg16, init_vision(torch.Generator().manual_seed(4),
                                       vgg16), (32, 32, 3), name="vgg16")]


@pytest.fixture(scope="module")
def programs():
    return _programs()


@pytest.mark.parametrize("i", [0, 1], ids=["lenet", "vgg16_32"])
def test_levels_laid_out_at_bind_for_every_dense_and_resident_step(programs,
                                                                   i):
    prog = programs[i]
    exe = prog.compile(Options(device="cpu", verify="off"))
    plan, params = exe.plan, exe.params()
    weights = plan_mod.quantized_weights(plan.steps, params, plan.consts,
                                         plan.strip_routes)
    mvm_steps = [s.name for s in plan.steps if isinstance(s, DenseStep) or (
        isinstance(s, ConvStep) and s.groups == 1
        and s.strategy.kind == "resident")]
    assert mvm_steps and any(isinstance(s, DenseStep) for s in plan.steps)
    for name, (wq, _, levels) in weights.items():
        if name in mvm_steps:
            assert isinstance(levels, ops.MvmWeights)
            assert torch.equal(levels.levels(),
                               wq.reshape(-1, wq.shape[-1]))
        else:
            assert not isinstance(levels, ops.MvmWeights)
    frames = torch.from_numpy(np.random.default_rng(i).random(
        (3, *prog.input_hwc)).astype(np.float32))
    frames[1] *= 0.1
    for per_frame in (False, True):
        unbound = plan_mod._execute(plan, params, frames, per_frame=per_frame)
        bound = plan_mod._execute(plan, params, frames, per_frame=per_frame,
                                  weights=weights)
        assert torch.equal(unbound, bound)
    view = exe.bind("cpu")
    assert all(isinstance(view._binding.weights[n][2], ops.MvmWeights)
               for n in mvm_steps)
    np.testing.assert_array_equal(
        view.run_per_frame(frames.numpy()).numpy(),
        exe.run_per_frame(frames.numpy()).numpy())


def test_verifier_audits_every_mvm_launch_and_no_registered_plan_trips(
        programs):
    from repro_torch.analysis import verifier
    exe = programs[1].compile(Options(device="cpu", verify="off"))
    launches = verifier.mvm_launches(exe.plan)
    # fc1-fc3 and the resident convs, at batch 1 and 8
    names = {s.name for s in exe.plan.steps if isinstance(s, DenseStep) or (
        isinstance(s, ConvStep) and s.strategy.kind == "resident")}
    assert {(l[0], l[1]) for l in launches} == {
        (n, b) for n in names for b in (1, 8)}
    from repro_torch.models.vision import MODEL_INPUT_HWC
    from repro_torch.imaging import PIPELINES
    targets = [Program.from_model(name, params={})
               for name in sorted(MODEL_INPUT_HWC)]
    targets += [Program.from_pipeline(name, size, size, 3)
                for size in (64, 256) for name in sorted(PIPELINES)]
    for prog in targets:
        plan = prog.compile(Options(device="cpu", verify="off")).plan
        assert not [d for d in verifier.verify_plan(plan)
                    if "photonic_mvm launch" in d.message]


@pytest.mark.parametrize("bad,code", [
    (ops.MvmConfig("stream", 0, 16, 256), "LTR020"),         # no rows
    (ops.MvmConfig("wgmma", 64, 0, 64), "LTR020"),           # no columns
    (ops.MvmConfig("stream", 8, 16, 1), "LTR020"),           # misses channels
    (ops.MvmConfig("gemm", 16, 64, 1), "LTR020"),            # misses rows
    (ops.MvmConfig("gemm", 512, 64, 64), "LTR022"),          # 82 KB static
    (ops.MvmConfig("wgmma", 512, 512, 64), "LTR022"),        # 512 KB dynamic
], ids=["zero_rows", "zero_columns", "short_channels", "short_grid",
        "static_smem", "dynamic_smem"])
def test_verifier_flags_a_bad_mvm_launch(programs, monkeypatch, bad, code):
    from repro_torch.analysis import verifier
    exe = programs[1].compile(Options(device="cpu", verify="off"))
    monkeypatch.setattr(ops, "mvm_config", lambda m, k, n: bad)
    diags = [d for d in verifier.verify_plan(exe.plan)
             if "photonic_mvm launch" in d.message]
    assert diags and {d.code for d in diags} == {code}


def test_recorded_path_calls_are_the_plans_launches():
    """The calls this file and ``edge_shapes.VGG16_SHAPES`` record are the
    compiled plans' photonic_mvm launches at bucket 8
    (``verifier.mvm_launches``), as ``scripts/mvm_routes.py`` reads them."""
    from repro_torch.analysis.verifier import mvm_launches
    from repro_torch.imaging import PIPELINES

    def calls(progs):
        return {(m, k, n) for p in progs for _, b, m, k, n, _ in mvm_launches(
            p.compile(Options(device="cpu", verify="off")).plan) if b == 8}
    vision = calls([Program.from_model(name, params={})
                    for name in ("lenet", "vgg9")])
    # LeNet's convs run fused on the served path; per tensor at batch 8
    # they run the per-layer path, photonic_mvm included
    assert set(VISION_CALLS) <= vision
    assert vision - set(VISION_CALLS) == {(6272, 25, 6), (800, 150, 16)}
    assert calls([Program.from_pipeline(name, 256, 256, 3)
                  for name in PIPELINES]) == set(IMAGING_CALLS)
    assert calls([Program.from_model("vgg16", params={})]) == {
        (8 * m, k, n) for _, m, k, n in VGG16_SHAPES["photonic_mvm"]}
