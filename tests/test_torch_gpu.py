"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the ``gpu``
marker; run them on the card with ``pytest -m gpu tests/test_torch_gpu.py``).
On the card each kernel's wrapper must launch its kernel, count the launch,
and be bitwise equal to its plain PyTorch version on the same inputs; the
whole serving path on the card must equal the port's CPU run, and an
imaging pipeline served through ``serve.Server`` must equal batch-1 runs.
VGG16's kernel shapes at 224x224x3 (``VGG16_SHAPES``) are held bitwise at
batch 1 and 8 (conv1-conv10 on both dense strip kernels, the int8 one also
at the strip edges and the extremes), its bound graph replays to its eager run, and a plan the
verifier proved runs its fused chain with no range check. The training
slice: photonic_mvm's float API on signed codes at both routes, and QAT
steps on the card against the CPU port's. The LM families: every smoke
arch's forward and decode steps on the card against the CPU port (the MoE
archs under both dispatches and three quant modes, their expert indices
equal). The public ``ca_pool`` op with a bank of its own, on every
weighted route. The plan executor's epilogue kernels at their edges (the
one-launch cluster form at every cluster size it takes), at quotients on
and around half-integers (each code the true quotient's), and at every
call of the LeNet, VGG9-CA, imaging (256x256) and VGG16 paths, under both
calibrations, under ``shard_batch``; the requant folded into the int8
strip conv's store at VGG16's shapes and the strip edges; the int8 strip
conv's wgmma form forced at its edges (``INT_WGMMA_EDGES``), and both
forms forced at ``INT_FORM_SHAPES`` (VGG16's conv2-conv13, the conv_bank
op's calls); the dense float conv's tensor-core form forced at its edges
(``F64MMA_EDGES``) and the conv_bank op's calls, and the op's float mode
on it; and the int8 route's levels laid out at bind
against per call. photonic_mvm's four
routes at their edges (the stream at M = 1..16 with ragged K and N =
1,000, each route forced at a shape the rule gives another, a
configuration the launcher refuses) and VGG16 under ``shard_batch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import Options, Program, serve
from repro_torch.core.compressive import compressive_acquire
from repro_torch.core.plan import padtype_to_pads
from repro_torch.core.quant import W4A4
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.ca_pool.ops import acquire, ca_config, ca_pool
from repro_torch.kernels.ca_pool.ref import ca_pool_ref_generic
from repro_torch.kernels.conv_bank import strip
from repro_torch.kernels.conv_bank.fused import conv_chain
from repro_torch.kernels.conv_bank.ops import conv_bank, conv_bank_plain
from repro_torch.kernels.conv_bank.ref import conv_chain_ref
from repro_torch.kernels.edge_shapes import (CA_EDGES, CHAIN_EDGES, CHAINS,
                                             CONV_BANK_CALLS,
                                             CONV_BANK_NARROW, DW_EDGES,
                                             EPILOGUE_EDGES, F64MMA_EDGES,
                                             EPILOGUE_NAN_EDGES,
                                             INT_FORM_SHAPES,
                                             INT_WGMMA_EDGES, MVM_EDGES,
                                             SIGNED_MVM_SHAPES, STRIP_EDGES,
                                             VGG16_SHAPES, EpilogueCall,
                                             chain_case, epilogue_calls,
                                             epilogue_case, epilogue_fns,
                                             epilogue_nan_case, odd_offset,
                                             quotient_ties, vgg16_case)
from repro_torch.kernels.epilogue import ops
from repro_torch.kernels.epilogue.ops import epilogue
from repro_torch.kernels.epilogue.ref import epilogue_ref
from repro_torch.kernels.photonic_mvm.ops import mvm_int
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dense_counter(xp, w, stride):
    """The launch counter of the form ``strip.dense_form`` gives the dense
    float conv of ``xp`` [B, Hp, Wp, C_in] by ``w`` [k, k, C_in, C_out]."""
    k = w.shape[0]
    b, hp, wp, ci = xp.shape
    form = strip.dense_form(b, (hp - k) // stride + 1, (wp - k) // stride + 1,
                            ci, w.shape[-1], k, stride)
    return "conv_strip_f64mma" if form == "f64mma" else "conv_strip"


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (8, 400, 120), (2048, 576, 64),
                                   (128, 2304, 256), (37, 101, 53)])
def test_mvm_kernel_bitwise_equal_to_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-15, 16, (m, k), generator=g).to(torch.int8).to(cuda)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8).to(cuda)
    ws = (torch.rand((n,), generator=g) + 0.5).to(cuda)
    reset_launch_counts()
    got = mvm_int(a, w, ws, 0.37)
    assert launch_counts()["photonic_mvm"] == 1
    assert torch.equal(got, mvm_int_ref(a, w, ws, 0.37))


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("m,k,n,route", MVM_EDGES)
def test_mvm_kernel_configs_bitwise_equal_to_plain(cuda, m, k, n, route,
                                                   odd):
    from repro_torch.kernels.photonic_mvm.ops import mvm_config
    assert mvm_config(m, k, n).route == route
    g = torch.Generator().manual_seed(m * 7 + k * 3 + n)
    a = torch.randint(-15, 16, (m, k), generator=g).to(torch.int8).to(cuda)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8).to(cuda)
    if odd:
        a, w = odd_offset(a), odd_offset(w)
        assert a.data_ptr() % 2 == 1 and a.is_contiguous()
    ws = (torch.rand((n,), generator=g) + 0.5).to(cuda)
    reset_launch_counts()
    got = mvm_int(a, w)
    assert launch_counts()["photonic_mvm"] == 1
    assert torch.equal(got, mvm_int_ref(a, w))
    assert torch.equal(mvm_int(a, w, ws, 0.37), mvm_int_ref(a, w, ws, 0.37))


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("m", range(1, 17))
def test_mvm_stream_rows_and_ragged_k_bitwise_equal_to_plain(cuda, m, odd):
    """The weight stream at every M it takes (one and two n8 tiles of
    codes), K not a multiple of a 128-byte box (nor of 4 at odd M: the
    codes by bytes), N = 1,000 (fc3's), the codes one byte past an
    allocation; on laid-out levels as the bound path gives them, and per
    call."""
    from repro_torch.kernels.photonic_mvm.ops import (mvm_config,
                                                      mvm_int_laid,
                                                      mvm_weights)
    k, n = 4096 + 37 * m, 1000
    cfg = mvm_config(m, k, n)
    assert cfg.route == "stream"
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-15, 16, (m, k), generator=g).to(torch.int8).to(cuda)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8).to(cuda)
    if odd:
        a = odd_offset(a)
    ws = (torch.rand((n,), generator=g) + 0.5).to(cuda)
    mw = mvm_weights(w)
    reset_launch_counts()
    got = mvm_int_laid(a, mw, ws, 0.37)
    assert launch_counts()["photonic_mvm"] == 1
    assert torch.equal(got, mvm_int_ref(a, w, ws, 0.37))
    assert torch.equal(mvm_int_laid(a, mw), mvm_int(a, w))
    assert torch.equal(mvm_int(a, w), mvm_int_ref(a, w))


@pytest.mark.parametrize("m,k,n,cfg", [
    (8, 4096, 1000, ("gemm", 16, 64)),
    (16, 4608, 512, ("wgmma", 64, 64)),
    (1568, 4608, 512, ("gemm", 16, 64)),
    (2048, 576, 64, ("gemm", 16, 64)),
    (128, 2304, 256, ("gemm", 16, 64)),
    (8, 4097, 1000, ("stream", 16, 16))],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_every_route_forced_bitwise_equal_to_plain(cuda, m, k, n, cfg):
    """Each route at a shape the rule gives another (the stream's two n8
    tiles at eight rows among them): one launch, bitwise."""
    from repro_torch.kernels.photonic_mvm.ops import (MvmConfig, launch,
                                                      mvm_weights)
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(0, 16, (m, k), generator=g).to(torch.int8).to(cuda)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8).to(cuda)
    ws = (torch.rand((n,), generator=g) + 0.5).to(cuda)
    mw = mvm_weights(w)
    reset_launch_counts()
    got = launch(a, mw, MvmConfig(*cfg), ws, 0.37)
    assert launch_counts()["photonic_mvm"] == 1
    assert torch.equal(got, mvm_int_ref(a, w, ws, 0.37))


@pytest.mark.parametrize("k,n", [(0, 3), (1, 1), (31, 9), (128, 16),
                                 (129, 5), (4608, 20), (300, 1000),
                                 (25088, 70)])
def test_mvm_layout_kernel_bitwise_equal_to_plain(cuda, k, n):
    """The levels' layout on the card (one launch, uncounted) is the plain
    version's: the transpose, the zero pad, from int8 levels, a
    non-contiguous view and float-carried levels."""
    from repro_torch.kernels.photonic_mvm.ops import mvm_weights
    g = torch.Generator().manual_seed(k + n)
    w = torch.randint(-127, 128, (k, 2 * n), generator=g).to(torch.int8)
    for levels in (w[:, :n].contiguous(), w[:, ::2], w[:, :n].float()):
        want = mvm_weights(levels).wt
        reset_launch_counts()
        got = mvm_weights(levels.to(cuda))
        torch.cuda.synchronize()
        assert launch_counts()["photonic_mvm"] == 0
        assert got.wt.is_contiguous() and torch.equal(got.wt.cpu(), want)


def test_mvm_launcher_refuses_a_launch_it_has_no_kernel_for(cuda):
    """No fallback: a configuration the launcher has no kernel for raises
    (the stream route past its rows, a 64 x 128 wgmma tile, a gemm tile
    and a stream width it has no kernel for, a tensor map on K = 100)."""
    from repro_torch.kernels._build import KernelError
    from repro_torch.kernels.photonic_mvm.ops import (MvmConfig, launch,
                                                      mvm_weights)
    g = torch.Generator().manual_seed(2)
    for m, k, cfg in ((9, 256, MvmConfig("stream", 8, 16)),
                      (64, 256, MvmConfig("wgmma", 64, 128)),
                      (64, 256, MvmConfig("gemm", 32, 64)),
                      (8, 4096, MvmConfig("stream", 8, 32)),
                      (64, 100, MvmConfig("wgmma", 64, 64))):
        a = torch.randint(0, 16, (m, k), generator=g).to(torch.int8)
        w = torch.randint(-127, 128, (k, 40), generator=g).to(torch.int8)
        reset_launch_counts()
        with pytest.raises(KernelError):
            launch(a.to(cuda), mvm_weights(w.to(cuda)), cfg)
        assert launch_counts()["photonic_mvm"] == 0


@pytest.mark.parametrize("dw,act,pool,stride", [
    (False, "relu", ("avg", 2), 1), (True, "abs", ("max", 2), 1),
    (False, "sign", None, 2), (True, "none", ("avg", 2), 1)])
def test_chain_kernel_bitwise_equal_to_plain(cuda, dw, act, pool, stride):
    g = torch.Generator().manual_seed(3)
    h, c = 16, 4
    stages, hh, cc = [], h, c
    for j in range(2):
        co = cc if dw else 6
        pads = padtype_to_pads((hh, hh), 3, stride, "SAME")
        geom = dispatch.ChainGeom(f"s{j}", hh, hh, cc, co, 3, stride, pads,
                                  groups=cc if dw else 1, act=act,
                                  pool=pool if j == 0 else None)
        wq = torch.randint(-7, 8, (3, 3, 1 if dw else cc, co), generator=g)
        stages.append((geom, wq.to(torch.int8).to(cuda),
                       (torch.rand((co,), generator=g) * 0.1).to(cuda),
                       torch.randn((co,), generator=g).to(cuda)))
        hh, _ = geom.out_hw()
        cc = co
    codes = torch.randint(0, 16, (3, h, h, c), generator=g).float().to(cuda)
    scale = (torch.rand((3, 1, 1, 1), generator=g) + 0.01).to(cuda)
    reset_launch_counts()
    got = conv_chain(codes, scale, stages, 15.0)
    assert launch_counts()["conv_chain"] == 1
    want = conv_chain_ref(codes, scale, stages, 15.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _chain_matches_plain(codes, scale, stages):
    reset_launch_counts()
    got = conv_chain(codes, scale, stages, 15.0)
    assert launch_counts()["conv_chain"] == 1
    want = conv_chain_ref(codes, scale, stages, 15.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("i", range(len(CHAIN_EDGES)))
def test_chain_kernel_configs_bitwise_equal_to_plain(cuda, i):
    from repro_torch.kernels.conv_bank.fused import chain_config
    b, h, w, c, specs = CHAIN_EDGES[i]
    codes, scale, stages = chain_case(b, h, w, c, specs,
                                      torch.Generator().manual_seed(i), cuda)
    assert chain_config(b, [s[0] for s in stages]).cluster == 8
    _chain_matches_plain(codes, scale, stages)


@pytest.mark.parametrize("i", range(len(CHAINS)))
def test_chain_kernel_chains_both_calibrations_bitwise_equal(cuda, i):
    h, w, c, specs = CHAINS[i]
    codes, scale, stages = chain_case(3, h, w, c, specs,
                                      torch.Generator().manual_seed(i), cuda)
    _chain_matches_plain(codes, scale, stages)
    # per-tensor calibration at batch 1: a 0-d incoming scale
    _chain_matches_plain(codes[:1], scale[0, 0, 0, 0], stages)


def test_chain_kernel_refuses_frames_beyond_shared_memory(cuda):
    geom = dispatch.ChainGeom("big", 256, 256, 3, 8, 3, 1, ((1, 1), (1, 1)))
    stage = (geom, torch.ones((3, 3, 3, 8), device=cuda),
             torch.ones((8,), device=cuda), None)
    with pytest.raises(ValueError, match="shared memory"):
        conv_chain(torch.zeros((1, 256, 256, 3), device=cuda),
                   torch.ones((1, 1, 1, 1), device=cuda), [stage], 15.0)


@pytest.mark.parametrize("shape,pool,gray", [
    ((8, 32, 32, 3), 2, True), ((8, 32, 32, 3), 4, True),
    ((4, 28, 28, 1), 2, True), ((4, 28, 28, 1), 2, False),
    ((2, 16, 24, 3), 2, False)])
def test_ca_kernel_bitwise_equal_to_plain(cuda, shape, pool, gray):
    g = torch.Generator().manual_seed(5)
    img = torch.rand(shape, generator=g).to(cuda)
    reset_launch_counts()
    got = acquire(img, pool, gray)
    assert launch_counts()["ca_pool"] == 1
    assert torch.equal(got, compressive_acquire(img, pool, gray))


@pytest.mark.parametrize("b,h,w,c,p,gray,odd,route", CA_EDGES)
def test_ca_kernel_configs_bitwise_equal_to_plain(cuda, b, h, w, c, p, gray,
                                                  odd, route):
    g = torch.Generator().manual_seed(b + h + w + c + p)
    img = torch.rand((b, h, w, c), generator=g).to(cuda)
    if odd:                       # 4 bytes past an allocation
        img = odd_offset(img)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ca_config(b, h, w, c, p, gray, sms, not odd).route == route
    reset_launch_counts()
    got = acquire(img, p, gray)
    assert launch_counts()["ca_pool"] == 1
    assert torch.equal(got, compressive_acquire(img, p, gray))


@pytest.mark.parametrize("b,h,w,c,p,gray,odd,route",
                         [e for e in CA_EDGES if e[5]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ca_pool_custom_coefficients_bitwise_equal_to_plain(
        cuda, b, h, w, c, p, gray, odd, route, dtype):
    """The public op with a signed bank of its own on every weighted
    route's edges, at ``odd_offset`` too; bfloat16 widened, summed in
    float32 and rounded once."""
    g = torch.Generator().manual_seed(b + h + w + c + p + 1)
    img = torch.rand((b, h, w, c), generator=g).to(cuda, getattr(torch,
                                                                dtype))
    img = odd_offset(img) if odd else img
    coeffs = (torch.rand((p, p, c), generator=g) - 0.5).to(cuda)
    reset_launch_counts()
    got = ca_pool(img, p, coeffs=coeffs)
    assert launch_counts()["ca_pool"] == 1
    assert got.dtype == img.dtype
    want = ca_pool_ref_generic(img, coeffs, p).to(img.dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,ci,co,k,stride,strip_h,n_strips", [
    (8, 256, 256, 1, 1, 5, 1, 256, 1),        # unsharp_mask at bucket 8
    (8, 256, 256, 4, 1, 3, 1, 256, 1),        # compress_recon_deconv's rec2
    (2, 56, 56, 64, 128, 3, 1, 28, 2),        # a VGG16-like layer
    (3, 31, 29, 3, 5, 3, 2, 5, 3),            # stride 2, ragged tiles
    (1, 40, 40, 2, 16, 11, 4, 8, 1)])         # k 11 stride 4 (opt-in smem)
def test_strip_kernel_bitwise_equal_to_plain(cuda, b, h, w, ci, co, k,
                                             stride, strip_h, n_strips):
    g = torch.Generator().manual_seed(h + w + k)
    xp = torch.randint(0, 16, (b, (n_strips * strip_h - 1) * stride + k,
                               w, ci), generator=g).float().to(cuda)
    wq = torch.randint(-7, 8, (k, k, ci, co), generator=g).float().to(cuda)
    ws = (torch.rand((co,), generator=g) + 0.5).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    reset_launch_counts()
    got = strip.conv_strip(xp, wq, stride=stride, strip_h=strip_h)
    assert launch_counts()[_dense_counter(xp, wq, stride)] == 1
    assert torch.equal(got, strip.conv_strip_ref(xp, wq, stride=stride,
                                                 strip_h=strip_h))
    kw = dict(stride=stride, strip_h=strip_h, act_scale=0.37, act="relu",
              bias=bias)
    assert torch.equal(strip.conv_strip(xp, wq, ws, **kw),
                       strip.conv_strip_ref(xp, wq, ws, **kw))


@pytest.mark.parametrize("b,h_out,w_out,ci,co,k,stride", STRIP_EDGES)
def test_strip_kernel_configs_bitwise_equal_to_plain(cuda, b, h_out, w_out,
                                                     ci, co, k, stride):
    """``strip_config``'s edges on the CUDA-core form, forced (the rule
    gives the two from 8 channels the tensor-core form: its own edges are
    ``F64MMA_EDGES``)."""
    cfg = strip.strip_config(b, h_out, w_out, ci, co, k, stride)
    assert cfg.k_inst == (k if stride == 1 and k in (3, 5, 7) else 0)
    if ci == 40:
        assert cfg.cc < ci and cfg.stages == 2
    g = torch.Generator().manual_seed(b + h_out + w_out + ci + co + k)
    xp = torch.randint(0, 16, (b, (h_out - 1) * stride + k,
                               (w_out - 1) * stride + k, ci),
                       generator=g).float().to(cuda)
    wq = torch.randint(-127, 128, (k, k, ci, co), generator=g).float() \
        .to(cuda)
    ws = (torch.rand((co,), generator=g) + 0.5).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    kw = dict(stride=stride, strip_h=h_out)
    reset_launch_counts()
    got = strip.conv_strip(xp, wq, form="fma", **kw)
    assert launch_counts()["conv_strip"] == 1
    assert torch.equal(got, strip.conv_strip_ref(xp, wq, **kw))
    for act in ("none", "relu", "abs", "sign"):
        e = dict(kw, act_scale=0.37, act=act, bias=bias)
        assert torch.equal(strip.conv_strip(xp, wq, ws, form="fma", **e),
                           strip.conv_strip_ref(xp, wq, ws, **e)), act
    e = dict(kw, act_scale=0.37)                       # ws, no bias
    assert torch.equal(strip.conv_strip(xp, wq, ws, form="fma", **e),
                       strip.conv_strip_ref(xp, wq, ws, **e))


@pytest.mark.parametrize("b,h,c,k,stride,strip_h,n_strips", [
    (8, 256, 3, 5, 1, 256, 1), (8, 256, 3, 3, 1, 256, 1),
    (2, 512, 3, 5, 1, 256, 2), (2, 37, 20, 3, 2, 6, 3)])
def test_depthwise_strip_kernel_bitwise_equal_to_plain(cuda, b, h, c, k,
                                                       stride, strip_h,
                                                       n_strips):
    g = torch.Generator().manual_seed(h + c + k)
    xp = torch.randint(0, 16, (b, (n_strips * strip_h - 1) * stride + k,
                               h + k - 1, c), generator=g).float().to(cuda)
    taps = torch.randint(-7, 8, (k * k, c), generator=g).float().to(cuda)
    ws = (torch.rand((c,), generator=g) + 0.5).to(cuda)
    reset_launch_counts()
    got = strip.conv_strip_depthwise(xp, taps, stride=stride,
                                     strip_h=strip_h)
    assert launch_counts()["conv_strip_depthwise"] == 1
    assert torch.equal(got, strip.conv_strip_depthwise_ref(
        xp, taps, stride=stride, strip_h=strip_h))
    kw = dict(stride=stride, strip_h=strip_h, act_scale=0.11, act="abs")
    assert torch.equal(strip.conv_strip_depthwise(xp, taps, ws, **kw),
                       strip.conv_strip_depthwise_ref(xp, taps, ws, **kw))


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("b,h_out,w_out,c,k,stride", DW_EDGES)
def test_depthwise_kernel_configs_bitwise_equal_to_plain(cuda, b, h_out,
                                                         w_out, c, k, stride,
                                                         odd):
    cfg = strip.dw_config(b, h_out, w_out, c, k, stride)
    assert cfg.k_inst == (k if stride == 1 and k in (3, 5, 7) else 0)
    g = torch.Generator().manual_seed(b + h_out + w_out + c + k)
    xp = torch.randint(0, 16, (b, (h_out - 1) * stride + k,
                               (w_out - 1) * stride + k, c),
                       generator=g).float().to(cuda)
    if odd:                       # 4 bytes past an allocation
        xp = odd_offset(xp)
    taps = torch.randint(-127, 128, (k * k, c), generator=g).float().to(cuda)
    ws = (torch.rand((c,), generator=g) + 0.5).to(cuda)
    bias = torch.randn((c,), generator=g).to(cuda)
    kw = dict(stride=stride, strip_h=h_out)
    reset_launch_counts()
    got = strip.conv_strip_depthwise(xp, taps, **kw)
    assert launch_counts()["conv_strip_depthwise"] == 1
    assert torch.equal(got, strip.conv_strip_depthwise_ref(xp, taps, **kw))
    for act in ("none", "relu", "abs", "sign"):
        e = dict(kw, act_scale=0.37, act=act, bias=bias)
        assert torch.equal(strip.conv_strip_depthwise(xp, taps, ws, **e),
                           strip.conv_strip_depthwise_ref(xp, taps, ws, **e))


@pytest.mark.parametrize("strategy", ["resident", "strip"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_conv_bank_kernels_bitwise_equal_to_plain(cuda, k, strategy):
    g = torch.Generator().manual_seed(k)
    x = torch.rand((2, 33, 30, 8), generator=g).to(cuda)
    w = (torch.randn((k, k, 8, 16), generator=g) * 0.2).to(cuda)
    bias = (torch.randn((16,), generator=g) * 0.1).to(cuda)
    kw = dict(spec=W4A4, strategy=strategy, act="relu", bias=bias)
    reset_launch_counts()
    got = conv_bank(x, w, **kw)
    counts = launch_counts()
    # 8 -> 16 channels: the float route, on the tensor-core form
    assert strip.dense_route(8, 16, k, 1) == "float"
    assert counts["conv_strip_f64mma"] == 1
    assert counts["conv_bank"] == counts["conv_strip"] == 0
    assert torch.equal(got, conv_bank_plain(x, w, **kw))
    # float mode: float64 products summed in the kernel's own order
    torch.testing.assert_close(conv_bank(x, w, strategy=strategy),
                               conv_bank_plain(x, w, strategy=strategy),
                               rtol=1e-5, atol=1e-5)


def _f64mma_entries():
    for b in (8, 1):
        for _, h, w, ci, co, k in CONV_BANK_CALLS:
            yield (b, h, w, ci, co, k)
    yield from F64MMA_EDGES


@pytest.mark.parametrize("b,h_out,w_out,ci,co,k", list(_f64mma_entries()))
def test_f64mma_edges_bitwise_equal_to_plain(cuda, b, h_out, w_out, ci, co,
                                             k):
    """The dense float kernel's tensor-core form at the conv_bank op's
    calls (batches 8 and 1) and its edges, every launch of
    ``strip.f64mma_launches`` forced: bitwise its plain version on integer
    operands (codes 0..255, levels +-127) raw, at every activation with
    and without bias and with ws alone; within 1e-5 on float operands;
    each launch counted on its own counter. The rule's launch through
    ``conv_strip`` too."""
    g = torch.Generator().manual_seed(b + h_out + w_out + ci + co + k)
    shape = (b, h_out + k - 1, w_out + k - 1, ci)
    xq = torch.randint(0, 256, shape, generator=g).float().to(cuda)
    wq = torch.randint(-127, 128, (k, k, ci, co), generator=g).float() \
        .to(cuda)
    xf = torch.rand(shape, generator=g).to(cuda)
    wf = (torch.randn((k, k, ci, co), generator=g) * 0.2).to(cuda)
    ws = (torch.rand((co,), generator=g) + 0.5).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    kw = dict(stride=1, strip_h=h_out)
    raw = strip.conv_strip_ref(xq, wq, **kw)
    launches = strip.f64mma_launches(b, h_out, w_out, ci, co, k, 1)
    assert strip.dense_config(b, h_out, w_out, ci, co, k, 1) in launches
    for cfg in launches:
        def run(x, w, ws=None, act_scale=1.0, act="none", bias=None,
                cfg=cfg):
            return strip.launch(x, w, ws, bias, act_scale, act, 1, False,
                                strip.LAUNCHES, cfg=cfg)
        reset_launch_counts()
        assert torch.equal(run(xq, wq), raw), cfg
        assert launch_counts()["conv_strip_f64mma"] == 1
        assert launch_counts()["conv_strip"] == 0
        for act in ("none", "relu", "abs", "sign"):
            for bb in (bias, None):
                e = dict(act_scale=0.37, act=act, bias=bb)
                assert torch.equal(run(xq, wq, ws, **e), strip.conv_strip_ref(
                    xq, wq, ws, **kw, **e)), (cfg, act, bb is None)
        torch.testing.assert_close(run(xf, wf), strip.conv_strip_ref(
            xf, wf, **kw), rtol=1e-5, atol=1e-5)
    reset_launch_counts()
    assert torch.equal(strip.conv_strip(xq, wq, **kw), raw)
    assert launch_counts()["conv_strip_f64mma"] == 1
    # the same operands a float past an allocation: 4-byte copies only
    assert torch.equal(strip.conv_strip(odd_offset(xq), odd_offset(wq), **kw),
                       raw)


@pytest.mark.parametrize("strategy", ["resident", "strip"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_conv_bank_float_mode_on_the_tensor_cores(cuda, k, strategy):
    """The public op without a spec at its own calls (16 -> 32 channels,
    32 x 32 at batch 8): one launch of the tensor-core form in either
    strategy, none of the CUDA-core form, within 1e-5 of the plain
    version; the narrow call keeps the CUDA-core form."""
    g = torch.Generator().manual_seed(30 + k)
    x = torch.rand((8, 32, 32, 16), generator=g).to(cuda)
    w = (torch.randn((k, k, 16, 32), generator=g) * 0.2).to(cuda)
    reset_launch_counts()
    got = conv_bank(x, w, strategy=strategy)
    counts = launch_counts()
    assert counts["conv_strip_f64mma"] == 1
    assert counts["conv_bank"] == counts["conv_strip"] == 0
    torch.testing.assert_close(got, conv_bank_plain(x, w, strategy=strategy),
                               rtol=1e-5, atol=1e-5)
    for b, h, ww, ci, co, kk in CONV_BANK_NARROW:
        x = torch.rand((b, h, ww, ci), generator=g).to(cuda)
        w = (torch.randn((kk, kk, ci, co), generator=g) * 0.2).to(cuda)
        reset_launch_counts()
        got = conv_bank(x, w, strategy=strategy)
        assert launch_counts()["conv_strip_f64mma"] == 0
        assert launch_counts()["conv_bank" if strategy == "resident"
                               else "conv_strip"] == 1
        torch.testing.assert_close(
            got, conv_bank_plain(x, w, strategy=strategy), rtol=1e-5,
            atol=1e-5)


@pytest.mark.parametrize("name", ["unsharp_mask", "denoise_gauss",
                                  "compress_recon_deconv"])
def test_pipeline_served_on_card_equals_batch1_and_cpu(cuda, name):
    prog = Program.from_pipeline(name, 64, 64)
    f = np.random.default_rng(3).random((5, 64, 64, 3)).astype(np.float32)
    opts = Options(device="cuda", conv_vmem_budget=64 << 10)
    exe = prog.compile(opts)
    assert any(s.strategy.kind == "strip" for s in exe.plan.steps
               if hasattr(s, "strategy"))
    reset_launch_counts()
    padded = exe.run_padded(f, 8).cpu().numpy()
    assert launch_counts()["conv_strip" if name != "denoise_gauss"
                           else "conv_strip_depthwise"] > 0
    singles = np.concatenate([exe.run_per_frame(f[i:i + 1]).cpu().numpy()
                              for i in range(5)])
    np.testing.assert_array_equal(padded, singles)
    cpu = prog.compile(dataclasses.replace(opts, device="cpu"))
    np.testing.assert_array_equal(padded, cpu.run_per_frame(f).numpy())


def test_pipeline_through_server_on_card_equals_batch1(cuda):
    prog = Program.from_pipeline("unsharp_mask", 256, 256)
    server = serve.Server(serve.ServeConfig(max_batch=8, max_wait_ms=2.0,
                                            batch_buckets=(1, 2, 4, 8)))
    server.register("unsharp_mask", prog)
    server.start()
    rng = np.random.default_rng(4)
    reqs = [rng.random((n, 256, 256, 3)).astype(np.float32)
            for n in (1, 3, 2)]
    try:
        reset_launch_counts()
        outs = [f.result(timeout=120) for f in
                [server.submit("unsharp_mask", r) for r in reqs]]
        assert launch_counts()["conv_strip"] > 0
    finally:
        server.stop()
    exe = prog.compile(Options())
    for frames, out in zip(reqs, outs):
        singles = np.concatenate([exe.run_per_frame(frames[i:i + 1]).cpu()
                                  .numpy() for i in range(len(frames))])
        np.testing.assert_array_equal(np.asarray(out), singles)


@pytest.mark.parametrize("name", ["lenet", "vgg9"])
def test_model_on_card_equals_cpu_and_reference(cuda, name):
    prog = Program.from_model(name, torch.Generator().manual_seed(1))
    hwc = prog.input_hwc
    f = np.random.default_rng(2).random((5, *hwc)).astype(np.float32)
    cpu = prog.compile(Options(device="cpu")).run_per_frame(f).numpy()
    reset_launch_counts()
    card = prog.compile(Options(device="cuda")).run_per_frame(f)
    counts = launch_counts()
    assert counts["photonic_mvm"] > 0
    assert counts["conv_chain" if name == "lenet" else "ca_pool"] == 1
    np.testing.assert_array_equal(card.cpu().numpy(), cpu)
    ref = prog.compile(Options(device="cuda", backend="reference"))
    np.testing.assert_array_equal(ref.run_per_frame(f).cpu().numpy(), cpu)
    np.testing.assert_array_equal(ref.run(f).cpu().numpy(),
                                  prog.compile(Options(device="cpu"))
                                  .run(f).numpy())


# -- bound views: pinned staging ring + one CUDA graph per bucket -------------

SERVED = ("lenet", "vgg9", "compress_recon", "compress_recon_deconv",
          "denoise_box", "denoise_gauss", "edge_detect", "prewitt_edge",
          "sharpen", "unsharp_mask", "chain")


def _served_program(name):
    if name in ("lenet", "vgg9"):
        return Program.from_model(name, torch.Generator().manual_seed(3))
    if name == "chain":
        return (Program.from_pipeline("denoise_gauss", 256, 256, 3)
                .then(Program.from_pipeline("edge_detect", 256, 256, 3))
                .then(Program.from_pipeline("sharpen", 256, 256, 1)))
    return Program.from_pipeline(name, 256, 256, 3)


@pytest.fixture(scope="module")
def bound_views():
    """(program, unbound executable, bound view) per served program, on the
    card, made once per module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = {}
    for name in SERVED:
        prog = _served_program(name)
        exe = prog.compile(Options(scheme=W4A4))
        out[name] = (prog, exe, exe.bind("cuda", staging_slots=2))
    return out


def _frames_for(prog, n, seed):
    f = np.random.default_rng(seed).random(
        (n, *prog.input_hwc)).astype(np.float32)
    f[::2] *= 0.1
    return f


@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
@pytest.mark.parametrize("name", SERVED)
def test_bound_graph_replay_bitwise_equal_to_eager(bound_views, name, bucket):
    prog, exe, bound = bound_views[name]
    f = _frames_for(prog, max(bucket - 1, 1), bucket)
    got = np.asarray(bound.run_padded(f, bucket))
    assert bucket in bound._binding.graphs          # replayed, not eager
    want = np.concatenate([exe.run_per_frame(f[i:i + 1]).cpu().numpy()
                           for i in range(len(f))])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["lenet", "edge_detect", "chain"])
def test_three_pipelined_batches_give_their_own_answers(bound_views, name):
    """Three batches of different content at one bucket, none waited on
    until all three are enqueued: the static output is overwritten and a
    staging slot reused before the first answer is read."""
    prog, exe, bound = bound_views[name]
    batches = [_frames_for(prog, 4, 40 + i) for i in range(3)]
    pending = [bound.run_padded(f, 4) for f in batches]
    outs = [np.asarray(p) for p in pending]
    for f, out in zip(batches, outs):
        np.testing.assert_array_equal(out, exe.run_per_frame(f).cpu().numpy())
    assert not np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("name", ["lenet", "vgg9", "unsharp_mask", "chain"])
def test_replays_credit_the_captures_launch_counts(bound_views, name):
    prog, _, bound = bound_views[name]
    f = _frames_for(prog, 8, 5)
    bound.run_padded(f, 8).wait()                    # captured before
    tally = bound._binding.graphs[8].launches
    assert sum(tally.values()) > 0
    reset_launch_counts()
    for _ in range(3):
        bound.run_padded(f, 8)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == {k: 3 * tally.get(k, 0) for k in counts}


def test_bound_view_on_cuda_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    exe = Program.from_model("lenet").compile(Options(device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exe.bind("cuda")


# -- observability on the bound path ------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "edge_detect", "chain"])
def test_bound_replay_bitwise_with_a_trace_and_without_the_recorder(
        bound_views, name):
    from repro_torch import obs
    prog, exe, bound = bound_views[name]
    f = _frames_for(prog, 3, 60)
    want = np.concatenate([exe.run_per_frame(f[i:i + 1]).cpu().numpy()
                           for i in range(len(f))])
    trace = obs.enable()
    try:
        traced = np.asarray(bound.run_padded(f, 4))
    finally:
        obs.disable()
    prev = obs.uninstall()
    try:
        bare = np.asarray(bound.run_padded(f, 4))
    finally:
        obs.install(prev)
    assert 4 in bound._binding.graphs
    np.testing.assert_array_equal(traced, want)
    np.testing.assert_array_equal(bare, want)


def _dispatch_counts():
    from repro_torch import obs
    return {k: v for k, v in obs.REGISTRY.snapshot().items()
            if k.startswith("dispatch.")}


@pytest.mark.parametrize("name,per_bucket", [
    ("lenet", {"dispatch.conv.fused": 2}),
    ("edge_detect", {"dispatch.conv.resident": 2})])
def test_trace_time_counters_tick_once_per_bucket(cuda, name, per_bucket):
    """A fresh plan's bound view: the eager run before each capture is the
    bucket's trace family's first run and counts; the capture and every
    replay count nothing."""
    prog = _served_program(name)
    view = prog.compile(Options(scheme=W4A4, act_sram_kb=251.0)).bind(cuda)
    buckets = (1, 2, 4, 8)
    before = _dispatch_counts()
    view.warm(buckets)
    f = _frames_for(prog, 8, 7)
    for _ in range(5):
        for b in buckets:
            view.run_padded(f[:b], b)
    torch.cuda.synchronize()
    after = _dispatch_counts()
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    assert delta == {k: len(buckets) * v for k, v in per_bucket.items()}
    assert all(g.replays >= 5 for g in view._binding.graphs.values())


def test_readiness_turns_ready_only_after_every_capture(cuda):
    lenet = _served_program("lenet")
    server = serve.Server(serve.ServeConfig(max_batch=8, batch_buckets=(1, 8)))
    hosted = server.register("lenet", lenet, Options(scheme=W4A4))
    server.start(warm=True)
    try:
        assert server.readiness()["ready"]
        graphs = hosted.bound[0]._binding.graphs
        assert set(graphs) == {1, 8}
        del graphs[8]                     # as if bucket 8 were never captured
        r = server.readiness()
        assert not r["ready"] and not r["checks"]["warmed"]
        hosted.bound[0].warm((8,))
        assert server.readiness()["ready"]
    finally:
        server.stop()


def test_flight_dump_after_graph_replays_passes_flight_check(cuda,
                                                              tmp_path):
    import importlib.util
    import json
    from pathlib import Path
    from repro_torch import obs
    spec = importlib.util.spec_from_file_location(
        "check_trace",
        Path(__file__).resolve().parents[1] / "scripts" / "check_trace.py")
    check_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_trace)
    prev = obs.get_flight()
    recorder = obs.install(obs.FlightRecorder(capacity=256))
    try:
        edge = _served_program("edge_detect")
        server = serve.Server(serve.ServeConfig(max_batch=8))
        server.register("edge", edge, Options(scheme=W4A4))
        server.start()
        try:
            futs = [server.submit("edge", _frames_for(edge, n, n))
                    for n in (1, 3, 8, 2)]
            for fut in futs:
                fut.result(timeout=120)
            assert server._flight_dump("after_replays") is not None
        finally:
            server.stop()
        graphs = server._programs["edge"].bound[0]._binding.graphs
        assert sum(g.replays for g in graphs.values()) >= 4
        dump = recorder.dump(reason="unit")
    finally:
        obs.install(prev)
    names = {e["name"] for e in dump["traceEvents"]}
    assert {"serve.device.execute", "serve.request.device"} <= names
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump))
    assert check_trace.flight_check(str(path)) == []
    (kept,) = server.flight_dumps()
    path.write_text(json.dumps(kept["dump"]))
    assert check_trace.flight_check(str(path), require_trigger=True) == []


# -- VGG16 at 224x224x3 and the plan verifier ---------------------------------

@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("kernel,shape", [
    (k, s) for k in ("conv_strip", "photonic_mvm") for s in VGG16_SHAPES[k]],
    ids=lambda v: v if isinstance(v, str) else v[0])
def test_vgg16_shapes_bitwise_equal_to_plain(cuda, kernel, shape, batch):
    gen = torch.Generator(device=cuda).manual_seed(batch + len(shape[0]))
    args = vgg16_case(kernel, shape, batch, gen, cuda)
    reset_launch_counts()
    if kernel == "conv_strip":
        xp, w, stride, sh = args
        kw = dict(stride=stride, strip_h=sh)
        got = strip.conv_strip(xp, w, **kw)
        assert launch_counts()[_dense_counter(xp, w, stride)] == 1
        assert got.shape == (batch, shape[1], shape[3], shape[5])
        assert torch.equal(got, strip.conv_strip_ref(xp, w, **kw))
        ws = torch.rand((w.shape[-1],), generator=gen, device=cuda) + 0.5
        bias = torch.randn((w.shape[-1],), generator=gen, device=cuda)
        kw.update(act_scale=0.37, act="relu", bias=bias)
        assert torch.equal(strip.conv_strip(xp, w, ws, **kw),
                           strip.conv_strip_ref(xp, w, ws, **kw))
    else:
        a, wq = args
        got = mvm_int(a, wq)
        assert launch_counts()["photonic_mvm"] == 1
        assert torch.equal(got, mvm_int_ref(a, wq))
        ws = torch.rand((wq.shape[1],), generator=gen, device=cuda) + 0.5
        assert torch.equal(mvm_int(a, wq, ws, 0.37),
                           mvm_int_ref(a, wq, ws, 0.37))


def _strip_int_case(gen, device, b, h_out, w_out, ci, co, k, stride,
                    codes=256, levels=127):
    """u8 codes [b, Hp, Wp, ci] in 0..codes-1 and s8 levels [k, k, ci, co]
    in -levels..levels, with ws and bias, random from ``gen``."""
    xp = torch.randint(0, codes, (b, (h_out - 1) * stride + k,
                                  (w_out - 1) * stride + k, ci),
                       generator=gen, device=device).to(torch.uint8)
    w = torch.randint(-levels, levels + 1, (k, k, ci, co), generator=gen,
                      device=device).to(torch.int8)
    ws = torch.rand((co,), generator=gen, device=device) + 0.5
    bias = torch.randn((co,), generator=gen, device=device)
    return xp, w, ws, bias


def _check_strip_int(xp, w, ws, bias, stride):
    """The int8 kernel bitwise its plain version: raw (one launch
    counted), at every activation with ws and bias, and with ws alone."""
    reset_launch_counts()
    got = strip.conv_strip_int(xp, w, stride=stride)
    assert launch_counts()["conv_strip_int"] == 1
    assert launch_counts()["conv_strip"] == 0
    assert torch.equal(got, strip.conv_strip_int_ref(xp, w, stride=stride))
    for act in ("none", "relu", "abs", "sign"):
        e = dict(stride=stride, act_scale=0.37, act=act, bias=bias)
        assert torch.equal(strip.conv_strip_int(xp, w, ws, **e),
                           strip.conv_strip_int_ref(xp, w, ws, **e)), act
    e = dict(stride=stride, act_scale=0.37)
    assert torch.equal(strip.conv_strip_int(xp, w, ws, **e),
                       strip.conv_strip_int_ref(xp, w, ws, **e))


@pytest.mark.parametrize("b,h_out,w_out,ci,co,k,stride", STRIP_EDGES)
def test_strip_int_kernel_configs_bitwise_equal_to_plain(cuda, b, h_out,
                                                         w_out, ci, co, k,
                                                         stride):
    gen = torch.Generator(device=cuda).manual_seed(b + h_out + ci + k)
    _check_strip_int(*_strip_int_case(gen, cuda, b, h_out, w_out, ci, co, k,
                                      stride), stride)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", VGG16_SHAPES["conv_strip"],
                         ids=lambda v: v[0])
def test_strip_int_vgg16_shapes_bitwise_equal_to_plain(cuda, shape, batch):
    """conv1-conv10 as the int route launches them: over the conv's own
    rows, W4A4's codes and levels."""
    _, _, _, w_out, ci, co, k, stride = shape
    gen = torch.Generator(device=cuda).manual_seed(batch + ci + co)
    _check_strip_int(*_strip_int_case(gen, cuda, batch, w_out, w_out, ci,
                                      co, k, stride, codes=16, levels=7),
                     stride)


@pytest.mark.parametrize("ci,co,level", [(512, 64, 127), (512, 64, -127),
                                         (3, 64, 127), (496, 33, -127)])
def test_strip_int_kernel_extremes_bitwise_equal_to_plain(cuda, ci, co,
                                                          level):
    """Codes 255 and levels +-127 everywhere: |acc| up to 255 * 127 * 9 *
    512 = 1.49e8, past float32's exact 2^24, rounded once like the plain
    version's float64 sum; and mixed signs around it."""
    xp = torch.full((2, 30, 30, ci), 255, dtype=torch.uint8, device=cuda)
    w = torch.full((3, 3, ci, co), level, dtype=torch.int8, device=cuda)
    w[1, 1, :, ::2] = -level
    gen = torch.Generator(device=cuda).manual_seed(ci + co)
    ws = torch.rand((co,), generator=gen, device=cuda) + 0.5
    bias = torch.randn((co,), generator=gen, device=cuda)
    _check_strip_int(xp, w, ws, bias, 1)
    # the odd channels' taps all share the level's sign: |acc| = 255 * 127
    # * 9 * ci exactly (1.49e8 at 512 channels, past 2^24)
    assert strip.conv_strip_int(xp, w).abs().max() == 255 * 127 * 9 * ci


@pytest.mark.parametrize("b,h_out,w_out,ci,co,k", INT_WGMMA_EDGES)
def test_strip_int_wgmma_edges_bitwise_equal_to_plain(cuda, b, h_out, w_out,
                                                      ci, co, k):
    """The wgmma form at its edges, forced (the rule gives the narrower
    ones the mma.sync form): raw, every act with and without bias, ws
    alone, and the folded store (y and each CTA's max) under both
    calibrations; the int32 edge (C_in 7,360) at codes 255 and levels
    +-127, |acc| exactly 255 * 127 * 9 * 7,360 = 2,145,196,800. Where the
    rule gives the shape the wgmma form, the path's calls too."""
    cfg = strip.igemm_config(b, h_out, w_out, ci, co, k, 1, form="wgmma")
    gen = torch.Generator(device=cuda).manual_seed(b + h_out + ci + co + k)
    xp, w, ws, bias = _strip_int_case(gen, cuda, b, h_out, w_out, ci, co,
                                      k, 1)
    if ci == 7360:
        xp.fill_(255)
        w.fill_(127)
        w[1, 1, :, ::2] = -127
    want = strip.conv_strip_int_ref(xp, w)
    iw = strip.int_weights(w, form="wgmma")
    reset_launch_counts()
    got = strip.launch_int(xp, iw, 1.0, "none", 1, cfg=cfg)
    assert launch_counts()["conv_strip_int"] == 1
    assert torch.equal(got, want)
    if ci == 7360:
        assert got.abs().max() == 255 * 127 * 9 * ci
    for act in ("none", "relu", "abs", "sign"):
        for bb in (bias, None):
            assert torch.equal(strip.launch_int(
                xp, strip.int_weights(w, ws, bb, form="wgmma"), 0.37, act,
                1, cfg=cfg), strip.conv_strip_int_ref(
                    xp, w, ws, act_scale=0.37, act=act, bias=bb)), act
    for per_frame in (True, False):
        s = torch.rand((b, 1, 1, 1), generator=gen, device=cuda) * 0.01 \
            + 1e-3
        fold = strip.Fold(s if per_frame else s.reshape(-1)[0], ws * 0.1,
                          bias, "relu")
        y, partials = strip.launch_int(xp, iw, 1.0, "none", 1, fold, cfg=cfg)
        wy, wp = strip.fold_ref(want, fold, cfg)
        assert torch.equal(y, wy) and torch.equal(partials, wp)
    if strip.int_form(ci, co, k, 1) == "wgmma":
        _check_strip_int(xp, w, ws, bias, 1)
        for per_frame in (True, False):
            _check_fold(*_fold_case(gen, cuda, b, h_out, w_out, ci, co, k,
                                    1, per_frame), 1, per_frame)


@pytest.mark.parametrize("form", ["wgmma", "mma"])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", INT_FORM_SHAPES, ids=lambda v: v[0])
def test_strip_int_forms_forced_bitwise_equal_to_plain(cuda, shape, batch,
                                                       form):
    """VGG16's conv2-conv10, conv11-13 (off the int8 route) and the
    conv_bank op's calls through either form, on the levels laid out for
    it, raw and with the folded store, on W4A4's codes."""
    _, h, ci, co, k = shape
    gen = torch.Generator(device=cuda).manual_seed(batch + ci + co)
    xp, w, ws, bias = _strip_int_case(gen, cuda, batch, h, h, ci, co, k, 1,
                                      codes=16, levels=7)
    cfg = strip.igemm_config(batch, h, h, ci, co, k, 1, form=form)
    assert cfg.form == form
    iw = strip.int_weights(w, form=form)
    want = strip.conv_strip_int_ref(xp, w)
    reset_launch_counts()
    assert torch.equal(strip.launch_int(xp, iw, 1.0, "none", 1, cfg=cfg),
                       want)
    assert launch_counts()["conv_strip_int"] == 1
    fold = strip.Fold(torch.rand((batch, 1, 1, 1), generator=gen,
                                 device=cuda) * 0.01 + 1e-3, ws * 0.1,
                      bias, "relu")
    y, partials = strip.launch_int(xp, iw, 1.0, "none", 1, fold, cfg=cfg)
    wy, wp = strip.fold_ref(want, fold, cfg)
    assert torch.equal(y, wy) and torch.equal(partials, wp)


def test_strip_int_wgmma_refuses_codes_off_a_16_byte_boundary(cuda):
    x = torch.zeros((1, 10, 10, 64), dtype=torch.uint8, device=cuda)
    odd = odd_offset(x)
    w = torch.zeros((3, 3, 64, 64), dtype=torch.int8, device=cuda)
    assert strip.igemm_config(1, 8, 8, 64, 64, 3, 1).form == "wgmma"
    with pytest.raises(ValueError, match="16-byte boundary"):
        strip.conv_strip_int(odd, w)
    assert torch.equal(strip.conv_strip_int(x, w),
                       strip.conv_strip_int_ref(x, w))


@pytest.mark.parametrize("name,x,w,stride,padding,groups", [
    ("vgg16_like", (2, 56, 56, 64), (3, 3, 64, 128), 1, "SAME", 1),
    ("conv1_like", (2, 40, 40, 3), (3, 3, 3, 64), 1, "SAME", 1),
    ("stride2_valid", (2, 65, 63, 32), (3, 3, 32, 16), 2, "VALID", 1),
    ("groups2", (2, 40, 40, 32), (3, 3, 16, 24), 1, "SAME", 2)])
def test_conv_int_int_route_on_card_equals_float_route(cuda, name, x, w,
                                                       stride, padding,
                                                       groups):
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    codes = torch.randint(0, 16, x, generator=gen, device=cuda).float()
    wq = torch.randint(-7, 8, w, generator=gen, device=cuda).float()
    pads = padtype_to_pads(x[1:3], w[0], stride, padding)
    args = (codes, wq, stride, pads, groups)
    assert dispatch.select_strip_route(x[-1], w[-1], w[0], stride,
                                       groups) == "int"
    reset_launch_counts()
    got = dispatch.conv_int(*args, strategy=dispatch.ConvStrategy(
        "strip", 8, -(-x[1] // 8)), route="int")
    assert launch_counts()["conv_strip_int"] == groups
    assert launch_counts()["conv_strip"] == 0
    assert torch.equal(got, dispatch.conv_int(*args, backend="reference"))


def _vgg16_program():
    from repro_torch.models.vision import init_vision, vgg16_ir
    layers = tuple(vgg16_ir())
    return Program(layers, init_vision(torch.Generator().manual_seed(4),
                                       layers), (224, 224, 3), name="vgg16")


@pytest.mark.parametrize("per_frame,batch", [(True, 3), (False, 3),
                                             (False, 1)])
def test_int_route_conv_after_a_fused_segment_bitwise(cuda, per_frame,
                                                      batch):
    # conv1-conv2 fuse, conv3 runs on the int route: where the chain ran it
    # takes the chain's float codes, else conv2's epilogue operand
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.accelerator import ConvSpec, DenseSpec, FlattenSpec
    from repro_torch.models.vision import init_vision
    layers = (ConvSpec("conv1", 3, 16),
              ConvSpec("conv2", 16, 64, pool=("max", 2)),
              ConvSpec("conv3", 64, 64, pool=("max", 2)), FlattenSpec(),
              DenseSpec("fc1", 4 * 4 * 64, 10, act="none"))
    prog = Program(layers, init_vision(torch.Generator().manual_seed(5),
                                       layers), (16, 16, 3),
                   name="fused_then_int")
    exe = prog.compile(Options(scheme=W4A4, conv_strategy="strip",
                               fuse="auto", verify="off"))
    plan = exe.plan
    assert plan.int_operands == ("conv3",) and plan.fused_segments
    f = torch.from_numpy(_frames_for(prog, batch, 12)).to(cuda)
    reset_launch_counts()
    got = plan_mod._execute(plan, exe.params(), f, per_frame=per_frame)
    counts = launch_counts()
    ref = plan_mod._execute(plan, exe.params(), f, per_frame=per_frame,
                            backend="reference")
    assert torch.equal(got, ref)
    fused = per_frame or batch == 1
    assert counts["conv_chain"] == int(fused)
    assert counts["conv_strip_int"] == 1 + int(not fused)


@pytest.mark.parametrize("bucket", [1, 8])
def test_vgg16_bound_graph_replay_bitwise_equal_to_eager(cuda, bucket):
    prog = _vgg16_program()
    exe = prog.compile(Options(scheme=W4A4, verify="on"))
    assert exe.report.verification == [] and exe.plan.exact_proven
    bound = exe.bind("cuda", staging_slots=2)
    f = _frames_for(prog, max(bucket - 1, 1), bucket)
    reset_launch_counts()
    got = np.asarray(bound.run_padded(f, bucket))       # eager + capture
    counts = launch_counts()
    assert counts["conv_strip_int"] > 0 and counts["photonic_mvm"] > 0
    assert counts["conv_chain"] == counts["ca_pool"] == 0
    assert counts["conv_strip"] == 0           # conv1-10 on the int8 route
    replayed = np.asarray(bound.run_padded(f, bucket))
    eager = exe.run_per_frame(f).cpu().numpy()
    assert got.shape == (len(f), 1000) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(replayed, eager)
    assert bound._binding.graphs[bucket].replays == 2
    # fc1-fc3 and conv11-13 take their levels laid out at bind: the
    # graph holds no per-call layout
    from repro_torch.kernels.photonic_mvm.ops import MvmWeights
    assert all(isinstance(bound._binding.weights[name][2], MvmWeights)
               for name in ("conv11", "conv12", "conv13", "fc1", "fc2",
                            "fc3"))


def test_vgg16_under_shard_batch_bitwise_equal_to_unsharded(cuda):
    """Two shards of cuda:0, each on its own thread: conv11-13 (wgmma,
    M = 196 a shard) and fc1-fc3 (the stream) bitwise the unsharded
    run."""
    prog = _vgg16_program()
    f = _frames_for(prog, 2, 12)
    plain = Options(scheme=W4A4, verify="off")
    want = prog.compile(plain).run(f).cpu()
    reset_launch_counts()
    got = prog.compile(dataclasses.replace(
        plain, shard_batch=True, mesh=("cuda:0", "cuda:0"))).run(f).cpu()
    assert launch_counts()["photonic_mvm"] == 12       # 6 a shard
    assert torch.equal(got, want)


def test_verified_chain_plan_launches_with_no_range_check(cuda, monkeypatch):
    """A plan the verifier proved runs LeNet's fused chain, eagerly and
    bound, without ``fused.check_exact`` (which may read the device); an
    unverified compile of it still checks every unbound launch."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels.conv_bank import fused

    def refuse(*a, **kw):
        raise AssertionError("check_exact ran")

    monkeypatch.setattr(fused, "check_exact", refuse)
    prog = Program.from_model("lenet", torch.Generator().manual_seed(5))
    f = _frames_for(prog, 3, 6)
    plan_mod.clear_plan_cache()
    exe = prog.compile(Options(scheme=W4A4))
    assert exe.plan.exact_proven and exe.plan.fused_segments
    reset_launch_counts()
    eager = exe.run_per_frame(f).cpu().numpy()
    assert launch_counts()["conv_chain"] == 1
    bound = exe.bind("cuda")
    np.testing.assert_array_equal(np.asarray(bound.run_padded(f, 4)), eager)
    plan_mod.clear_plan_cache()
    unproven = prog.compile(Options(scheme=W4A4, verify="off"))
    with pytest.raises(AssertionError, match="check_exact ran"):
        unproven.run_per_frame(f)
    plan_mod.clear_plan_cache()


# -- training (the QAT slice) --------------------------------------------------

@pytest.mark.parametrize("m,k,n,route", SIGNED_MVM_SHAPES)
def test_signed_photonic_mvm_float_api_bitwise_equal_to_plain(cuda, m, k, n,
                                                              route):
    """The float API on signed CRC codes in [-15, 15] (``dense``'s kernel
    mode) launches the kernel once on the route ``mvm_config`` picks and
    is bitwise equal to ``photonic_mvm_ref`` on the same card tensors."""
    from repro_torch.core.quant import W2A4
    from repro_torch.kernels.photonic_mvm.ops import mvm_config, photonic_mvm
    from repro_torch.kernels.photonic_mvm.ref import (photonic_mvm_ref,
                                                      signed_codes)
    assert mvm_config(m, k, n).route == route
    g = torch.Generator().manual_seed(m * 5 + k + n)
    x = (torch.randn((m, k), generator=g) * 0.6).to(cuda)
    w = torch.randn((k, n), generator=g).to(cuda)
    codes = signed_codes(x, W4A4, 1.0 / 15.0)
    assert int(codes.min()) < 0 < int(codes.max()) or m * k < 30
    for spec in (W4A4, W2A4):
        reset_launch_counts()
        got = photonic_mvm(x, w, spec)
        assert launch_counts()["photonic_mvm"] == 1
        assert torch.equal(got, photonic_mvm_ref(x, w, spec))


def test_qat_steps_on_the_card_match_the_cpu_port(cuda):
    """A few LeNet W4A4 steps and two VGG9-CA ones from the same weights on
    the card and on the CPU: the first step's loss within 1e-4 relative
    (cuDNN's convs and cuBLAS's matmuls, TF32 off, sum in another order
    than the CPU's, and a CRC code within an ulp of a tie may step), every
    loss finite; the weights trained on the card then serve bitwise equal
    on the card and, moved, on the CPU."""
    from repro_torch.launch import train_vision as tv
    from repro_torch.models.vision import init_vision, VISION_MODELS
    for model, steps, batch in (("lenet", 3, 64), ("vgg9", 2, 64)):
        p0 = init_vision(torch.Generator().manual_seed(1),
                         VISION_MODELS[model]())
        card = tv.train(model, W4A4, steps, batch, device="cuda", params=p0)
        cpu = tv.train(model, W4A4, steps, batch, device="cpu", params=p0)
        assert card.clock == "cuda events" and len(card.step_ms) == steps
        assert all(np.isfinite(card.losses)) and all(np.isfinite(cpu.losses))
        assert card.losses[0] == pytest.approx(cpu.losses[0], rel=1e-4)
        frames, _ = tv.dataset(model, 3, seed=9)
        prog = Program.from_model(model, params=card.params)
        on_card = prog.compile(Options(scheme=W4A4)).run_per_frame(frames)
        on_cpu = prog.compile(Options(scheme=W4A4, device="cpu")) \
            .run_per_frame(frames)
        np.testing.assert_array_equal(on_card.cpu().numpy(), on_cpu.numpy())


def test_train_vision_without_a_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    from repro_torch.launch import train_vision as tv
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.train("lenet", W4A4, 1, 8)


# -- the LM families (models/lm.py) -------------------------------------------

LM_ARCHS = ("hubert-xlarge", "hymba-1.5b", "internvl2-26b", "mamba2-1.3b",
            "smollm-360m", "stablelm-3b", "tinyllama-1.1b", "yi-34b")


@pytest.mark.parametrize("quant", ["none", "w4a4"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_the_card_matches_the_cpu_port(cuda, arch, quant):
    """Every non-MoE smoke arch in float32 (TF32 off), the same weights
    carried through numpy to both devices: the forward's logits and three
    decode steps' logits (float32 caches) within 1e-4 of their largest
    (cuBLAS sums in another order than the CPU; under W4A4 a CRC code
    within an ulp of a tie may step, which the tolerance does not cover:
    a failure here names such a case); the card's cache position stays a
    device tensor."""
    from repro_torch.configs import smoke_variant
    from repro_torch.data.synthetic import modality_batch
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.models import lm
    from repro_torch.weights import lm_params_from_numpy, lm_params_to_numpy
    cfg = dataclasses.replace(smoke_variant(arch), dtype="float32",
                              quant_scheme=quant)
    tree = lm_params_to_numpy(lm.init_lm(torch.Generator().manual_seed(2),
                                         cfg, device="cpu"))
    batch = modality_batch(cfg, 2, 16, seed=3)
    out, fed = {}, None        # the card is fed the CPU's greedy tokens
    with float32_convs():
        for dev in ("cpu", "cuda"):
            params = lm_params_from_numpy(tree, dev, cfg)
            fwd, _ = lm.lm_forward(params, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()}, cfg)
            out[dev] = [fwd.cpu()]
            if cfg.family == "encoder":
                continue
            cache = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device=dev)
            toks = fed or [torch.from_numpy(batch["tokens"][:, :1])]
            for i in range(3):
                lg, cache = lm.decode_step(params, cache, toks[i].to(dev),
                                           cfg)
                assert cache["pos"].device.type == dev
                out[dev].append(lg.cpu())
                if fed is None:
                    toks.append(lg.argmax(-1)[:, None].to(torch.int32))
            fed = toks
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-4, float(err)


# -- the MoE family (nn/moe.py, models/lm.py's moe) ---------------------------

def _routed(fn):
    """Runs ``fn()`` and returns (its result, the expert indices of every
    MoE routing it made, in order)."""
    from unittest import mock
    from repro_torch.nn import moe
    route, seen = moe._route, []

    def spy(logits, k):
        probs, top_w, top_i = route(logits, k)
        seen.append(top_i.cpu())
        return probs, top_w, top_i

    with mock.patch.object(moe, "_route", spy):
        out = fn()
    return out, seen


@pytest.mark.parametrize("mode", ["none", "w4a4", "storage"])
@pytest.mark.parametrize("dispatch", ["sorted", "grouped"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_moe_on_the_card_matches_the_cpu_port(cuda, arch, dispatch, mode):
    """The MoE smoke archs in float32 (TF32 off) under both dispatches and
    quant none, W4A4 fake-quant and W4A4 storage, one set of weights
    carried through numpy to both devices: the forward's logits, aux and
    three decode steps' logits within 1e-4 of their largest, the dropped
    fractions equal and the expert indices of every routing equal."""
    from repro_torch.configs import smoke_variant
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.models import lm
    from repro_torch.weights import lm_params_from_numpy, lm_params_to_numpy
    cfg = dataclasses.replace(smoke_variant(arch), dtype="float32",
                              moe_dispatch=dispatch,
                              quant_scheme="w4a4" if mode == "w4a4"
                              else "none")
    params = lm.init_lm(torch.Generator().manual_seed(4), cfg, device="cpu")
    if mode == "storage":
        params = lm.quantize_lm_params(params, cfg, W4A4)
    tree = lm_params_to_numpy(params)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    out, routes = {}, {}

    def run(dev):
        p = lm_params_from_numpy(tree, dev, cfg)
        fwd, aux = lm.lm_forward(p, {"tokens": toks.to(dev)}, cfg)
        res = [fwd.cpu()]
        cache = lm.init_cache(cfg, 2, 8, dtype=torch.float32, device=dev)
        for i in range(3):
            lg, cache = lm.decode_step(p, cache, toks[:, i:i + 1].to(dev),
                                       cfg)
            res.append(lg.cpu())
        return res, {k: float(v) for k, v in aux.items()}

    with float32_convs():
        for dev in ("cpu", "cuda"):
            out[dev], routes[dev] = _routed(lambda: run(dev))
    (card, card_aux), (cpu, cpu_aux) = out["cuda"], out["cpu"]
    assert card_aux["dropped"] == cpu_aux["dropped"]
    for k in ("balance", "z"):
        assert abs(card_aux[k] - cpu_aux[k]) <= 1e-4 * cpu_aux[k]
    for got, want in zip(card, cpu):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-4, float(err)
    assert len(routes["cuda"]) == len(routes["cpu"]) > 0
    for a, b in zip(routes["cuda"], routes["cpu"]):
        assert torch.equal(a, b)


def test_moe_combine_cast_on_the_card_equals_the_cpu(cuda):
    """``to_combine_dtype`` to float8_e4m3fn and bfloat16 gives the same
    bits on the card as on the CPU (where it equals ml_dtypes' cast), past
    +-448, at ties and on infinities."""
    from repro_torch.nn import moe
    f8 = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    fin = torch.unique(f8.float()[torch.isfinite(f8.float())])
    mids = ((fin[1:].double() + fin[:-1].double()) / 2).float()
    v = torch.cat([fin, mids, torch.tensor([449.0, 464.0, 464.5, 480.0,
                                            1e4, float("inf")]),
                   torch.randn(10000, generator=torch.Generator()
                               .manual_seed(0)) * 100])
    v = torch.cat([v, -v])
    for dtype in (torch.float8_e4m3fn, torch.bfloat16):
        for src in (torch.float32, torch.bfloat16):
            x = v.to(src)
            want = moe.to_combine_dtype(x, dtype).float()
            got = moe.to_combine_dtype(x.to(cuda), dtype).float().cpu()
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got[~got.isnan()], want[~want.isnan()])


# -- training the LM families (launch/steps.py, launch/train.py) -------------

TRAIN_LM_CASES = [("smollm-360m", None), ("mamba2-1.3b", None),
                  ("hymba-1.5b", None), ("hubert-xlarge", None),
                  ("internvl2-26b", None), ("grok-1-314b", "sorted"),
                  ("grok-1-314b", "grouped")]


def _train_lm_steps(cfg, tree, device, steps, lr=2e-3):
    """``steps`` AdamW steps of ``steps.make_train_step`` on ``device``
    from the numpy weights ``tree``, over the seeded modality batches:
    (losses, grad norms, final state)."""
    from repro_torch.data.synthetic import modality_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.weights import lm_params_from_numpy
    params = lm_params_from_numpy(tree, device, cfg)
    opt = adamw_init(params, AdamWConfig(lr=lr))
    step = make_train_step(cfg, AdamWConfig(lr=lr), 16)
    losses, norms = [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 modality_batch(cfg, 2, 16, seed=10 + i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {"params": params, "opt": opt}


@pytest.mark.parametrize("arch,dispatch", TRAIN_LM_CASES)
def test_lm_train_steps_on_the_card_match_the_cpu_port(cuda, arch, dispatch):
    """Three train steps of every family's smoke arch in float32 (TF32
    off) from one set of weights: losses and grad norms within 1e-4
    relative, every leaf of the params and the AdamW state within 1e-4 of
    its largest |entry|, or params and master within 0.1 * lr absolute
    (where |g| is a few eps, AdamW's normalized update is sensitive to the
    gradient's float32 error: tests/test_torch_train_lm.py)."""
    from repro_torch.configs import smoke_variant
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_flatten_with_paths
    from repro_torch.weights import lm_params_to_numpy
    kw = {"dtype": "float32"}
    if dispatch is not None:
        kw["moe_dispatch"] = dispatch
    cfg = dataclasses.replace(smoke_variant(arch), **kw)
    tree = lm_params_to_numpy(lm.init_lm(torch.Generator().manual_seed(6),
                                         cfg, device="cpu"))
    with float32_convs():
        want = _train_lm_steps(cfg, tree, "cpu", 3)
        got = _train_lm_steps(cfg, tree, "cuda", 3)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert np.isfinite(g) and g == pytest.approx(w, rel=1e-4)
    cpu = dict(tree_flatten_with_paths(want[2]))
    for path, leaf in tree_flatten_with_paths(got[2]):
        w = cpu[path]
        assert leaf.device.type == "cuda" and leaf.dtype == w.dtype
        err = float((leaf.cpu().double() - w.double()).abs().max())
        bound = 1e-4 * float(w.double().abs().max())
        if path.startswith(("params/", "opt/master/")):
            bound = max(bound, 0.1 * 2e-3)
        assert err <= bound, (path, err, bound)


def test_lm_checkpoint_from_the_card_restores_bitwise_on_the_cpu(cuda,
                                                                   tmp_path):
    """A bf16 training state saved from the card (params, AdamW step,
    master and moments after two steps) restores on the CPU bit for bit,
    and back onto the card."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint, \
        save_checkpoint
    from repro_torch.configs import smoke_variant
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_flatten_with_paths
    from repro_torch.weights import lm_params_to_numpy
    cfg = smoke_variant("tinyllama-1.1b")
    assert cfg.dtype == "bfloat16"
    tree = lm_params_to_numpy(lm.init_lm(torch.Generator().manual_seed(7),
                                         cfg, device="cpu"))
    _, _, state = _train_lm_steps(cfg, tree, "cuda", 2)
    save_checkpoint(tmp_path, 2, state)
    on_cpu = restore_checkpoint(tmp_path, state, device="cpu")
    back = restore_checkpoint(tmp_path, state)
    want = dict(tree_flatten_with_paths(state))
    for path, leaf in tree_flatten_with_paths(on_cpu):
        assert leaf.device.type == "cpu" and leaf.dtype == want[path].dtype
        assert torch.equal(leaf, want[path].cpu()), path
    for path, leaf in tree_flatten_with_paths(back):
        assert leaf.device.type == "cuda"
        assert torch.equal(leaf, want[path]), path
    assert int(on_cpu["opt"]["step"]) == 2


def test_data_pipeline_uploads_on_its_own_stream(cuda):
    """Batches copied to the card by the pipeline's worker (pinned memory,
    its own stream, an event the consumer's stream waits on) equal the
    host batches, in step order, while the consumer's stream is busy."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import SyntheticTextConfig, \
        synthetic_lm_batch
    cfg = SyntheticTextConfig(vocab=49152, seq=128, batch=8, seed=0)
    pipe = DataPipeline(lambda s: synthetic_lm_batch(cfg, s), device=cuda,
                        prefetch=2, start_step=5)
    busy = torch.randn((4096, 4096), device=cuda)
    try:
        for want_step in range(5, 13):
            for _ in range(4):                     # keep the card busy
                busy = busy @ busy / 64.0
            step, batch = pipe.next()
            assert step == want_step
            host = synthetic_lm_batch(cfg, step)
            for k, v in batch.items():
                assert v.device.type == "cuda"
                assert torch.equal((v + 0).cpu(), torch.from_numpy(host[k]))
    finally:
        pipe.stop()


def test_lm_restart_on_the_card_is_bitwise_under_deterministic_algorithms(
        cuda, tmp_path):
    """The driver's failure drill on the card (smollm-360m smoke): a crash
    at step 5, then the restart from the step-4 checkpoint, equal to the
    uninterrupted run bit for bit under
    ``torch.use_deterministic_algorithms(True)`` (the embedding's
    backward accumulates with atomics otherwise); the setting is
    restored after."""
    from repro_torch.launch import train
    from repro_torch.nn.module import tree_flatten_with_paths
    args = ["--arch", "smollm-360m", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "32", "--ckpt-every", "4"]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = train.train(args + ["--ckpt-dir", str(tmp_path / "ref")])
        with pytest.raises(RuntimeError, match="injected failure"):
            train.train(args + ["--ckpt-dir", str(tmp_path / "run"),
                                "--fail-at", "5"])
        resumed = train.train(args + ["--ckpt-dir", str(tmp_path / "run")])
    finally:
        torch.use_deterministic_algorithms(was)
    assert resumed.first_step == 4 and resumed.losses == ref.losses[4:]
    want = dict(tree_flatten_with_paths(ref.state))
    for path, leaf in tree_flatten_with_paths(resumed.state):
        assert torch.equal(leaf, want[path]), path


@pytest.mark.parametrize("mesh", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")])
def test_shard_batch_runs_each_shard_on_its_device(cuda, mesh, monkeypatch):
    """``Options(shard_batch=True, mesh=)``: each shard's kernels run with
    the shard's device current, and the result is bitwise the unsharded
    run. Two distinct devices need two cards; a one-card host runs both
    shards on ``cuda:0``."""
    from repro_torch.core import plan as plan_mod
    if torch.cuda.device_count() < len(set(mesh)):
        pytest.skip(f"needs {len(set(mesh))} CUDA devices")
    current = []
    real = plan_mod._execute

    def spy(plan, params, frames, *a, **k):
        current.append((frames.device.index, torch.cuda.current_device()))
        return real(plan, params, frames, *a, **k)
    prog = Program.from_model("lenet", torch.Generator().manual_seed(5))
    f = np.random.default_rng(1).random((8, *prog.input_hwc)).astype(
        np.float32)
    f[1] *= 0.05
    plain = Options(scheme=W4A4)
    want = prog.compile(plain).run(f).cpu()
    monkeypatch.setattr(plan_mod, "_execute", spy)
    got = prog.compile(dataclasses.replace(
        plain, shard_batch=True, mesh=mesh)).run(f).cpu()
    assert torch.equal(got, want)
    assert sorted(current) == sorted((torch.device(d).index,) * 2
                                     for d in mesh)


@pytest.mark.parametrize("model", ["lenet", "vgg9"])
@pytest.mark.parametrize("scheme", ["w4a4", "mx43"])
def test_run_eager_on_the_card_equals_run_and_launches_nothing(cuda, model,
                                                               scheme):
    """``LightatorDevice.run_eager`` on the card (exact float64
    accumulates, no kernel) is bitwise ``run`` (the kernels), reports equal
    field for field, and both equal the CPU's ``run_eager``."""
    import warnings
    from repro_torch.core.accelerator import LightatorDevice
    from repro_torch.core.quant import MX_43
    spec = {"w4a4": W4A4, "mx43": MX_43}[scheme]
    prog = Program.from_model(model, torch.Generator().manual_seed(6))
    f = np.random.default_rng(2).random((8, *prog.input_hwc)).astype(
        np.float32)
    f[1] *= 0.05
    dev = LightatorDevice()
    reset_launch_counts()
    eager, erep = dev.run_eager(prog.layers, prog.params, f, spec)
    assert sum(launch_counts().values()) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got, rep = dev.run(prog.layers, prog.params, f, spec)
    assert launch_counts()["photonic_mvm"] > 0
    assert eager.device.type == "cuda" and torch.equal(eager, got)
    assert dataclasses.asdict(erep) == dataclasses.asdict(rep)
    cpu, _ = LightatorDevice(device="cpu").run_eager(prog.layers,
                                                     prog.params, f, spec)
    assert torch.equal(eager.cpu(), cpu)


# -- the plan executor's epilogue ---------------------------------------------

def _same_epilogue(call):
    kernel, plain = epilogue_fns(call)
    reset_launch_counts()
    got = kernel()
    assert launch_counts()["epilogue"] == 1
    assert launch_counts()["conv_strip_int"] == int(call.folded)
    want = plain()
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
    assert got[1].shape == want[1].shape and torch.equal(got[1], want[1])


def _fold_case(gen, device, b, h_out, w_out, ci, co, k, stride, per_frame):
    """A folded conv's operands (W4A4 codes and levels), its act_scale (one
    a frame or one), ws and bias, random from ``gen``."""
    xp, w, ws, bias = _strip_int_case(gen, device, b, h_out, w_out, ci, co,
                                      k, stride, codes=16, levels=7)
    s = torch.rand((b, 1, 1, 1), generator=gen, device=device) * 0.01 + 1e-3
    s = s if per_frame else s.reshape(-1)[0]
    x8, _ = strip.int_operands(xp, w)
    return x8, strip.int_weights(w, stride=stride), s, ws * 0.1, bias


def _check_fold(x8, levels, s, ws, bias, stride, per_frame):
    """The folded store (y and each CTA's max) and the folded call (codes
    and scale, float codes and a 3 x 3 operand) bitwise their plain
    versions, at every act, with and without a max pool and a bias."""
    from repro_torch.kernels.epilogue.ops import (epilogue_fold,
                                                  epilogue_fold_ref)
    kk = levels.w8.shape[0]
    h = (x8.shape[1] - kk) // stride + 1
    w = (x8.shape[2] - kk) // stride + 1
    pools = [None] + ([("max", 2)] if h % 2 == 0 and w % 2 == 0 else [])
    acc = strip.conv_strip_int_ref(x8, levels.w8, stride=stride)
    cfg = strip.igemm_config(x8.shape[0], h, w, x8.shape[-1],
                             levels.w8.shape[-1], kk, stride)
    for act in ("relu", "none", "abs", "sign"):
        fold = strip.Fold(s, ws, bias if act != "none" else None, act)
        reset_launch_counts()
        got = strip.conv_strip_int_laid(x8, levels, stride, fold=fold)
        assert launch_counts()["conv_strip_int"] == 1
        want = strip.fold_ref(acc, fold, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for pool in pools:
            hp, wp = (h // 2, w // 2) if pool else (h, w)
            for operand in (None, (3, padtype_to_pads((hp, wp), 3, 1,
                                                      "SAME"))):
                args = (x8, s, ws, fold.bias, act, pool, 15.0, per_frame,
                        None, operand, levels, stride)
                reset_launch_counts()
                got = epilogue_fold(*args)
                assert launch_counts()["epilogue"] == 1
                want = epilogue_fold_ref(*args)
                assert got[0].dtype == want[0].dtype
                assert torch.equal(got[0], want[0]), (act, pool, operand)
                assert got[1].shape == want[1].shape
                assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", VGG16_SHAPES["conv_strip"],
                         ids=lambda v: v[0])
def test_folded_conv_vgg16_shapes_bitwise_equal_to_plain(cuda, shape, batch,
                                                         per_frame):
    _, _, _, w_out, ci, co, k, stride = shape
    gen = torch.Generator(device=cuda).manual_seed(batch + ci + co + 1)
    _check_fold(*_fold_case(gen, cuda, batch, w_out, w_out, ci, co, k,
                            stride, per_frame), stride, per_frame)


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("b,h_out,w_out,ci,co,k,stride", STRIP_EDGES)
def test_folded_conv_configs_bitwise_equal_to_plain(cuda, b, h_out, w_out,
                                                    ci, co, k, stride,
                                                    per_frame):
    gen = torch.Generator(device=cuda).manual_seed(b + h_out + ci + k + 2)
    _check_fold(*_fold_case(gen, cuda, b, h_out, w_out, ci, co, k, stride,
                            per_frame), stride, per_frame)


@pytest.mark.parametrize("cluster", ops.CLUSTERS)
@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("i", range(len(EPILOGUE_EDGES)))
def test_cluster_epilogue_configs_bitwise_equal_to_plain(cuda, i, per_frame,
                                                         cluster):
    """The one-launch form at each edge (per tensor, at one frame), every
    cluster size it takes, against the plain version."""
    edge = EPILOGUE_EDGES[i] if per_frame else (1,) + EPILOGUE_EDGES[i][1:]
    args = epilogue_case(edge, per_frame, torch.Generator().manual_seed(i),
                         cuda)
    g = ops.geometry(args[0].contiguous(), args[5], args[9])
    vec = ops.epilogue_config(g.b, g.n, g.c, g.aligned, g.op_words, g.p,
                              True).vec
    smem = ops.cluster_smem(g.n, g.c, vec, cluster, g.op_words > 0)
    if smem > ops.SMEM_MAX:
        # the frame does not fit this cluster: the launch is refused
        with pytest.raises(Exception):
            ops.launch(*args, config=ops.EpilogueConfig(
                vec, cluster=cluster, smem=smem))
        return
    reset_launch_counts()
    got = ops.launch(*args, config=ops.EpilogueConfig(
        vec, cluster=cluster, smem=smem))
    assert launch_counts()["epilogue"] == 1
    want = epilogue_ref(*args)
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
    assert got[1].shape == want[1].shape and torch.equal(got[1], want[1])

@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("i", range(len(EPILOGUE_EDGES)))
def test_epilogue_kernel_configs_bitwise_equal_to_plain(cuda, i, per_frame):
    args = epilogue_case(EPILOGUE_EDGES[i], per_frame,
                         torch.Generator().manual_seed(i), cuda)
    _same_epilogue(EpilogueCall(*args))


def _tie_frames(scale_of, b, c, per_pixel):
    """``b`` frames [b, 32, 32, c] of ``quotient_ties`` at the scale the
    codes take, amax / 15 (a_qmax), each frame's max amax = ``scale_of`` *
    15, tiled; each value ``per_pixel`` x ``per_pixel`` times (a max
    pool's windows)."""
    f32 = np.float32
    amax = f32(scale_of * 15)
    scale = f32(amax / f32(15))
    vals = quotient_ties(scale, 15)
    vals = vals[vals <= amax]
    n = 32 * 32 * c
    frames = np.resize(vals, (b, n)).astype(f32)
    frames[np.arange(b), np.arange(b) * 7] = amax
    x = torch.from_numpy(frames.reshape(b, 32, 32, c))
    return x.repeat_interleave(per_pixel, 1).repeat_interleave(per_pixel, 2)


@pytest.mark.parametrize("scale", [0.125, 0.37])
@pytest.mark.parametrize("operand", [False, True])
@pytest.mark.parametrize("c", [4, 3])
@pytest.mark.parametrize("form", ["pair", "cluster", "fold", "fold_pooled"])
def test_epilogue_codes_at_half_integer_quotients_bitwise_equal_to_plain(
        cuda, form, c, operand, scale):
    """Each code of y on and around a half-integer quotient (exact ties at
    a power-of-two scale, where half to even decides; 1-4 ulps off; 2^-23
    to 2^-19 off; tiny quotients; up to code_max), where the kernels take
    the quotient from the reciprocal and divide only near the tie: the
    pair, the cluster and the fold's pass 2 (unpooled and max-pooled) are
    bitwise the plain version's true division."""
    b = 2
    x = _tie_frames(scale, b, c, 2 if form == "fold_pooled" else 1)
    pool = ("max", 2) if form == "fold_pooled" else None
    op = (3, ((1, 1), (1, 1))) if operand else None
    per_frame = form != "pair"         # per tensor at batch 2: the pair
    want = epilogue_ref(x, None, None, None, "none", pool, 15.0, per_frame,
                        None, op)
    xc = x.to(cuda)
    reset_launch_counts()
    if form.startswith("fold"):
        partials = xc.reshape(b, -1).amax(1, keepdim=True)
        got = ops.launch_folded(xc, partials, pool, 15.0, per_frame, None,
                                op)
    else:
        g = ops.geometry(xc, None, op)
        cfg = ops.epilogue_config(g.b, g.n, g.c, g.aligned, g.op_words,
                                  g.p, per_frame)
        assert bool(cfg.cluster) == (form == "cluster")
        got = epilogue(xc, None, None, None, "none", None, 15.0, per_frame,
                       None, op)
    assert launch_counts()["epilogue"] == 1
    assert got[0].dtype == want[0].dtype
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _path_program(name):
    if name == "vgg16":
        return _vgg16_program()
    if name in ("lenet", "vgg9"):
        return Program.from_model(name, torch.Generator().manual_seed(7))
    return Program.from_pipeline(name, 256, 256)


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("name", ["lenet", "vgg9", "edge_detect",
                                  "compress_recon", "denoise_gauss",
                                  "vgg16"])
def test_epilogue_kernel_at_path_shapes_bitwise_equal_to_plain(
        cuda, name, per_frame):
    prog = _path_program(name)
    exe = prog.compile(Options(scheme=W4A4, verify="off"))
    f = torch.from_numpy(_frames_for(prog, 8, 9)).to(cuda)
    calls = epilogue_calls(exe, f, per_frame)
    assert calls
    for call in calls:
        _same_epilogue(call)


@pytest.mark.parametrize("name", ["lenet", "vgg9", "denoise_gauss"])
def test_epilogue_under_shard_batch_bitwise_equal_to_unsharded(cuda, name):
    """Per-tensor calibration over two shards of cuda:0: pass 1's max goes
    through the shards' ``reduce_max`` before pass 2."""
    prog = _path_program(name)
    f = _frames_for(prog, 8, 10)
    plain = Options(scheme=W4A4, verify="off")
    want = prog.compile(plain).run(f).cpu()
    ref = prog.compile(dataclasses.replace(plain, backend="reference")).run(
        f).cpu()
    reset_launch_counts()
    got = prog.compile(dataclasses.replace(
        plain, shard_batch=True, mesh=("cuda:0", "cuda:0"))).run(f).cpu()
    assert launch_counts()["epilogue"] > 0
    assert torch.equal(got, want) and torch.equal(got, ref)


def test_folded_epilogue_under_shard_batch_bitwise_equal_to_unsharded(cuda):
    """conv2 and conv3 on the int8 route fold their requant into their
    store; over two shards of cuda:0 the folded pass 2 takes the batch's
    max through ``reduce_max``, between the conv and pass 2."""
    from repro_torch.core.accelerator import ConvSpec, DenseSpec, FlattenSpec
    from repro_torch.models.vision import init_vision
    layers = (ConvSpec("conv1", 3, 16, pool=("max", 2)),
              ConvSpec("conv2", 16, 32, act="none"),
              ConvSpec("conv3", 32, 32, pool=("max", 2)), FlattenSpec(),
              DenseSpec("fc1", 4 * 4 * 32, 10, act="none"))
    prog = Program(layers, init_vision(torch.Generator().manual_seed(6),
                                       layers), (16, 16, 3), name="folds")
    plain = Options(scheme=W4A4, verify="off", conv_vmem_budget=2048)
    assert prog.compile(plain).plan.folded_epilogues == ("conv2", "conv3")
    f = _frames_for(prog, 8, 14)
    want = prog.compile(plain).run(f).cpu()
    ref = prog.compile(dataclasses.replace(plain, backend="reference")).run(
        f).cpu()
    reset_launch_counts()
    got = prog.compile(dataclasses.replace(
        plain, shard_batch=True, mesh=("cuda:0", "cuda:0"))).run(f).cpu()
    assert launch_counts()["conv_strip_int"] == 4
    assert torch.equal(got, want) and torch.equal(got, ref)


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("i", range(len(EPILOGUE_NAN_EDGES)))
def test_epilogue_kernel_keeps_a_nan_as_its_plain_version(cuda, i,
                                                           per_frame):
    args = epilogue_nan_case(EPILOGUE_NAN_EDGES[i], per_frame,
                             torch.Generator().manual_seed(i), cuda)
    reset_launch_counts()
    got = epilogue(*args)
    assert launch_counts()["epilogue"] == 1
    want = epilogue_ref(*args)
    assert bool(want[1].isnan().any()) == (EPILOGUE_NAN_EDGES[i][0]
                                           != "sign")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_int_route_levels_laid_out_at_bind_equal_per_call(cuda):
    from repro_torch.core import plan as plan_mod
    prog = _vgg16_program()
    exe = prog.compile(Options(scheme=W4A4, verify="off"))
    plan, params = exe.plan, exe.params()
    assert plan.int_operands == tuple(f"conv{i}" for i in range(1, 11))
    weights = plan_mod.quantized_weights(plan.steps, params, plan.consts,
                                         plan.strip_routes)
    assert all(isinstance(weights[n][2], strip.IntWeights)
               for n in plan.int_operands)
    f = torch.from_numpy(_frames_for(prog, 2, 11)).to(cuda)
    counts = []
    outs = []
    for w in (None, weights):
        reset_launch_counts()
        outs.append(plan_mod._execute(plan, params, f, per_frame=True,
                                      weights=w))
        counts.append(launch_counts())
    assert torch.equal(outs[0], outs[1])
    assert counts[0] == counts[1] and counts[0]["conv_strip_int"] == 10
    # the frames, 13 convs, the flatten, fc1 and fc2
    assert counts[0]["epilogue"] == 17
