"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the ``gpu``
marker; run them on the card with ``pytest -m gpu tests/test_torch_gpu.py``).
On the card each kernel's wrapper must launch its kernel, count the launch,
and be bitwise equal to its plain PyTorch version on the same inputs; the
whole serving path on the card must equal the port's CPU run, and an
imaging pipeline served through ``serve.Server`` must equal batch-1 runs.
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
from repro_torch.kernels.ca_pool.ops import ca_config, ca_pool
from repro_torch.kernels.conv_bank import strip
from repro_torch.kernels.conv_bank.fused import conv_chain
from repro_torch.kernels.conv_bank.ops import conv_bank, conv_bank_plain
from repro_torch.kernels.conv_bank.ref import conv_chain_ref
from repro_torch.kernels.edge_shapes import (CA_EDGES, CHAIN_EDGES, CHAINS,
                                             DW_EDGES, MVM_EDGES, STRIP_EDGES,
                                             chain_case, odd_offset)
from repro_torch.kernels.photonic_mvm.ops import mvm_int
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
@pytest.mark.parametrize("m,k,n,route,split", MVM_EDGES)
def test_mvm_kernel_configs_bitwise_equal_to_plain(cuda, m, k, n, route,
                                                   split, odd):
    from repro_torch.kernels.photonic_mvm.ops import mvm_config
    cfg = mvm_config(m, k, n)
    assert (cfg.route, cfg.split > 1) == (route, split)
    g = torch.Generator().manual_seed(m * 7 + k * 3 + n)
    a = torch.randint(-15, 16, (m, k), generator=g).to(torch.int8).to(cuda)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8).to(cuda)
    if odd:
        a, w = odd_offset(a), odd_offset(w)
        assert a.data_ptr() % 2 == 1 and a.is_contiguous()
    ws = (torch.rand((n,), generator=g) + 0.5).to(cuda)
    reset_launch_counts()
    got = mvm_int(a, w)
    assert launch_counts()["photonic_mvm"] == 1     # the split-K pass too
    assert torch.equal(got, mvm_int_ref(a, w))
    assert torch.equal(mvm_int(a, w, ws, 0.37), mvm_int_ref(a, w, ws, 0.37))


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
    got = ca_pool(img, pool, gray)
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
    got = ca_pool(img, p, gray)
    assert launch_counts()["ca_pool"] == 1
    assert torch.equal(got, compressive_acquire(img, p, gray))


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
    assert launch_counts()["conv_strip"] == 1
    assert torch.equal(got, strip.conv_strip_ref(xp, wq, stride=stride,
                                                 strip_h=strip_h))
    kw = dict(stride=stride, strip_h=strip_h, act_scale=0.37, act="relu",
              bias=bias)
    assert torch.equal(strip.conv_strip(xp, wq, ws, **kw),
                       strip.conv_strip_ref(xp, wq, ws, **kw))


@pytest.mark.parametrize("b,h_out,w_out,ci,co,k,stride", STRIP_EDGES)
def test_strip_kernel_configs_bitwise_equal_to_plain(cuda, b, h_out, w_out,
                                                     ci, co, k, stride):
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
    got = strip.conv_strip(xp, wq, **kw)
    assert launch_counts()["conv_strip"] == 1
    assert torch.equal(got, strip.conv_strip_ref(xp, wq, **kw))
    for act in ("none", "relu", "abs", "sign"):
        e = dict(kw, act_scale=0.37, act=act, bias=bias)
        assert torch.equal(strip.conv_strip(xp, wq, ws, **e),
                           strip.conv_strip_ref(xp, wq, ws, **e)), act
    e = dict(kw, act_scale=0.37)                       # ws, no bias
    assert torch.equal(strip.conv_strip(xp, wq, ws, **e),
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
    assert counts["conv_bank" if strategy == "resident" else "conv_strip"] \
        == 1
    assert torch.equal(got, conv_bank_plain(x, w, **kw))
    # float mode: float64 products summed in the kernel's own order
    torch.testing.assert_close(conv_bank(x, w, strategy=strategy),
                               conv_bank_plain(x, w, strategy=strategy),
                               rtol=1e-5, atol=1e-5)


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
