"""The int8 strip conv route (``strip.conv_strip_int``, the tensor-core
kernel ``csrc/conv_strip.cu::conv_igemm_kernel``) on the CPU.

A CPU tensor takes the kernel's plain version (``conv_strip_int_ref``: the
float64 tap loop and the epilogue), which must equal the reference
package's Pallas ``conv_strip_kernel`` in interpret mode and ``conv_int_ref``
bit for bit (k 3/5/7, stride 2, ragged channels; the epilogue against the
reference kernel's own ``_epilogue`` on that accumulate). ``dispatch.conv_int``'s int route
(uint8 cast, the conv's own border, channels padded to 16) must equal the
reference's pallas backend, dense and grouped. The launch configuration
(``igemm_config``) must cover every output of each ``VGG16_SHAPES`` and
``STRIP_EDGES`` entry in a CTA's shared memory; the route rule, the
overflow guard and the verifier's audit of the new launch are held here
too. The kernel itself runs only on the card (``test_torch_gpu.py``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels.conv_bank import ops as jops
from repro.kernels.conv_bank import strip_kernel as jstrip
from repro.core import quant as jquant
from repro_torch import Options, Program, analysis
from repro_torch.analysis import verifier
from repro_torch.core import quant as tquant
from repro_torch.core.plan import padtype_to_pads
from repro_torch.core.quant import W4A4
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.conv_bank import ops, strip
from repro_torch.kernels.conv_bank.ref import conv_int_ref
from repro_torch.kernels.edge_shapes import STRIP_EDGES, VGG16_SHAPES

CPU = Options(scheme=W4A4, device="cpu", verify="off")

# (b, h_out, w_out, c_in, c_out, k, stride): k 3/5/7, stride 2, ragged
# channels (not a multiple of 16 in, odd out), one channel
PLAIN = [(2, 6, 7, 20, 33, 3, 1), (1, 5, 6, 17, 9, 5, 1),
         (1, 2, 3, 3, 64, 7, 1), (2, 4, 5, 16, 7, 3, 2),
         (1, 3, 4, 1, 1, 5, 2), (1, 4, 4, 40, 3, 3, 1)]


def _operands(rng, b, h, w, ci, co, k, s, qmax=15, levels=7):
    hp, wp = (h - 1) * s + k, (w - 1) * s + k
    x = rng.integers(0, qmax + 1, (b, hp, wp, ci)).astype(np.uint8)
    wq = rng.integers(-levels, levels + 1, (k, k, ci, co)).astype(np.int8)
    return x, wq


@pytest.mark.parametrize("shape", PLAIN)
def test_plain_int_route_bitwise_equal_to_pallas_and_conv_int_ref(shape):
    b, h, w, ci, co, k, s = shape
    rng = np.random.default_rng(sum(shape))
    x, wq = _operands(rng, b, h, w, ci, co, k, s, qmax=255, levels=127)
    ws = (rng.random(co) * 0.1 + 0.01).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wq)
    got = strip.conv_strip_int(xt, wt, stride=s)
    assert got.shape == (b, h, w, co) and got.dtype == torch.float32
    want = jstrip.conv_strip_kernel(
        jnp.asarray(x, jnp.float32), jnp.asarray(wq, jnp.float32),
        jnp.ones((co,), jnp.float32), kk=k, stride=s, strip_h=h,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), conv_int_ref(xt.float(), wt.float(), s,
                                  ((0, 0), (0, 0))).numpy())
    assert torch.equal(got, strip.conv_strip_int_ref(xt, wt, stride=s))
    # the epilogue, a different activation a shape: the reference kernel's
    # own ``_epilogue`` on its accumulate
    act = ("relu", "abs", "sign", "none")[PLAIN.index(shape) % 4]
    epi = jstrip._epilogue(want.reshape(-1, co), 0.37, jnp.asarray(ws),
                           jnp.asarray(bias), act)
    got = strip.conv_strip_int(xt, wt, torch.from_numpy(ws), stride=s,
                               act_scale=0.37, act=act,
                               bias=torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy().reshape(-1, co),
                                  np.asarray(epi))


@pytest.mark.parametrize("shape", PLAIN)
def test_levels_laid_out_once_equal_the_per_call_layout(shape):
    # conv_strip_int_laid on int_codes' operand and int_weights' levels
    # (zero channels up to igemm_c_in) against conv_strip_int on the raw
    # operands, with an epilogue
    b, h, w, ci, co, k, s = shape
    rng = np.random.default_rng(sum(shape) + 1)
    x, wq = _operands(rng, b, h, w, ci, co, k, s, qmax=255, levels=127)
    ws = torch.from_numpy((rng.random(co) * 0.1 + 0.01).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    xt, wt = torch.from_numpy(x), torch.from_numpy(wq)
    iw = strip.int_weights(wt, ws, bias)
    assert iw.w8.shape[2] == strip.igemm_c_in(ci, k)
    x8 = strip.int_codes(xt, k)
    assert x8.shape[-1] == iw.w8.shape[2]
    for act in ("relu", "sign"):
        got = strip.conv_strip_int_laid(x8, iw, stride=s, act_scale=0.37,
                                        act=act)
        want = strip.conv_strip_int(xt, wt, ws, stride=s, act_scale=0.37,
                                    act=act, bias=bias)
        assert torch.equal(got, want)


# (h, w, c_in, c_out, k, stride, padding, groups)
CONV_INT = {
    "dense_k3": (9, 11, 16, 24, 3, 1, "SAME", 1),
    "dense_k5_ragged": (8, 7, 20, 5, 5, 1, "SAME", 1),
    "dense_cout64": (7, 8, 3, 64, 3, 1, "SAME", 1),
    "stride2_valid": (13, 11, 18, 6, 3, 2, "VALID", 1),
    "grouped": (8, 8, 32, 12, 3, 1, "SAME", 2),
}


@pytest.mark.parametrize("name", sorted(CONV_INT))
def test_conv_int_int_route_bitwise_equal_to_reference_pallas(name):
    h, w, ci, co, k, s, padding, groups = CONV_INT[name]
    rng = np.random.default_rng(len(name))
    x = rng.integers(0, 16, (2, h, w, ci)).astype(np.float32)
    wq = rng.integers(-7, 8, (k, k, ci // groups, co)).astype(np.float32)
    pads = padtype_to_pads((h, w), k, s, padding)
    h_out = (h + sum(pads[0]) - k) // s + 1
    w_out = (w + sum(pads[1]) - k) // s + 1
    strat = dispatch.select_conv_strategy(h_out, w_out, ci, co, k, s, groups,
                                          mode="strip", budget=1024)
    jstrat = jdispatch.select_conv_strategy(h_out, w_out, ci, co, k, s,
                                            groups, mode="strip",
                                            budget=1024)
    assert dispatch.select_strip_route(ci, co, k, s, groups) == "int"
    with jdispatch.use_backend("pallas"), jdispatch.use_interpret(True):
        want = np.asarray(jdispatch.conv_int(jnp.asarray(x), jnp.asarray(wq),
                                             s, pads, groups, jstrat))
    reset_launch_counts()
    got = dispatch.conv_int(torch.from_numpy(x), torch.from_numpy(wq), s,
                            pads, groups, strat, route="int")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the route resolved with the strategy, and the float64 route: the same
    np.testing.assert_array_equal(dispatch.conv_int(
        torch.from_numpy(x), torch.from_numpy(wq), s, pads, groups,
        strat).numpy(), want)
    np.testing.assert_array_equal(dispatch.conv_int(
        torch.from_numpy(x), torch.from_numpy(wq), s, pads, groups, strat,
        route="float").numpy(), want)
    np.testing.assert_array_equal(conv_int_ref(
        torch.from_numpy(x), torch.from_numpy(wq), s, pads, groups).numpy(),
        want)
    assert launch_counts()["conv_strip_int"] == 0


def test_conv_bank_op_int_route_bitwise_equal_to_reference():
    """The op's quantized path at 16 -> 32 channels takes the int route in
    both strategies: bitwise the reference op at act_scale 1 and its
    written semantics (``conv_bank_quant_ref``) otherwise."""
    from repro.kernels.conv_bank.ref import conv_bank_quant_ref as jref
    rng = np.random.default_rng(5)
    x = rng.random((2, 9, 9, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 32)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(32) * 0.2).astype(np.float32)
    assert strip.dense_route(16, 32, 3, 1) == "int"
    for strategy in ("resident", "strip"):
        got = ops.conv_bank(torch.from_numpy(x), torch.from_numpy(w),
                            spec=tquant.W4A4, act_scale=1.0,
                            strategy=strategy, act="relu",
                            bias=torch.from_numpy(b))
        want = jops.conv_bank(jnp.asarray(x), jnp.asarray(w),
                              spec=jquant.W4A4, act_scale=1.0,
                              strategy=strategy, act="relu",
                              bias=jnp.asarray(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = ops.conv_bank(torch.from_numpy(x), torch.from_numpy(w),
                            spec=tquant.W4A4, strategy=strategy)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jref(jnp.asarray(x), jnp.asarray(w), jquant.W4A4)))


def _vgg16_entries():
    for name, rows, _, w_out, ci, co, k, s in VGG16_SHAPES["conv_strip"]:
        for b in (1, 8):
            yield (name, b, w_out, w_out, ci, co, k, s)   # its own rows


@pytest.mark.parametrize("entry", [*_vgg16_entries(),
                                   *[("edge", *e) for e in STRIP_EDGES]])
def test_igemm_config_covers_the_output_in_shared_memory(entry):
    _, b, h, w, ci, co, k, s = entry
    cfg = strip.igemm_config(b, h, w, ci, co, k, s)
    assert cfg.smem <= strip.SMEM_MAX == 232448
    # the verifier's own restatement of the launcher's layout
    assert verifier._int_smem(cfg, k, s) == cfg.smem
    if cfg.form == "wgmma":
        # stride 1, C_in a multiple of 16: tiles of 8 x 8 blocks, two
        # warpgroups of one or two m64 blocks, C_in in ch-byte chunks
        assert s == 1 and ci % 16 == 0 and cfg.kf == 0
        assert cfg.smem == strip.wgmma_smem(cfg.th, cfg.tw, cfg.bn, k,
                                            cfg.ch, cfg.stages)
        assert cfg.th % 8 == 0 and cfg.tw % 8 == 0
        assert cfg.th * cfg.tw in (128, 256)
        assert cfg.bn in strip.WG_BN and cfg.bn >= min(co, 64)
        chunks = -(-ci // cfg.ch)
        assert cfg.ch in strip.WG_CH
        assert 1 <= cfg.stages <= min(chunks, strip.WG_MAX_STAGES)
        assert chunks == 1 or cfg.stages >= 2
    else:
        assert cfg.smem == cfg.stages * strip.igemm_stage_bytes(
            cfg.th, cfg.tw, cfg.bn, k, s, cfg.kf)
        assert 1 <= cfg.th * cfg.tw <= strip.IGEMM_BM and cfg.th <= h
        assert cfg.bn in strip.IGEMM_BN and cfg.bn >= min(co, 64)
        assert cfg.stages == (2 if strip.igemm_c_in(ci, k) > strip.IGEMM_CH
                              else 1)
        # C_in <= 4 folds its taps into K (k*k*4 bytes rounded up to 32)
        assert cfg.kf == (-(-k * k * 4 // 32) * 32
                          if ci <= 4 and k * k * 4 <= 128 else 0)
        assert cfg.form == ("taps" if cfg.kf else "mma")
        assert cfg.k_inst == (3 if k == 3 else 0)
    row_tiles, col_tiles = -(-h // cfg.th), -(-w // cfg.tw)
    assert cfg.ctas == b * row_tiles * col_tiles * -(-co // cfg.bn)
    # every output pixel in exactly one tile's slots; every slot's patch
    # reads inside the staged patch
    assert row_tiles * cfg.th >= h and col_tiles * cfg.tw >= w
    assert (row_tiles - 1) * cfg.th < h and (col_tiles - 1) * cfg.tw < w
    cols_in = (cfg.tw - 1) * s + k
    rows_in = (cfg.th - 1) * s + k
    last = ((cfg.th - 1) * s + k - 1) * cols_in + (cfg.tw - 1) * s + k - 1
    assert last == rows_in * cols_in - 1


def test_igemm_config_fits_on_ragged_shapes():
    rng = np.random.default_rng(25)
    for _ in range(300):
        b, h, w = (int(v) for v in rng.integers(1, (9, 300, 300)))
        ci, co = (int(v) for v in rng.integers(1, (600, 600)))
        k = int(rng.choice([1, 2, 3, 4, 5, 7, 9, 11]))
        s = int(rng.choice([1, 1, 2, 4]))
        if strip.dense_route(ci, co, k, s) != "int":
            continue
        cfg = strip.igemm_config(b, h, w, ci, co, k, s)
        assert cfg.smem <= strip.SMEM_MAX, (b, h, w, ci, co, k, s, cfg)
        assert cfg.th * cfg.tw <= (256 if cfg.form == "wgmma"
                                   else strip.IGEMM_BM)
        assert cfg.ctas == b * -(-h // cfg.th) * -(-w // cfg.tw) * \
            -(-co // cfg.bn)


def test_route_rule():
    # the default and the measured thresholds
    assert strip.dense_route(16, 1, 3, 1) == "int"
    assert strip.dense_route(15, 63, 3, 1) == "float"
    assert strip.dense_route(3, 64, 3, 1) == "int"      # folded: conv1
    # C_out >= 64 moves only the folded form: 5-15 channels, or k*k*4 past
    # 128, stay where nothing measured the int route faster
    assert strip.dense_route(8, 64, 3, 1) == "float"
    assert strip.dense_route(15, 512, 3, 1) == "float"
    assert strip.dense_route(3, 64, 7, 1) == "float"
    for ci, co, k in ((1, 1, 5), (4, 1, 3), (3, 3, 3), (2, 3, 5)):
        assert strip.dense_route(ci, co, k, 1) == "float"
    # past int32, or past a CTA's shared memory: the float64 kernel
    assert not strip.int_exact(832, 9) and strip.int_exact(816, 9)
    assert strip.dense_route(832, 64, 9, 1) == "float"
    assert strip.dense_route(64, 64, 25, 1) == "float"
    # depthwise has no dense route; a grouped conv's is its group's
    assert dispatch.select_strip_route(32, 32, 3, 1, groups=32) is None
    assert dispatch.select_strip_route(32, 16, 3, 1, groups=2) == "int"
    assert dispatch.select_strip_route(8, 8, 3, 1, groups=2) == "float"
    # compiled plans carry it: VGG16's strip convs all int; the imaging
    # pipelines' dense strips float; resident and depthwise steps none
    plan = Program.from_model("vgg16", params={}).compile(CPU).plan
    assert plan.strip_routes == {f"conv{i}": "int" for i in range(1, 11)}
    for name in ("unsharp_mask", "denoise_gauss", "edge_detect"):
        plan = Program.from_pipeline(name, 256, 256).compile(CPU).plan
        assert plan.strip_routes == {
            s.name: "float" for s in plan.steps
            if type(s).__name__ == "ConvStep" and s.strategy.kind == "strip"
            and not s.geom.depthwise}


@pytest.mark.parametrize("ci,k", [(3, 3), (3, 7), (20, 3), (32, 5)])
def test_int_operands_pad_border_and_channels_in_one_form(ci, k):
    rng = np.random.default_rng(ci * 10 + k)
    codes = torch.from_numpy(rng.integers(0, 256, (2, 5, 6, ci))).float()
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, ci, 8))).float()
    pads = ((1, 2), (0, 1))
    x8, w8 = strip.int_operands(codes, wq, pads)
    cpad = strip.igemm_c_in(ci, k) - ci
    assert x8.dtype == torch.uint8 and w8.dtype == torch.int8
    assert torch.equal(x8, torch.nn.functional.pad(
        codes, (0, cpad, 0, 1, 1, 2)).to(torch.uint8))
    assert torch.equal(w8, torch.nn.functional.pad(
        wq, (0, 0, 0, cpad)).to(torch.int8))
    # operands already in the form come back as they are
    x0, w0 = strip.int_operands(x8, w8)
    assert x0 is x8 and w0 is w8
    # the zero channels add nothing: the plain route on them is conv_int_ref
    assert torch.equal(strip.conv_strip_int_ref(x8, w8),
                       conv_int_ref(codes, wq, 1, pads).float())


def test_overflow_guard_and_operand_checks():
    x = torch.zeros((1, 9, 9, 832), dtype=torch.uint8)
    w = torch.zeros((9, 9, 832, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="2\\^31"):
        strip.conv_strip_int(x, w)
    with pytest.raises(ValueError, match="2\\^31"):
        strip.conv_strip_int_ref(x, w)
    x = torch.zeros((1, 5, 5, 16), dtype=torch.uint8)
    w = torch.zeros((3, 3, 16, 4), dtype=torch.int8)
    assert strip.conv_strip_int(x, w).shape == (1, 3, 3, 4)
    with pytest.raises(ValueError, match="uint8 codes"):
        strip.conv_strip_int(x.float(), w)
    with pytest.raises(ValueError, match="uint8 codes"):
        strip.conv_strip_int(x, w.float())
    with pytest.raises(ValueError, match="C_in"):
        strip.conv_strip_int(x, torch.zeros((3, 3, 8, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="need ws"):
        strip.conv_strip_int(x, w, act="relu")


def test_audit_catches_an_int_launch_that_does_not_cover(monkeypatch):
    """Planted int8 launches: half the CTAs (LTR020 on every int-routed
    conv, none elsewhere), a tile past the kernel's 128 pixel slots
    (LTR020), a shared-memory layout a CTA cannot hold (LTR022)."""
    plan = Program.from_model("vgg16", params={}).compile(CPU).plan
    assert analysis.verify_plan(plan, include_info=False) == ()
    real = strip.igemm_config

    def codes(fn):
        monkeypatch.setattr(strip, "igemm_config", fn)
        found = {(d.code, d.severity, d.step)
                 for d in analysis.verify_plan(plan, include_info=False)}
        monkeypatch.setattr(strip, "igemm_config", real)
        return found

    found = codes(lambda *a: dataclasses.replace(real(*a),
                                                 ctas=real(*a).ctas // 2))
    assert found == {("LTR020", "error", f"conv{i}") for i in range(1, 11)}
    found = codes(lambda *a: dataclasses.replace(real(*a), th=129, tw=1))
    assert ("LTR020", "error", "conv5") in found
    found = codes(lambda *a: dataclasses.replace(real(*a), stages=8))
    assert ("LTR022", "warning", "conv10") in found
    assert not {d for d in found if d[0] != "LTR022"}
