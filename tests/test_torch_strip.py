"""repro_torch strip conv kernels and the conv_bank op against JAX.

The strip kernels' wrappers on CPU tensors run their plain versions; those
must equal the reference package's Pallas ``conv_strip_kernel`` and
``conv_strip_depthwise_kernel`` in interpret mode bit for bit: several
strips (a pinned strip height), stride 2, VALID padding, and the fused
epilogue with bias and each activation. ``conv_int`` with a strip strategy
(groups 1, 2 and depthwise) must equal the reference's pallas backend.

One stated deviation: at ``act_scale != 1`` the interpret-mode Pallas
epilogue computes ``acc * (act_scale * ws)`` (XLA reassociates the
constant), not the ``acc * act_scale * ws`` its source writes, and differs
from the written expression by up to 2 ulp of the dequantized value (and
the rounding of a bias added after it) on about a third of the outputs:
two roundings, each in another place. The
port follows the written expression; there it is held bitwise against the
reference's own ``_epilogue`` evaluated op by op on the Pallas
accumulate (and against ``conv_bank_quant_ref``), and within those 2 ulp
of the interpret-mode kernel.

The ``conv_bank`` op must equal the reference's in both strategies:
bitwise on the quantized path (as above), within the reference's own 1e-5
in float mode (the kernels sum float products in their own order there).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.kernels.conv_bank import ops as jops
from repro.kernels.conv_bank import strip_kernel as jstrip
from repro_torch.core import quant as tquant
from repro_torch.core.plan import padtype_to_pads
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.conv_bank import ops, strip
from repro_torch.kernels.conv_bank.ref import (conv_bank_quant_ref,
                                               conv_bank_ref, conv_int_ref)


def _codes(rng, shape):
    return rng.integers(0, 16, shape).astype(np.float32)


def _padded(rng, b, h, w, c, k, stride, strip_h, n_strips, padding="SAME"):
    """Codes padded as the dispatch strip path pads them."""
    x = _codes(rng, (b, h, w, c))
    (plo, phi), (qlo, qhi) = padtype_to_pads((h, w), k, stride, padding)
    xp = np.pad(x, ((0, 0), (plo, phi), (qlo, qhi), (0, 0)))
    want = np.asarray(jstrip.pad_rows_for_strips(jnp.asarray(xp), k, stride,
                                                 strip_h, n_strips))
    got = strip.pad_rows_for_strips(torch.from_numpy(xp), k, stride,
                                    strip_h, n_strips)
    np.testing.assert_array_equal(got.numpy(), want)
    return want


# (b, h, w, c_in, c_out, k, stride, padding, strip_h, n_strips)
DENSE = {
    "two_strips": (2, 12, 10, 3, 4, 3, 1, "SAME", 6, 2),
    "three_strips_k5": (1, 9, 9, 2, 1, 5, 1, "SAME", 3, 3),
    "stride2_valid": (2, 13, 11, 3, 5, 3, 2, "VALID", 3, 2),
    "stride2_same": (1, 12, 12, 4, 3, 3, 2, "SAME", 2, 3),
}
# (epilogue) act_scale, act, bias
EPILOGUES = {"raw": None, "relu_bias": (1.0, "relu", True),
             "abs_scaled": (1.0 / 15.0, "abs", False),
             "sign_bias_scaled": (0.11, "sign", True)}


def _check_epilogue(got, want_kernel, raw, act_scale, ws, bias, act):
    """Bitwise where XLA cannot reassociate (act_scale 1); otherwise
    bitwise against the written expression and within 2 ulp of the
    interpret-mode kernel."""
    want_kernel = np.asarray(want_kernel)
    if act_scale == 1.0:
        np.testing.assert_array_equal(got, want_kernel)
        return
    written = jstrip._epilogue(jnp.asarray(raw), act_scale, jnp.asarray(ws),
                               None if bias is None else jnp.asarray(bias),
                               act)
    np.testing.assert_array_equal(got, np.asarray(written))
    # 2 ulp of the dequantized accumulate, plus the rounding of a bias add
    dequant = np.asarray(raw) * np.float32(act_scale) * np.asarray(ws)
    assert np.all(np.abs(got - want_kernel) <= 2 * np.spacing(
        np.abs(dequant).astype(np.float32)) + np.spacing(np.abs(got)))


@pytest.mark.parametrize("name,epi", [
    *[(name, "raw") for name in sorted(DENSE)],
    ("two_strips", "relu_bias"), ("stride2_valid", "abs_scaled"),
    ("three_strips_k5", "sign_bias_scaled")])
def test_dense_strip_plain_bitwise_equal_to_pallas(name, epi):
    b, h, w, ci, co, k, s, padding, sh, ns = DENSE[name]
    rng = np.random.default_rng(len(name) + len(epi))
    xp = _padded(rng, b, h, w, ci, k, s, sh, ns, padding)
    wq = rng.integers(-7, 8, (k, k, ci, co)).astype(np.float32)
    ws = (rng.random(co) * 0.1 + 0.01).astype(np.float32)
    kw = dict(kk=k, stride=s, strip_h=sh, interpret=True)
    tkw = dict(stride=s, strip_h=sh)
    if EPILOGUES[epi] is None:
        want = jstrip.conv_strip_kernel(jnp.asarray(xp), jnp.asarray(wq),
                                        jnp.ones((co,), jnp.float32), **kw)
        got = strip.conv_strip(torch.from_numpy(xp), torch.from_numpy(wq),
                               **tkw)
    else:
        act_scale, act, has_bias = EPILOGUES[epi]
        bias = rng.standard_normal(co).astype(np.float32) if has_bias \
            else None
        want = jstrip.conv_strip_kernel(
            jnp.asarray(xp), jnp.asarray(wq), jnp.asarray(ws),
            act_scale=act_scale, quantized=True, act=act,
            bias=None if bias is None else jnp.asarray(bias), **kw)
        raw = jstrip.conv_strip_kernel(jnp.asarray(xp), jnp.asarray(wq),
                                       jnp.ones((co,), jnp.float32), **kw)
        got = strip.conv_strip(
            torch.from_numpy(xp), torch.from_numpy(wq), torch.from_numpy(ws),
            act_scale=act_scale, act=act,
            bias=None if bias is None else torch.from_numpy(bias), **tkw)
        _check_epilogue(got.numpy(), want, raw, act_scale, ws, bias, act)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,stride,strip_h,n_strips,epi", [
    (3, 1, 4, 3, "raw"), (5, 1, 8, 2, "raw"), (3, 2, 3, 2, "raw"),
    (5, 1, 8, 2, "relu_bias"), (3, 2, 3, 2, "sign_bias_scaled")])
def test_depthwise_strip_plain_bitwise_equal_to_pallas(k, stride, strip_h,
                                                       n_strips, epi):
    rng = np.random.default_rng(k * 10 + stride)
    c = 3
    xp = _padded(rng, 2, 12, 12, c, k, stride, strip_h, n_strips)
    taps = rng.integers(-7, 8, (k * k, c)).astype(np.float32)
    ws = (rng.random(c) * 0.1 + 0.01).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    kw = dict(kk=k, stride=stride, strip_h=strip_h, interpret=True)
    if epi == "raw":
        want = jstrip.conv_strip_depthwise_kernel(
            jnp.asarray(xp), jnp.asarray(taps), jnp.ones((c,), jnp.float32),
            **kw)
        got = strip.conv_strip_depthwise(torch.from_numpy(xp),
                                         torch.from_numpy(taps),
                                         stride=stride, strip_h=strip_h)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    act_scale, act, _ = EPILOGUES[epi]
    want = jstrip.conv_strip_depthwise_kernel(
        jnp.asarray(xp), jnp.asarray(taps), jnp.asarray(ws),
        act_scale=act_scale, quantized=True, act=act,
        bias=jnp.asarray(bias), **kw)
    raw = jstrip.conv_strip_depthwise_kernel(
        jnp.asarray(xp), jnp.asarray(taps), jnp.ones((c,), jnp.float32), **kw)
    got = strip.conv_strip_depthwise(
        torch.from_numpy(xp), torch.from_numpy(taps), torch.from_numpy(ws),
        stride=stride, strip_h=strip_h, act_scale=act_scale, act=act,
        bias=torch.from_numpy(bias))
    _check_epilogue(got.numpy(), want, raw, act_scale, ws, bias, act)


# (h, w, c_in, c_out, k, stride, padding, groups, budget)
CONV_INT = {
    "dense_strips": (12, 12, 3, 4, 3, 1, "SAME", 1, 2048),
    "stride2_valid": (13, 11, 3, 5, 3, 2, "VALID", 1, 1024),
    "groups2": (10, 10, 4, 6, 3, 1, "SAME", 2, 2048),
    "depthwise_k5": (12, 12, 3, 3, 5, 1, "SAME", 3, 1024),
}


@pytest.mark.parametrize("name", sorted(CONV_INT))
def test_conv_int_strip_bitwise_equal_to_reference_pallas(name):
    h, w, ci, co, k, s, padding, groups, budget = CONV_INT[name]
    rng = np.random.default_rng(len(name))
    x = _codes(rng, (2, h, w, ci))
    wq = rng.integers(-7, 8, (k, k, ci // groups, co)).astype(np.float32)
    pads = padtype_to_pads((h, w), k, s, padding)
    h_out = (h + sum(pads[0]) - k) // s + 1
    w_out = (w + sum(pads[1]) - k) // s + 1
    strat = dispatch.select_conv_strategy(h_out, w_out, ci, co, k, s, groups,
                                          mode="strip", budget=budget)
    jstrat = jdispatch.select_conv_strategy(h_out, w_out, ci, co, k, s,
                                            groups, mode="strip",
                                            budget=budget)
    assert strat.n_strips >= 2 and strat == dispatch.ConvStrategy(
        jstrat.kind, jstrat.strip_rows, jstrat.n_strips)
    with jdispatch.use_backend("pallas"), jdispatch.use_interpret(True):
        want = np.asarray(jdispatch.conv_int(jnp.asarray(x), jnp.asarray(wq),
                                             s, pads, groups, jstrat))
    got = dispatch.conv_int(torch.from_numpy(x), torch.from_numpy(wq), s,
                            pads, groups, strat)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        conv_int_ref(torch.from_numpy(x), torch.from_numpy(wq), s, pads,
                     groups).numpy(), want)


def test_strip_wrappers_count_no_launch_on_cpu_and_check_the_contract():
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(_codes(rng, (1, 10, 8, 2)))
    w = torch.ones((3, 3, 2, 1))
    reset_launch_counts()
    strip.conv_strip(xp, w, strip_h=4)            # 8 output rows, 2 strips
    strip.conv_strip_depthwise(xp, torch.ones((9, 2)), strip_h=8)
    assert launch_counts()["conv_strip"] == 0
    assert launch_counts()["conv_strip_depthwise"] == 0
    with pytest.raises(ValueError, match="multiple of strip_h"):
        strip.conv_strip(xp, w, strip_h=3)
    with pytest.raises(ValueError, match="need ws"):
        strip.conv_strip(xp, w, strip_h=4, act="relu")
    with pytest.raises(ValueError, match="k\\*k, C"):
        strip.conv_strip_depthwise(xp, torch.ones((8, 2)), strip_h=8)


def _bank_inputs(k, c_in=3, c_out=4, hw=8, seed=0):
    rng = np.random.default_rng(seed + k)
    x = rng.random((2, hw, hw, c_in)).astype(np.float32)
    w = (rng.standard_normal((k, k, c_in, c_out)) * 0.3).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32) * 0.2
    return x, w, b


@pytest.mark.parametrize("k,strategy", [(3, "resident"), (5, "strip")])
def test_conv_bank_quantized_bitwise_equal_to_reference(k, strategy):
    """The reference op's kernels in interpret mode, at its default
    act_scale 1/15, are within 2 ulp (the reassociated epilogue); its
    written semantics, evaluated op by op, are bitwise."""
    from repro.kernels.conv_bank.ref import conv_bank_quant_ref as jquant_ref
    from repro.kernels.conv_bank.ref import conv_taps_int as jtaps
    x, w, b = _bank_inputs(k)
    spec, act_scale = jquant.W4A4, 1.0 / 15.0
    codes = jnp.clip(jnp.round(jnp.asarray(x) / act_scale), 0, spec.a_qmax)
    wq, ws = jquant.quantize_weight(jnp.asarray(w), spec)
    raw = jtaps(codes, wq, k, 1, ((k // 2, k // 2), (k // 2, k // 2)))
    for act, bias in (("none", None), ("relu", b), ("abs", b)):
        kernel = jops.conv_bank(jnp.asarray(x), jnp.asarray(w), spec=spec,
                                strategy=strategy, act=act,
                                bias=None if bias is None
                                else jnp.asarray(bias))
        got = ops.conv_bank(torch.from_numpy(x), torch.from_numpy(w),
                            spec=tquant.W4A4, strategy=strategy, act=act,
                            bias=None if bias is None
                            else torch.from_numpy(bias)).numpy()
        _check_epilogue(got, kernel, raw, act_scale, ws.reshape(-1), bias,
                        act)
        if act == "none":
            np.testing.assert_array_equal(
                got, np.asarray(jquant_ref(jnp.asarray(x), jnp.asarray(w),
                                           spec)))
            np.testing.assert_array_equal(
                got, conv_bank_quant_ref(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         tquant.W4A4).numpy())
    # at act_scale 1 nothing can be reassociated: bitwise to the kernels
    kernel = jops.conv_bank(jnp.asarray(x), jnp.asarray(w), spec=spec,
                            act_scale=1.0, strategy=strategy, act="relu",
                            bias=jnp.asarray(b))
    got = ops.conv_bank(torch.from_numpy(x), torch.from_numpy(w),
                        spec=tquant.W4A4, act_scale=1.0, strategy=strategy,
                        act="relu", bias=torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))


@pytest.mark.parametrize("strategy", ["resident", "strip"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_bank_float_mode_within_reference_tolerance(strategy, padding):
    x, w, _ = _bank_inputs(3, seed=4)
    want = np.asarray(jops.conv_bank(jnp.asarray(x), jnp.asarray(w),
                                     padding=padding, strategy=strategy))
    got = ops.conv_bank(torch.from_numpy(x), torch.from_numpy(w),
                        padding=padding, strategy=strategy).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, conv_bank_ref(torch.from_numpy(x), torch.from_numpy(w),
                           padding).numpy(), rtol=1e-5, atol=1e-5)


def test_conv_bank_plain_is_the_cpu_path_and_counts_nothing():
    x, w, b = _bank_inputs(7, hw=12)
    args = (torch.from_numpy(x), torch.from_numpy(w))
    kw = dict(spec=tquant.W4A4, act="relu", bias=torch.from_numpy(b))
    reset_launch_counts()
    for strategy in ("resident", "strip"):
        assert torch.equal(ops.conv_bank(*args, strategy=strategy, **kw),
                           ops.conv_bank_plain(*args, strategy=strategy,
                                               **kw))
    assert launch_counts()["conv_bank"] == 0
    with pytest.raises(ValueError, match="padding"):
        ops.conv_bank(*args, padding="FULL")


# the dense strip kernel's calls: (batch, n_rows, w_out, c_in, c_out, k,
# stride) -- the imaging path at bucket 8 (unsharp, rec2), the 512x512
# multi-strip rec2 (batch 2, 3 strips), the conv_bank op's convs and the
# VGG16-like layer of the chip smoke test
STRIP_PATH_SHAPES = [(8, 256, 256, 1, 1, 5, 1), (8, 256, 256, 4, 1, 3, 1),
                     (2, 513, 512, 4, 1, 3, 1), (8, 32, 32, 16, 32, 3, 1),
                     (8, 32, 32, 16, 32, 5, 1), (8, 32, 32, 16, 32, 7, 1),
                     (2, 56, 56, 64, 128, 3, 1)]


def _assert_strip_legal(cfg, b, h, w, ci, co, k, s):
    assert cfg.smem <= strip.SMEM_MAX
    assert (cfg.co_b, cfg.run, cfg.tx * cfg.tyt) in strip.DENSE_SHAPES
    assert cfg.tx in (32, 64) and 1 <= cfg.cc <= ci
    assert cfg.stages == (2 if ci > cfg.cc else 1)
    assert cfg.k_inst == (k if s == 1 and k in strip.FAST_K else 0)
    assert cfg.ctas == b * -(-h // (cfg.tyt * cfg.run)) * \
        -(-w // cfg.tx) * -(-co // cfg.co_b)
    # a thread's output channels never exceed what the conv has but for
    # the block size the kernel is built for
    assert cfg.co_b <= (1 if co == 1 else 4 if co <= 4 else 8)


@pytest.mark.parametrize("shape", STRIP_PATH_SHAPES)
def test_strip_config_is_legal_and_fills_the_card_at_path_shapes(shape):
    cfg = strip.strip_config(*shape)
    _assert_strip_legal(cfg, *shape)
    assert cfg.ctas >= 132


def test_strip_config_is_legal_on_ragged_shapes():
    rng = np.random.default_rng(17)
    for _ in range(300):
        b, h, w = (int(v) for v in rng.integers(1, (9, 300, 300)))
        ci, co = (int(v) for v in rng.integers(1, (70, 140)))
        k = int(rng.choice([1, 2, 3, 4, 5, 7, 9, 11]))
        s = int(rng.choice([1, 1, 2, 4]))
        _assert_strip_legal(strip.strip_config(b, h, w, ci, co, k, s),
                            b, h, w, ci, co, k, s)


def test_strip_config_stage_bytes_match_the_kernel_layout():
    # 16 x 64 tile, k 5, 2 channels: rows 20, row of 68 floats (64 + 4,
    # a multiple of 4); weights 25 x 2 x 4 as float32 (16-byte rounded)
    # and float64
    assert strip.stage_bytes(64, 2, 8, 4, 2, 5, 1) == \
        2 * 20 * 68 * 4 + 800 + 25 * 2 * 4 * 8
    # large k at a large stride: shapes that overflow a CTA are passed over
    cfg = strip.strip_config(1, 8, 8, 2, 16, 11, 4)
    assert cfg.smem <= strip.SMEM_MAX


# the depthwise kernel's launch configuration (strip.dw_config) over a grid
# of channels, k and stride, and the two path calls
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 16, 17])
@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (7, 1), (4, 1),
                                      (3, 2), (5, 2), (9, 2), (11, 4)])
def test_dw_config_is_legal_and_covers_the_output(c, k, stride):
    for b, h, w in ((8, 256, 256), (2, 37, 67), (1, 9, 11), (3, 1, 1)):
        cfg = strip.dw_config(b, h, w, c, k, stride)
        assert cfg.k_inst == (k if stride == 1 and k in strip.FAST_K else 0)
        assert cfg.run == (strip.DW_FAST_RUN if cfg.k_inst else strip.DW_RUN)
        assert cfg.cb == (c if c in (1, 3) else 4)
        assert cfg.tx in (32, 64) and cfg.tx * cfg.tyt in strip.DW_THREADS
        assert cfg.tx == 32 or w > 32
        assert cfg.smem == strip.dw_bytes(cfg.tx, cfg.tyt, cfg.run, cfg.cb,
                                          k, stride) <= strip.SMEM_MAX
        # the tiles cover every output row, column and channel
        rows, cols = cfg.tyt * cfg.run, cfg.tx
        assert cfg.ctas == b * -(-h // rows) * -(-w // cols) * \
            -(-c // cfg.cb)


@pytest.mark.parametrize("k", [3, 5])
def test_dw_config_fills_the_card_at_the_path_shapes(k):
    cfg = strip.dw_config(8, 256, 256, 3, k, 1)
    assert (cfg.k_inst, cfg.cb, cfg.tx) == (k, 3, 64)
    assert cfg.ctas >= strip.SMS


def test_dw_bytes_match_the_kernel_layout():
    # 64 x 16 tile, k 5, 3 channels: 20 rows of 68 * 3 = 204 floats (+ 4
    # for the row's phase), an int a row, then 25 * 3 taps as float64
    xs = 20 * 208 * 4 + 20 * 4
    assert strip.dw_bytes(64, 2, 8, 3, 5, 1) == -(-xs // 8) * 8 + 75 * 8
