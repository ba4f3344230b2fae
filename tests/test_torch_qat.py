"""repro_torch's QAT half on the CPU against the JAX reference.

The same numpy inputs, made from a seed, go through the reference
package's functions (called eagerly, as its own tests call them; its
photonic_mvm kernel in Pallas interpret mode) and the port's:

* the QAT functions of ``core/quant.py``: forward bitwise; the STE
  gradients with a planted value on each clip bound, where the port's clip
  splits a tie's gradient as ``jnp.clip`` does;
* ``nn.layers``: ``dense`` in every mode (``"kernel"`` and ``"qweights"``
  bitwise), ``conv2d``, the pools, embedding and norms, the initializers;
* the photonic_mvm float API (``photonic_mvm``, ``photonic_mvm_prequant``,
  ``photonic_mvm_ref``) on signed inputs and ragged shapes;
* the optimizer: global norm, clip, schedules and five AdamW steps from
  the same gradients.

Every tolerance is stated where it is used, with its reason.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.photonic_mvm import ops as jops
from repro.kernels.photonic_mvm import ref as jref
from repro.nn import layers as JL
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import schedule as jsched
from repro_torch.core import quant as tq
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.photonic_mvm import ops as tops
from repro_torch.kernels.photonic_mvm import ref as tref
from repro_torch.nn import layers as TL
from repro_torch.nn import module as tmodule
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import clip as tclip
from repro_torch.optim import schedule as tsched

SPECS = {"w4a4": (jq.W4A4, tq.W4A4), "w3a4": (jq.W3A4, tq.W3A4),
         "w2a4": (jq.W2A4, tq.W2A4)}
# float32 sums of K products taken in another order (XLA's dot or conv
# against PyTorch's): each rounds at most K times, so the two differ by a
# few ulp of the largest partial sum at the widths here (K <= 300)
SUM_RTOL, SUM_ATOL = 2e-5, 2e-6


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _top(scale):
    """The float32 x with x / scale == 15 exactly, where there is one (at
    scale 1/15 there is none: 1.0 / f32(1/15) rounds to 15 - 2^-20)."""
    s = np.float32(scale)
    x = np.float32(15 * s)
    for c in (x, np.nextafter(x, np.float32(0)), np.nextafter(x, 2 * x)):
        if c / s == np.float32(15):
            return c
    return None


def _acts(rng, shape, scale=1.0 / 15.0):
    """Non-negative activations over the CRC's range and past it, with
    planted values on both clip bounds (0 and, where a float32 reaches it,
    15 steps) and on rounding ties (k + 0.5 steps, rounded half to even)."""
    x = (rng.random(shape) * 1.2).astype(np.float32)
    flat = x.reshape(-1)
    flat[:4] = 0.0
    top = _top(scale)
    flat[4:8] = np.float32(15 * np.float32(scale)) if top is None else top
    flat[8:12] = np.float32(scale) * np.float32([0.5, 1.5, 2.5, 14.5])
    return x


# -- the QAT functions --------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("scale", [1.0 / 15.0, 0.05, 1.0 / 16.0])
def test_fake_quant_act_bitwise(train, scale):
    x = _acts(np.random.default_rng(1), (7, 33), scale)
    want = _np(jq.fake_quant_act(jnp.asarray(x), scale, train=train))
    got = tq.fake_quant_act(_t(x), scale, train=train).numpy()
    np.testing.assert_array_equal(got, want)


def test_crc_quantize_act_and_act_scale_bitwise():
    x = _acts(np.random.default_rng(2), (5, 40))
    for scale in (1.0 / 15.0, 0.07):
        want = _np(jq.crc_quantize_act(jnp.asarray(x), scale))
        got = tq.crc_quantize_act(_t(x), scale)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    for m in (1.0, 0.73, np.float32(3.1)):
        np.testing.assert_array_equal(
            tq.act_scale_for_range(m).numpy(),
            _np(jq.act_scale_for_range(m)))


def _weights(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w.reshape(-1)[:3] = 0.0
    return w


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("shape", [(3, 3, 4, 6), (20, 9)])
def test_weight_scale_and_fake_quant_weight_bitwise(shape, spec, per_channel):
    js, ts = (s if per_channel else
              type(s)(s.w_bits, s.a_bits, per_channel=False)
              for s in SPECS[spec])
    w = _weights(np.random.default_rng(3), shape)
    np.testing.assert_array_equal(
        tq.weight_scale(_t(w), ts.w_bits, per_channel).numpy(),
        _np(jq.weight_scale(jnp.asarray(w), js.w_bits, per_channel)))
    np.testing.assert_array_equal(
        tq.fake_quant_weight(_t(w), ts).numpy(),
        _np(jq.fake_quant_weight(jnp.asarray(w), js)))


def test_weight_scale_on_another_axis_bitwise():
    w = _weights(np.random.default_rng(4), (6, 5, 4))
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(
            tq.weight_scale(_t(w), 3, True, axis).numpy(),
            _np(jq.weight_scale(jnp.asarray(w), 3, True, axis)))


@pytest.mark.parametrize("act_scale", [1.0, 1.0 / 15.0, 0.2])
def test_qmatmul_reference_bitwise(act_scale):
    rng = np.random.default_rng(5)
    x = _acts(rng, (2, 6, 37), act_scale)
    w = _weights(rng, (37, 11))
    np.testing.assert_array_equal(
        tq.qmatmul_reference(_t(x), _t(w), tq.W4A4, act_scale).numpy(),
        _np(jq.qmatmul_reference(jnp.asarray(x), jnp.asarray(w), jq.W4A4,
                                 act_scale)))


def test_mr_noise_draws_from_the_generator():
    """The reference draws the MR noise from ``jax.random``: the port's
    comes from a ``torch.Generator``, so the two agree in distribution
    only. Same generator state, same noise; its std is the spec's."""
    spec = tq.WASpec(4, 4, mr_noise_std=0.3)
    w = _t(_weights(np.random.default_rng(6), (64, 64)))
    a = tq.fake_quant_weight(w, spec,
                             noise_generator=torch.Generator().manual_seed(1))
    b = tq.fake_quant_weight(w, spec,
                             noise_generator=torch.Generator().manual_seed(1))
    clean = tq.fake_quant_weight(w, spec)
    assert torch.equal(a, b) and not torch.equal(a, clean)
    levels = (a - clean) / tq.weight_scale(w, 4)
    assert abs(float(levels.std()) - 0.3) < 0.03      # 4096 draws: ~2% s.e.
    assert abs(float(levels.mean())) < 0.03


def _jax_grad(fn, x, r):
    return _np(jax.grad(lambda v: jnp.sum(fn(v) * r))(jnp.asarray(x)))


def _torch_grad(fn, x, r):
    xt = _t(x).requires_grad_()
    (fn(xt) * _t(r)).sum().backward()
    return xt.grad.numpy()


@pytest.mark.parametrize("scale", [1.0 / 15.0, 1.0 / 16.0])
def test_ste_gradients_of_fake_quant_act_with_ties_on_the_bounds(scale):
    """d/dx of sum(fake_quant_act(x) * r): 1 inside the range, 0 outside,
    and 1/2 on a bound (``jnp.clip`` is maximum then minimum, and both
    split a tie); ``torch.clamp`` would give 1 there. x = 0 sits on the
    lower bound; at scale 1/16 x = 15/16 sits on the upper one. Bitwise:
    the chain is one product and one IEEE division in both packages."""
    rng = np.random.default_rng(7)
    x = _acts(rng, (6, 20), scale)
    r = rng.standard_normal(x.shape).astype(np.float32)
    want = _jax_grad(lambda v: jq.fake_quant_act(v, scale), x, r)
    got = _torch_grad(lambda v: tq.fake_quant_act(v, scale), x, r)
    np.testing.assert_array_equal(got, want)
    s = np.float32(scale)
    full = r.reshape(-1) * s / s
    flat_x, flat_g = x.reshape(-1), got.reshape(-1)
    np.testing.assert_array_equal(flat_g[:4], full[:4] * np.float32(0.5))
    if _top(scale) is not None:
        np.testing.assert_array_equal(flat_g[4:8], full[4:8] * np.float32(0.5))
    assert np.all(flat_g[flat_x / s > 15] == 0.0)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_ste_gradients_of_fake_quant_weight(spec):
    """d/dw through the STE, the clip (each channel's maximum lands on
    +-w_qmax: a tie, half the gradient) and the per-channel scale (its
    max and the division's denominator). Held within 1e-6 relative to the
    largest gradient: the scale's gradient sums a channel's terms in
    another order and divides in float32 in JAX, float64 in the port."""
    js, ts = SPECS[spec]
    rng = np.random.default_rng(8)
    w = _weights(rng, (3, 3, 5, 4))
    r = rng.standard_normal(w.shape).astype(np.float32)
    want = _jax_grad(lambda v: jq.fake_quant_weight(v, js), w, r)
    got = _torch_grad(lambda v: tq.fake_quant_weight(v, ts), w, r)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the planted zeros and the channel maxima reach the bounds' ties
    s = _np(jq.weight_scale(jnp.asarray(w), js.w_bits))
    assert np.sum(np.abs(w / s) == js.w_qmax) >= 1


# -- nn.layers ----------------------------------------------------------------

def _dense_params(rng, k, n, spec=None, exact=False):
    w = rng.standard_normal((k, n)).astype(np.float32)
    if exact:
        # levels on a power-of-two grid: every column's scale is 2^-3 and
        # every product and partial sum of the matmul is exact, so the
        # two packages' matmuls agree in any order
        w = rng.integers(-spec.w_qmax, spec.w_qmax + 1, (k, n))
        w[0] = spec.w_qmax
        w = (w * 0.125).astype(np.float32)
    return {"w": w, "b": (rng.standard_normal(n) * 0.1).astype(np.float32)}


def _signed_x(rng, shape, exact=False):
    if exact:
        return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)
    x = (rng.standard_normal(shape) * 0.6).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, 1.0, -1.0]
    return x


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: _t(v) for k, v in params.items()})


@pytest.mark.parametrize("k,n", [(37, 11), (120, 84)])
def test_dense_qweights_mode_bitwise(k, n):
    rng = np.random.default_rng(k)
    p = _dense_params(rng, k, n, tq.W4A4, exact=True)
    x = _signed_x(rng, (3, 5, k), exact=True)
    jp, tp = _both(p)
    jqp = JL.quantize_dense_params(jp, jq.W4A4)
    tqp = TL.quantize_dense_params(tp, tq.W4A4)
    for key in ("wq", "ws", "b"):
        np.testing.assert_array_equal(tqp[key].numpy(), _np(jqp[key]))
    assert np.all(_np(jqp["ws"]) == 0.125)
    want = _np(JL.dense(jqp, jnp.asarray(x), quant=jq.W4A4, mode="qweights"))
    for params in (tqp, {**tqp, "w": tp["w"]}):
        got = TL.dense(params, _t(x), quant=tq.W4A4, mode="qweights")
        np.testing.assert_array_equal(got.numpy(), want)
    # storage without a quant spec takes the same path
    np.testing.assert_array_equal(TL.dense(tqp, _t(x)).numpy(), want)


@pytest.mark.parametrize("k,n,act_scale", [(1, 1, 1.0), (37, 11, 0.5),
                                            (300, 129, 1.0 / 15.0),
                                            (37, 11, 1.0 / 15.0)])
def test_dense_kernel_mode_against_jax(k, n, act_scale):
    """The kernel mode is bitwise equal to the reference's oracle
    ``photonic_mvm_ref`` always, and to its Pallas kernel in interpret mode
    where the dequant's association cannot matter (act_scale a power of
    two). At 1/15 XLA reassociates the interpret-mode kernel to
    ``acc * (act_scale * ws)``, 1 ulp off its own oracle's
    ``(acc * act_scale) * ws``, which the port's kernel keeps."""
    rng = np.random.default_rng(k * 7 + n)
    p = _dense_params(rng, k, n)
    x = _signed_x(rng, (4, k))
    jp, tp = _both(p)
    reset_launch_counts()
    got = TL.dense(tp, _t(x), quant=tq.W4A4, mode="kernel",
                   act_scale=act_scale).numpy()
    assert launch_counts()["photonic_mvm"] == 0       # the CPU: plain
    oracle = _np(jref.photonic_mvm_ref(jnp.asarray(x), jp["w"], jq.W4A4,
                                       act_scale)) + p["b"]
    np.testing.assert_array_equal(got, oracle)
    want = _np(JL.dense(jp, jnp.asarray(x), quant=jq.W4A4, mode="kernel",
                        act_scale=act_scale))
    if act_scale in (1.0, 0.5):
        np.testing.assert_array_equal(got, want)
    else:
        ulp = np.spacing(np.abs(want - p["b"]).astype(np.float32))
        assert np.all(np.abs(got - want) <= ulp + np.spacing(np.abs(want)))


@pytest.mark.parametrize("spec", [None, "w4a4", "w2a4"])
def test_dense_fake_and_float_modes_against_jax(spec):
    """Fake-quant weights and sign * |x| codes are bitwise (checked above);
    the float matmul after them sums in another order (SUM_RTOL)."""
    js, ts = SPECS[spec] if spec else (None, None)
    rng = np.random.default_rng(11)
    p = _dense_params(rng, 84, 10)
    x = _signed_x(rng, (8, 84))
    jp, tp = _both(p)
    want = _np(JL.dense(jp, jnp.asarray(x), quant=js))
    got = TL.dense(tp, _t(x), quant=ts).numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)


def test_dense_rejects_an_unknown_mode():
    p = {"w": torch.ones(3, 2)}
    with pytest.raises(ValueError, match="unknown quant mode"):
        TL.dense(p, torch.ones(1, 3), quant=tq.W4A4, mode="nope")


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (1, "VALID"),
                                            (2, "SAME"), (2, "VALID")])
@pytest.mark.parametrize("spec", [None, "w4a4"])
def test_conv2d_against_jax(spec, stride, padding):
    """XLA's padding for SAME/VALID at either stride, fake-quant weights
    and signed CRC activations; the float conv sums in another order."""
    js, ts = SPECS[spec] if spec else (None, None)
    rng = np.random.default_rng(12)
    p = {"w": rng.standard_normal((3, 3, 4, 5)).astype(np.float32) / 6,
         "b": rng.standard_normal(5).astype(np.float32) * 0.1}
    x = _signed_x(rng, (2, 9, 10, 4))
    jp, tp = _both(p)
    want = _np(JL.conv2d(jp, jnp.asarray(x), stride, padding, quant=js))
    got = TL.conv2d(tp, _t(x), stride, padding, quant=ts).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)


def test_conv2d_gradients_against_jax():
    """The QAT conv's gradients (weights through the STE and the scale,
    inputs through sign * |x|): within SUM_RTOL of the largest, since the
    backward convs sum in another order too."""
    rng = np.random.default_rng(13)
    w = rng.standard_normal((3, 3, 2, 3)).astype(np.float32) / 4
    x = np.abs(_signed_x(rng, (2, 6, 6, 2)))
    r = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)

    def jloss(w_, x_):
        return jnp.sum(JL.conv2d({"w": w_}, x_, quant=jq.W4A4) * r)
    jw, jx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    tw, tx = _t(w).requires_grad_(), _t(x).requires_grad_()
    (TL.conv2d({"w": tw}, tx, quant=tq.W4A4) * _t(r)).sum().backward()
    for got, want in ((tw.grad, jw), (tx.grad, jx)):
        want = _np(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SUM_RTOL * np.abs(want).max())


def test_pools_with_tied_maxima_against_jax():
    """On integer frames, forward and gradients bitwise: the gradient of
    max over a window with tied maxima is shared evenly in both (``amax``;
    ``F.max_pool2d`` gives it to one). On random frames the mean is within
    1 ulp: the port sums a window row-major (``window_mean``, as the
    plan's executor does); XLA's order for it depends on the host's vector
    width (ROADMAP Queue 3)."""
    rng = np.random.default_rng(14)
    x = np.round(rng.random((2, 6, 8, 3)) * 3).astype(np.float32)  # ties
    r = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)
    for jf, tf in ((JL.max_pool2d, TL.max_pool2d),
                   (JL.avg_pool2d, TL.avg_pool2d)):
        np.testing.assert_array_equal(tf(_t(x)).numpy(),
                                      _np(jf(jnp.asarray(x))))
        np.testing.assert_array_equal(_torch_grad(tf, x, r),
                                      _jax_grad(jf, x, r))
    xs = rng.random((3, 8, 8, 2)).astype(np.float32)
    want = _np(JL.avg_pool2d(jnp.asarray(xs)))
    assert np.all(np.abs(TL.avg_pool2d(_t(xs)).numpy() - want)
                  <= np.spacing(want))


def test_embedding_and_norms_against_jax():
    """Lookup and tied logits exactly (one product per output, or a
    K = 6 sum of exact products); the norms within 2 ulp (rsqrt)."""
    rng = np.random.default_rng(15)
    table = (rng.integers(-8, 9, (11, 6)) / 8).astype(np.float32)
    ids = rng.integers(0, 11, (2, 5))
    x = (rng.integers(-8, 9, (2, 5, 6)) / 8).astype(np.float32)
    jp, tp = {"table": jnp.asarray(table)}, {"table": _t(table)}
    np.testing.assert_array_equal(
        TL.embedding_lookup(tp, _t(ids)).numpy(),
        _np(JL.embedding_lookup(jp, jnp.asarray(ids))))
    np.testing.assert_array_equal(TL.embedding_logits(tp, _t(x)).numpy(),
                                  _np(JL.embedding_logits(jp, jnp.asarray(x))))
    xn = rng.standard_normal((4, 16)).astype(np.float32)
    scale = rng.random(16).astype(np.float32) + 0.5
    bias = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": _t(scale)}, _t(xn)).numpy(),
        _np(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(xn))),
        rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(
        TL.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(xn)).numpy(),
        _np(JL.layernorm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jnp.asarray(xn))),
        rtol=1e-6, atol=1e-6)


def test_initializers_shapes_and_scales():
    """The reference draws from ``jax.random``, the port from a
    ``torch.Generator``: shapes, dtypes and scales agree, the numbers
    do not (and need not)."""
    g = torch.Generator().manual_seed(0)
    d = TL.init_dense(g, 256, 128, bias=True)
    assert d["w"].shape == (256, 128) and torch.all(d["b"] == 0)
    assert abs(float(d["w"].std()) - 1 / 16) < 0.003
    c = TL.init_conv2d(g, 3, 8, 16)
    assert c["w"].shape == (3, 3, 8, 16) and c["b"].shape == (16,)
    assert abs(float(c["w"].std()) - (1 / 72) ** 0.5) < 0.02
    assert TL.init_dense(g, 4, 2, stddev=0.5)["w"].shape == (4, 2)
    assert "b" not in TL.init_dense(g, 4, 2)
    e = TL.init_embedding(g, 50, 64)
    assert e["table"].shape == (50, 64)
    assert torch.all(TL.init_rmsnorm(g, 7)["scale"] == 1)
    ln = TL.init_layernorm(g, 7)
    assert torch.all(ln["scale"] == 1) and torch.all(ln["bias"] == 0)
    assert torch.all(tmodule.zeros_init()(g, (2, 3)) == 0)
    assert torch.all(tmodule.ones_init()(g, (2, 3)) == 1)
    a = tmodule.normal_init(0.02)(torch.Generator().manual_seed(3), (8,))
    b = tmodule.normal_init(0.02)(torch.Generator().manual_seed(3), (8,))
    assert torch.equal(a, b)


# -- the photonic_mvm float API -----------------------------------------------

MVM_SHAPES = [(1, 1, 1, "w4a4"), (1, 7, 5, "w2a4"), (8, 101, 53, "w4a4"),
              (64, 300, 129, "w4a4"), (3, 20, 8, "w2a4")]


def _mvm_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.6).astype(np.float32)
    x.reshape(-1)[:2] = [1.0, -1.0] if m * k >= 2 else [1.0]
    w = rng.standard_normal((k, n)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,n,spec", MVM_SHAPES)
def test_photonic_mvm_float_api_against_jax(m, k, n, spec):
    """``photonic_mvm`` (the wrapper's CPU path) and ``photonic_mvm_ref``
    bitwise to the reference's ``photonic_mvm_ref``, and to its Pallas
    kernel in interpret mode at act_scale 1; at 1/15 within 2 ulp of the
    interpret-mode kernel (its dequant reassociated by XLA) and bitwise
    to ``acc * (act_scale * ws)``, which that kernel computes."""
    js, ts = SPECS[spec]
    x, w = _mvm_operands(m, k, n, seed=m + k + n)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    oracle = _np(jref.photonic_mvm_ref(jx, jw, js))
    got = tops.photonic_mvm(_t(x), _t(w), ts).numpy()
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(
        tref.photonic_mvm_ref(_t(x), _t(w), ts).numpy(), oracle)
    codes = tref.signed_codes(_t(x), ts, 1.0 / 15.0)
    assert codes.dtype == torch.int8 and int(codes.min()) < 0 < \
        int(codes.max()) or m * k < 3
    pallas = _np(jops.photonic_mvm(jx, jw, js))
    wq, ws = tq.quantize_weight(_t(w), ts)
    acc = (codes.double() @ wq.double()).float().numpy()
    reassoc = acc * (np.float32(1 / 15.0) * ws.numpy().reshape(1, -1))
    np.testing.assert_array_equal(pallas, reassoc)
    # each association rounds twice
    assert np.all(np.abs(got - pallas) <= 2 * np.spacing(np.abs(pallas)))
    np.testing.assert_array_equal(
        tops.photonic_mvm(_t(x), _t(w), ts, act_scale=1.0).numpy(),
        _np(jops.photonic_mvm(jx, jw, js, act_scale=1.0)))


def test_photonic_mvm_keeps_leading_dims():
    x, w = _mvm_operands(12, 30, 7, seed=3)
    x3 = x.reshape(2, 6, 30)
    got = tops.photonic_mvm(_t(x3), _t(w), tq.W4A4)
    assert got.shape == (2, 6, 7)
    np.testing.assert_array_equal(
        got.numpy(), _np(jref.photonic_mvm_ref(jnp.asarray(x3),
                                               jnp.asarray(w), jq.W4A4)))


@pytest.mark.parametrize("m,k,n", [(1, 7, 5), (37, 101, 53)])
def test_photonic_mvm_prequant_against_jax(m, k, n):
    """Signed int8 codes in [-15, 15]: bitwise to the Pallas kernel in
    interpret mode at act_scale 1 and to the reference's ``mvm_int_ref``
    at 0.37, leading dims kept."""
    rng = np.random.default_rng(m * 31 + k)
    a = rng.integers(-15, 16, (m, k)).astype(np.int8)
    wq = rng.integers(-7, 8, (k, n)).astype(np.int8)
    ws = (rng.random(n) + 0.5).astype(np.float32)
    ja, jw, js = jnp.asarray(a), jnp.asarray(wq), jnp.asarray(ws)
    np.testing.assert_array_equal(
        tops.photonic_mvm_prequant(_t(a), _t(wq), _t(ws)).numpy(),
        _np(jops.photonic_mvm_prequant(ja, jw, js)))
    np.testing.assert_array_equal(
        tops.photonic_mvm_prequant(_t(a), _t(wq), _t(ws), 0.37).numpy(),
        _np(jref.mvm_int_ref(ja, jw, js, 0.37)))
    got = tops.photonic_mvm_prequant(_t(a).reshape(1, m, k), _t(wq), _t(ws))
    assert got.shape == (1, m, n)


# -- the optimizer ------------------------------------------------------------

def _tree(rng):
    return {"l1": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                   "b": rng.standard_normal(4).astype(np.float32)},
            "l2": {"w": rng.standard_normal((4, 3)).astype(np.float32)}}


def _jtree(t, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


def _ttree(t, dtype=None):
    return tclip.tree_map(lambda a: _t(a) if dtype is None
                          else _t(a).to(dtype), t)


def _pairs(ttree, jtree):
    """(port leaf, reference leaf as numpy) by key: ``jax.tree.leaves``
    sorts dict keys, the port keeps their order."""
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _pairs(ttree[k], jtree[k])
    else:
        yield ttree.float().numpy(), np.asarray(jtree, np.float32)


def test_global_norm_and_clip_against_jax():
    """One float32 sum of squares per leaf, added leaf by leaf: the sums
    run in another order, so within 2 ulp."""
    tree = _tree(np.random.default_rng(16))
    gj = float(jclip.global_norm(_jtree(tree)))
    gt = float(tclip.global_norm(_ttree(tree)))
    assert gt == pytest.approx(gj, rel=2.5e-7)
    cj, _ = jclip.clip_by_global_norm(_jtree(tree), 1.0)
    ct, norm = tclip.clip_by_global_norm(_ttree(tree), 1.0)
    assert float(norm) == pytest.approx(gj, rel=2.5e-7)
    for a, b in _pairs(ct, cj):
        np.testing.assert_allclose(a, b, rtol=5e-7, atol=0)
    big, _ = tclip.clip_by_global_norm(_ttree(tree), 1e6)    # no-op
    for a, b in zip(tclip.tree_leaves(big), tclip.tree_leaves(_ttree(tree))):
        assert torch.equal(a, b)


def test_schedules_against_jax():
    """float32 cos of float32 arguments: within 1 ulp of the peak."""
    for step in (0, 1, 3, 7, 10, 25):
        for total in (10, 20):
            want = float(jsched.cosine_schedule(jnp.int32(step), total, 0.1))
            got = float(tsched.cosine_schedule(torch.tensor(step), total,
                                               0.1))
            assert got == pytest.approx(want, abs=1e-8)
            want = float(jsched.linear_warmup_cosine(jnp.int32(step), 4,
                                                     total, 3e-3))
            got = float(tsched.linear_warmup_cosine(torch.tensor(step), 4,
                                                    total, 3e-3))
            assert got == pytest.approx(want, abs=3e-10)


def test_adamw_five_steps_against_jax():
    """Five AdamW steps from the same gradients, the clip engaged and the
    learning rate from ``linear_warmup_cosine``, with a bf16 leaf kept
    through its f32 master copy. Within 1e-6 relative to each leaf's
    largest value: the global norm, ``b ** t`` and the schedule's cos
    each round once differently (an ulp of the update), over five steps."""
    rng = np.random.default_rng(17)
    params = _tree(rng)
    grads = [jax.tree.map(lambda a: (a * 3).astype(np.float32),
                          _tree(rng)) for _ in range(5)]
    cfg_j = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp = {**_jtree(params), "l2": _jtree(params["l2"], jnp.bfloat16)}
    tp = {**_ttree(params), "l2": _ttree(params["l2"], torch.bfloat16)}
    js, ts = jadamw.adamw_init(jp, cfg_j), tadamw.adamw_init(tp, cfg_t)
    for i, g in enumerate(grads):
        lr_j = jsched.linear_warmup_cosine(js["step"], 2, 5, 1e-2)
        lr_t = tsched.linear_warmup_cosine(ts["step"], 2, 5, 1e-2)
        jg = {**_jtree(g), "l2": _jtree(g["l2"], jnp.bfloat16)}
        tg = {**_ttree(g), "l2": _ttree(g["l2"], torch.bfloat16)}
        jp, js, jm = jadamw.adamw_update(jp, jg, js, cfg_j, lr=lr_j)
        tp, ts, tm = tadamw.adamw_update(tp, tg, ts, cfg_t, lr=lr_t)
        assert int(ts["step"]) == i + 1
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=2.5e-7)
        assert float(tm["grad_norm"]) > 1.0             # the clip engaged
        for tree_t, tree_j in ((ts["master"], js["master"]),
                               (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
            for a, b in _pairs(tree_t, tree_j):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-6 * np.abs(b).max())
    assert tp["l2"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["l2"]["w"].float().numpy(),
        _np(jp["l2"]["w"].astype(jnp.float32)))
