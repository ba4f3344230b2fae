"""The plan executor's fused epilogue (``kernels/epilogue``) on the CPU.

A CPU tensor takes the epilogue kernel's plain version
(``ref.epilogue_ref``: dequant -> bias -> act -> pool -> CRC requant as
torch ops), which must equal, bit for bit, the reference's jitted executor
on the same step: the lines of ``repro.core.plan._execute_steps``' conv
branch (``acc * (act_scale * ws)``, ``_nofma(out) + b``, ``_activation``,
the pool) and ``_crc_requant_traced`` under one ``jax.jit``, with the
divisor traced as the reference passes it. The cases: per-frame and
per-tensor calibration, every act of ``dispatch.FUSABLE_ACTS`` with and
without a bias, a max and an avg pool of 2, values on a .5 code tie, an
all-zero frame (the 1e-8 floor), and the uint8 operand the epilogue
writes for the next int8 conv, equal to ``strip.int_operands``' first
output. The reference's avg pool reduces in XLA's order, which changes
with the host and the fusion (PERF.md §6), so its case takes values
whose window sums are exact in any order; the port's row-major order is
held to numpy's sequential float32 sum on values where order matters.
The plans' hand-over records, the launch configuration and a whole
executor run on the int route (the operand handed over, the levels laid
out at bind) are held here too. The kernel itself runs only on the card
(``test_torch_gpu.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import accelerator as jacc
from repro.core import plan as jplan
from repro.core import quant as jquant
from repro_torch import Options, Program
from repro_torch.core import plan as tplan
from repro_torch.core.accelerator import ConvSpec, DenseSpec, FlattenSpec
from repro_torch.core.quant import W4A4
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.conv_bank import strip
from repro_torch.kernels.epilogue import ops
from repro_torch.kernels.epilogue.ref import epilogue_ref
from repro_torch.weights import params_from_numpy

A_QMAX = 15.0


@functools.partial(jax.jit, static_argnames=("act", "pool", "per_frame",
                                             "has_bias"))
def _reference(acc, act_scale, ws, b, a_qmax, act, pool, per_frame,
               has_bias):
    """The reference executor's conv epilogue, its lines under one jit."""
    out = acc * (act_scale * ws.reshape(1, 1, 1, -1))
    if has_bias:
        out = jplan._nofma(out) + b
    y = jacc._activation(out, act)
    if pool is not None:
        kind, size = pool
        b_, h_, w_, c_ = y.shape
        yr = y.reshape(b_, h_ // size, size, w_ // size, size, c_)
        y = yr.max(axis=(2, 4)) if kind == "max" else yr.mean(axis=(2, 4))
    return jplan._crc_requant_traced(y, a_qmax, per_frame)


@functools.partial(jax.jit, static_argnames=("per_frame",))
def _requant_reference(x, a_qmax, per_frame):
    return jplan._crc_requant_traced(x, a_qmax, per_frame)


def _case(seed, shape=(3, 6, 8, 16), exact=False):
    """acc (integers), act_scale per frame [B,1,1,1], ws, bias. ``exact``:
    powers of two for the scales and a bias on a 1/64 grid, so every sum
    of a few dequantized values is exact in any order."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-600, 601, shape).astype(np.float32)
    b, c = shape[0], shape[-1]
    if exact:
        act_scale = 2.0 ** -rng.integers(8, 11, (b, 1, 1, 1))
        ws = 2.0 ** -rng.integers(1, 4, (1, 1, 1, c))
        bias = rng.integers(-64, 65, c) / 64.0
    else:
        act_scale = rng.uniform(0.001, 0.01, (b, 1, 1, 1))
        ws = rng.uniform(0.01, 0.2, (1, 1, 1, c))
        bias = rng.normal(0, 0.3, c)
    return (acc, act_scale.astype(np.float32), ws.astype(np.float32),
            bias.astype(np.float32))


def _both(acc, act_scale, ws, bias, act, pool, per_frame):
    """(the plain version's codes and scale, the reference's), as numpy."""
    s = act_scale if per_frame else act_scale[0, 0, 0, 0]
    got = epilogue_ref(torch.from_numpy(acc), torch.from_numpy(np.array(s)),
                       torch.from_numpy(ws),
                       None if bias is None else torch.from_numpy(bias),
                       act, pool, A_QMAX, per_frame)
    want = _reference(jnp.asarray(acc), jnp.asarray(s), jnp.asarray(ws),
                      jnp.asarray(bias if bias is not None else 0.0),
                      jnp.float32(A_QMAX), act, pool, per_frame,
                      bias is not None)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", list(dispatch.FUSABLE_ACTS))
def test_plain_epilogue_bitwise_equal_to_the_reference_jit(act, bias,
                                                           per_frame):
    acc, s, ws, b = _case(17)
    _equal(*_both(acc, s, ws, b if bias else None, act, None, per_frame))


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pooled_epilogue_bitwise_equal_to_the_reference_jit(kind,
                                                            per_frame):
    acc, s, ws, b = _case(23, exact=True)
    for act in ("relu", "abs"):
        _equal(*_both(acc, s, ws, b, act, (kind, 2), per_frame))


def test_avg_pool_sums_each_window_row_major_from_zero():
    # values where the order of a window's sum matters: the port sums
    # (((0 + a00) + a01) + a10) + a11 and divides once, as
    # ``core.accelerator.window_mean`` says
    rng = np.random.default_rng(5)
    x = (rng.uniform(0.5, 1.5, (2, 4, 6, 3)) *
         2.0 ** rng.integers(-12, 12, (2, 4, 6, 3))).astype(np.float32)
    ones = torch.ones(1)
    got, scale = epilogue_ref(torch.from_numpy(x), ones, ones.reshape(1),
                              None, "none", ("avg", 2), A_QMAX, True)
    w = x.reshape(2, 2, 2, 3, 2, 3)
    acc = np.zeros((2, 2, 3, 3), np.float32)
    for di in range(2):
        for dj in range(2):
            acc = (acc + w[:, :, di, :, dj, :]).astype(np.float32)
    y = np.maximum(acc / np.float32(4), 0)
    sc = (np.maximum(y.max(axis=(1, 2, 3), keepdims=True), np.float32(1e-8))
          / np.float32(A_QMAX)).astype(np.float32)
    np.testing.assert_array_equal(scale.numpy(), sc)
    np.testing.assert_array_equal(
        got.numpy(), np.clip(np.round(y / sc), 0, 15).astype(np.float32))


@pytest.mark.parametrize("per_frame", [True, False])
def test_codes_on_a_half_step_round_to_even(per_frame):
    # amax 15/8 -> scale exactly 1/8: x = (k + 0.5) / 8 lies on a tie
    k = np.arange(15, dtype=np.float32)
    x = np.zeros((2, 1, 16, 2), np.float32)
    x[:, 0, :15, 0] = (k + 0.5) / 8
    x[:, 0, 15, :] = 15 / 8
    x[1] = x[0] / 2                            # scale 1/16: ties again
    got = epilogue_ref(torch.from_numpy(x), a_qmax=A_QMAX,
                       per_frame=per_frame)
    want = _requant_reference(jnp.asarray(x), jnp.float32(A_QMAX), per_frame)
    _equal([t.numpy() for t in got], [np.asarray(t) for t in want])
    assert float(got[1].reshape(-1)[0]) == 1 / 8
    np.testing.assert_array_equal(got[0].numpy()[0, 0, :15, 0],
                                  np.round(k + 0.5))       # half to even
    assert set(got[0].numpy()[0, 0, :15, 0] % 2) == {0.0}


@pytest.mark.parametrize("per_frame", [True, False])
def test_an_all_zero_frame_takes_the_floor(per_frame):
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (3, 4, 4, 5)).astype(np.float32)
    x[1] = -np.abs(x[1])                       # clamps to all zero
    x[2] = 0.0
    if not per_frame:
        x[0] = 0.0                              # the whole batch is zero
        x[0, 0, 0, 0] = -0.0
    got = epilogue_ref(torch.from_numpy(x), a_qmax=A_QMAX,
                       per_frame=per_frame)
    want = _requant_reference(jnp.asarray(x), jnp.float32(A_QMAX), per_frame)
    _equal([t.numpy() for t in got], [np.asarray(t) for t in want])
    floor = np.float32(np.float32(1e-8) / np.float32(A_QMAX))
    scales = got[1].numpy().reshape(-1)
    if per_frame:
        assert scales[0] != floor and (scales[1:] == floor).all()
    else:
        assert scales.tolist() == [floor]
    assert not got[0].numpy()[1:].any()


@pytest.mark.parametrize("pads", [((1, 1), (1, 1)), ((0, 1), (2, 0))])
@pytest.mark.parametrize("c,k", [(3, 3), (20, 3), (64, 3), (16, 5)])
def test_operand_equals_int_operands_first_output(c, k, pads):
    acc, s, ws, b = _case(c + k, shape=(2, 6, 6, c))
    kw = dict(act="relu", pool=("max", 2), a_qmax=A_QMAX, per_frame=True)
    args = (torch.from_numpy(acc), torch.from_numpy(s), torch.from_numpy(ws),
            torch.from_numpy(b))
    codes, scale = epilogue_ref(*args, **kw)
    x8, scale8 = epilogue_ref(*args, operand=(k, pads), **kw)
    w = torch.zeros((k, k, c, 7))
    want, _ = strip.int_operands(codes, w, pads)
    assert x8.dtype == torch.uint8 and torch.equal(x8, want)
    assert x8.shape[-1] == strip.igemm_c_in(c, k)
    assert torch.equal(scale8, scale)
    assert torch.equal(strip.int_codes(x8, k), x8)         # in form already


def test_launch_configuration():
    cfg = ops.epilogue_config(8, 224 * 224 * 64, 64, True)
    assert cfg.vec == 4
    assert cfg.nblk1 * 8 <= ops.TARGET_BLOCKS + 8 and cfg.nblk1 > 1
    # a misaligned or 3-channel tensor takes single elements; a small
    # frame one block
    assert ops.epilogue_config(8, 224 * 224 * 3, 3, True).vec == 1
    assert ops.epilogue_config(8, 224 * 224 * 4, 4, False).vec == 1
    assert ops.epilogue_config(8, 784, 1, True).nblk1 == 1
    words = 226 * 226 * 4 // 4
    cfg = ops.epilogue_config(8, 224 * 224 * 3, 3, True, words)
    assert cfg.nblk2 == ops._blocks(words, 8)
    for b, n in ((1, 1), (3, 5000), (64, 10 ** 6)):
        cfg = ops.epilogue_config(b, n, 1, True)
        assert 1 <= cfg.nblk1 <= max(1, -(-ops.TARGET_BLOCKS // b))
    # the ctypes mirrors of the two structs
    assert ctypes_sizes() == (112, 72)


def ctypes_sizes():
    import ctypes
    return ctypes.sizeof(ops._Epi), ctypes.sizeof(ops._Quant)


def test_the_kernel_refuses_an_act_it_does_not_take():
    x = torch.zeros((1, 2, 2, 4))
    with pytest.raises(ValueError, match="tanh"):
        ops.launch(x, None, None, None, "tanh", None, A_QMAX, True, None,
                   None)


INT_ROUTE_LAYERS = (ConvSpec("conv1", 3, 16, pool=("max", 2)),
                    ConvSpec("conv2", 16, 32, act="abs"),
                    ConvSpec("conv3", 32, 32, pool=("avg", 2)),
                    ConvSpec("conv4", 32, 16, act="tanh"),
                    FlattenSpec(), DenseSpec("fc1", 4 * 4 * 16, 24),
                    DenseSpec("fc2", 24, 10, act="none"))


def _int_route_params():
    """Seeded numpy weights and biases of ``INT_ROUTE_LAYERS``."""
    rng = np.random.default_rng(3)
    params = {}
    for l in INT_ROUTE_LAYERS:
        if isinstance(l, ConvSpec):
            shape = (l.kernel, l.kernel, l.c_in, l.c_out)
        elif isinstance(l, DenseSpec):
            shape = (l.fan_in, l.fan_out)
        else:
            continue
        params[l.name] = {
            "w": (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1])))
            .astype(np.float32),
            "b": (rng.standard_normal(shape[-1]) * 0.05).astype(np.float32)}
    return params


def _int_route_program():
    """conv1 (3 channels, 16 out) on the float64 strip route, conv2-conv4
    on the int8 one under a 2 KiB budget; conv4's tanh on the torch ops."""
    return Program(INT_ROUTE_LAYERS, params_from_numpy(_int_route_params(),
                                                       "cpu"), (16, 16, 3),
                   name="int_route")


def test_plan_records_the_hand_over_and_the_torch_epilogues():
    prog = _int_route_program()
    opts = Options(scheme=W4A4, device="cpu", conv_vmem_budget=2048,
                   verify="off")
    plan = prog.compile(opts).plan
    assert plan.strip_routes == {"conv1": "float", "conv2": "int",
                                 "conv3": "int", "conv4": "int"}
    assert plan.int_operands == tuple(
        n for n, r in plan.strip_routes.items() if r == "int")
    assert plan.torch_epilogues == ("conv4",)
    vgg = Program.from_model("vgg16", params={}).compile(
        Options(scheme=W4A4, device="cpu", verify="off")).plan
    assert vgg.int_operands == tuple(f"conv{i}" for i in range(1, 11))
    assert vgg.torch_epilogues == ()


@pytest.mark.parametrize("per_frame", [True, False])
def test_int_route_run_hands_the_operand_over_bitwise(per_frame):
    # the kernel backend (operands handed over, levels laid out per call
    # and at bind) against the reference backend (every requant a torch
    # op, no hand-over) and the reference package's jitted executor
    prog = _int_route_program()
    opts = Options(scheme=W4A4, device="cpu", conv_vmem_budget=2048,
                   verify="off")
    exe = prog.compile(opts)
    plan, params = exe.plan, exe.params()
    assert plan.int_operands
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.random((3, 16, 16, 3)).astype(np.float32))
    frames[1] *= 0.1
    calls = []
    real = dispatch.epilogue

    def spy(*a, **kw):
        calls.append(kw.get("operand"))
        return real(*a, **kw)

    dispatch.epilogue = spy
    try:
        reset_launch_counts()
        got = tplan._execute(plan, params, frames, per_frame=per_frame)
    finally:
        dispatch.epilogue = real
    assert sum(launch_counts().values()) == 0           # the CPU: plain
    # the frames, four convs, flatten, fc1: one epilogue each
    assert len(calls) == 7
    assert sum(c is not None for c in calls) == len(plan.int_operands)
    weights = tplan.quantized_weights(plan.steps, params, plan.consts,
                                      plan.strip_routes)
    assert all(isinstance(levels, strip.IntWeights)
               == (n in plan.int_operands)
               for n, (_, _, levels) in weights.items())
    bound = tplan._execute(plan, params, frames, per_frame=per_frame,
                           weights=weights)
    ref = tplan._execute(plan, params, frames, per_frame=per_frame,
                         backend="reference")
    assert torch.equal(got, bound) and torch.equal(got, ref)
    jexe = repro.Program(
        tuple(_jax_layer(l) for l in prog.layers),
        {n: {k: jnp.asarray(v) for k, v in p.items()}
         for n, p in _int_route_params().items()}, (16, 16, 3)).compile(
        repro.Options(scheme=jquant.W4A4, backend="reference",
                      conv_vmem_budget=2048))
    run = jexe.run_per_frame if per_frame else jexe.run
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(run(frames.numpy())))


FUSED_THEN_INT_LAYERS = (ConvSpec("conv1", 3, 16),
                         ConvSpec("conv2", 16, 64, pool=("max", 2)),
                         ConvSpec("conv3", 64, 64, pool=("max", 2)),
                         FlattenSpec(),
                         DenseSpec("fc1", 4 * 4 * 64, 10, act="none"))


def _seeded_params(layers, seed):
    """Seeded numpy weights and biases of ``layers``' convs and denses."""
    rng = np.random.default_rng(seed)
    params = {}
    for l in layers:
        if isinstance(l, ConvSpec):
            shape = (l.kernel, l.kernel, l.c_in, l.c_out)
        elif isinstance(l, DenseSpec):
            shape = (l.fan_in, l.fan_out)
        else:
            continue
        params[l.name] = {
            "w": (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1])))
            .astype(np.float32),
            "b": (rng.standard_normal(shape[-1]) * 0.05).astype(np.float32)}
    return params


@pytest.mark.parametrize("per_frame,batch", [(True, 3), (True, 1),
                                             (False, 3), (False, 1)])
def test_an_int_route_conv_after_a_fused_segment_takes_the_chain_s_codes(
        per_frame, batch):
    # conv1-conv2 fuse (under the channel cap); conv3 (64 x 64, over it)
    # runs on the int route and is in int_operands. Where the segment runs
    # (per frame, or batch 1) conv3 gets the chain's float codes and casts
    # and pads them itself; where it does not (per tensor at batch > 1),
    # conv2's epilogue hands conv3 its operand. Both against the reference
    # backend and the reference package.
    params = _seeded_params(FUSED_THEN_INT_LAYERS, 5)
    prog = Program(FUSED_THEN_INT_LAYERS, params_from_numpy(params, "cpu"),
                   (16, 16, 3), name="fused_then_int")
    exe = prog.compile(Options(scheme=W4A4, device="cpu",
                               conv_strategy="strip", fuse="auto",
                               verify="off"))
    plan = exe.plan
    assert [s.names for s in plan.fused_segments] == [("conv1", "conv2")]
    assert plan.int_operands == ("conv3",)
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(
        rng.random((batch, 16, 16, 3)).astype(np.float32))
    handed = []
    real = dispatch.conv_int

    def spy(*a, **kw):
        handed.append(kw.get("operand"))
        return real(*a, **kw)

    dispatch.conv_int = spy
    try:
        got = tplan._execute(plan, exe.params(), frames, per_frame=per_frame)
    finally:
        dispatch.conv_int = real
    fused = per_frame or batch == 1
    assert handed == ([False] if fused else [False, False, True])
    weights = tplan.quantized_weights(plan.steps, exe.params(), plan.consts,
                                      plan.strip_routes)
    bound = tplan._execute(plan, exe.params(), frames, per_frame=per_frame,
                           weights=weights)
    ref = tplan._execute(plan, exe.params(), frames, per_frame=per_frame,
                         backend="reference")
    assert torch.equal(got, bound) and torch.equal(got, ref)
    jexe = repro.Program(
        tuple(_jax_layer(l) for l in FUSED_THEN_INT_LAYERS),
        {n: {k: jnp.asarray(v) for k, v in p.items()}
         for n, p in params.items()}, (16, 16, 3)).compile(
        repro.Options(scheme=jquant.W4A4, backend="reference",
                      conv_strategy="strip", fuse="auto"))
    run = jexe.run_per_frame if per_frame else jexe.run
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(run(frames.numpy())))


def _jax_layer(layer):
    return getattr(jacc, type(layer).__name__)(
        **{f: getattr(layer, f) for f in layer.__dataclass_fields__})


class _EmulatedPair:
    """The two entry points of ``csrc/epilogue.cu``, emulated on the CPU
    over the structs the wrapper lays out (read back through ctypes from
    CPU tensors' memory): each block's range of units, the stored y and
    the block maxima, pass 2's reduction of them, the codes of the stored
    y and the operand's words, in the
    kernel's arithmetic (float32 products, sums and quotients, each
    rounded once). It holds the wrapper's layout and the kernel's walk,
    not the compiled code."""

    def __init__(self):
        self.launches = []

    @staticmethod
    def _arr(ptr, n, ctype=None):
        import ctypes
        ctype = ctype or ctypes.c_float
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    def _y(self, e, b, o, vec):
        """y of units starting at pooled elements ``o`` (an array)."""
        f32 = np.float32
        xs = self._arr(e.x, e.xs * (e.batch - 1) + e.n * e.p * e.p)
        c0 = o % e.c
        s = f32(1) if not e.scale else self._arr(e.scale, e.scale_n)[
            b if e.scale_n > 1 else 0]
        out = []
        for j in range(vec):
            cj = c0 + j
            wsc = (s * self._arr(e.ws, e.ws_n)[cj if e.ws_n > 1 else 0]
                   if e.ws else np.full(o.shape, s, f32)).astype(f32)
            bv = (self._arr(e.bias, e.bias_n)[cj if e.bias_n > 1 else 0]
                  if e.bias else None)

            def value(idx):
                v = (xs[b * e.xs + idx] * wsc).astype(f32)
                if bv is not None:
                    v = (v + bv).astype(f32)
                sign = np.where(v > 0, f32(1), np.where(v < 0, f32(-1),
                                                        f32(0)))
                return [v, np.where((v > 0) | np.isnan(v), v, f32(0)),
                        np.abs(v), sign][e.act].astype(f32)

            if e.p == 1:
                y = value(o + j)
            else:
                pix = o // e.c
                ph, pw = pix // e.w_out, pix % e.w_out
                y = np.zeros(o.shape, f32)
                for di in range(e.p):
                    for dj in range(e.p):
                        v = value(((ph * e.p + di) * e.w_in + pw * e.p + dj)
                                  * e.c + cj)
                        if e.pool_kind == 1:
                            y = v if di == dj == 0 else np.maximum(y, v)
                        else:
                            y = (y + v).astype(f32)
                if e.pool_kind == 2:
                    y = (y / f32(e.p * e.p)).astype(f32)
            out.append(np.maximum(y, f32(0)))
        return out

    def epilogue_reduce_launch(self, epi, vec, stream):
        e = epi._obj
        self.launches.append("reduce")
        units = e.n // vec
        per = -(-units // e.nblk1)
        part = self._arr(e.partials, e.batch * e.nblk1)
        for b in range(e.batch):
            for blk in range(e.nblk1):
                u = np.arange(blk * per, min(units, blk * per + per))
                ys = self._y(e, b, u * vec, vec) if len(u) else []
                part[b * e.nblk1 + blk] = np.max(
                    [np.float32(0)] + [y.max() for y in ys if len(y)])
                dst = self._arr(e.y, e.batch * e.n)
                for j, y in enumerate(ys):
                    dst[b * e.n + u * vec + j] = y
        return 0

    def epilogue_quant_launch(self, epi, qt, vec, stream):
        e, q = epi._obj, qt._obj
        self.launches.append("quant")
        f32 = np.float32
        part = self._arr(e.partials, e.batch * e.nblk1)
        for b in range(e.batch):
            amax = (self._arr(q.amax, 1)[0] if q.amax else
                    part[b * e.nblk1:(b + 1) * e.nblk1].max() if q.per_frame
                    else part.max())
            scale = f32(np.maximum(amax, f32(1e-8)) / f32(q.aq))
            if q.per_frame or b == 0:
                self._arr(q.scale_out, e.batch)[b if q.per_frame else 0] = \
                    scale

            def codes(o, width):
                ys = [self._arr(e.y, e.batch * e.n)[b * e.n + o + j]
                      for j in range(width)]
                return [np.clip(np.rint((y / scale).astype(f32)), 0,
                                q.code_max).astype(f32) + f32(0)
                        for y in ys]

            if q.codes:
                units = e.n // vec
                per = -(-units // q.nblk2)
                dst = self._arr(q.codes, e.batch * e.n)
                for blk in range(q.nblk2):
                    u = np.arange(blk * per, min(units, blk * per + per))
                    for j, cd in enumerate(codes(u * vec, vec)):
                        dst[b * e.n + u * vec + j] = cd
            else:
                import ctypes
                cw = q.cp // 4
                words = q.hp * q.wp * cw
                dst = self._arr(q.operand, e.batch * words, ctypes.c_uint32)
                u = np.arange(words)
                pix, c0 = u // cw, (u % cw) * 4
                r, s = pix // q.wp - q.top, pix % q.wp - q.left
                inside = (r >= 0) & (r < q.h) & (s >= 0) & (s < e.w_out) & \
                    (c0 < e.c)
                word = np.zeros(words, np.uint32)
                o = (r * e.w_out + s) * e.c + c0
                for j in range(4):
                    ok = inside & (c0 + j < e.c)
                    if ok.any():
                        cd = codes(o[ok] + j, 1)[0]
                        word[ok] |= cd.astype(np.uint32) << np.uint32(8 * j)
                dst[b * words:(b + 1) * words] = word
        return 0


def _emulated_launch(monkeypatch, args):
    """``ops.launch(*args)`` on the CPU through :class:`_EmulatedPair`."""
    from repro_torch.kernels import _build
    pair = _EmulatedPair()
    monkeypatch.setattr(_build, "library", lambda name, sigs: pair)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    reset_launch_counts()
    try:
        got = ops.launch(*args)
        assert launch_counts()["epilogue"] == 1
    finally:
        # the emulated launch counted; no later test of this process may
        # find it (a CPU run launches nothing)
        reset_launch_counts()
    assert pair.launches == ["reduce", "quant"]
    return got


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("i", range(10))
def test_wrapper_and_the_kernels_walk_emulated_equal_the_plain_version(
        monkeypatch, i, per_frame):
    from repro_torch.kernels.edge_shapes import EPILOGUE_EDGES, epilogue_case
    edge = EPILOGUE_EDGES[i]
    args = epilogue_case(edge, per_frame, torch.Generator().manual_seed(i),
                         "cpu")
    got = _emulated_launch(monkeypatch, args)
    want = epilogue_ref(*args)
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
    assert got[1].shape == want[1].shape and torch.equal(got[1], want[1])


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("i", range(4))
def test_the_kernels_walk_emulated_keeps_a_nan_as_the_plain_version(
        monkeypatch, i, per_frame):
    # a NaN and a +inf in the accumulate: NaN scales and codes where the
    # plain version has them (torch's clamp, amax and max pool keep a NaN;
    # fmaxf would drop it), bitwise elsewhere
    from repro_torch.kernels.edge_shapes import (EPILOGUE_NAN_EDGES,
                                                 epilogue_nan_case)
    edge = EPILOGUE_NAN_EDGES[i]
    args = epilogue_nan_case(edge, per_frame,
                             torch.Generator().manual_seed(i), "cpu")
    got = _emulated_launch(monkeypatch, args)
    want = epilogue_ref(*args)
    assert bool(want[1].isnan().any()) == (edge[0] != "sign")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
