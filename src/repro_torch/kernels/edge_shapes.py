"""Edge shapes of the launch configurations of ``photonic_mvm`` (its float
API on signed codes too), the strip convs (the int8 one's wgmma form
and the float one's tensor-core form too), the fused conv chain,
``ca_pool`` and the epilogue, the distinct shapes of VGG16's kernel calls
at 224x224x3, an operand copy that defeats aligned loads, the
epilogue's calls on a compiled program's path, and the values whose codes
a half-integer quotient decides.

The ``gpu`` tests (``tests/test_torch_gpu.py``) and ``chip_smoke.py`` both
hold each kernel bitwise against its plain version at these shapes, so the
two check the same set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

# (m, k, n, route) of photonic_mvm.ops.mvm_config: every route; the skinny
# one at K 2/9/31; the stream one at M 1/8/9/13/16 (one and two n8 tiles),
# K 9/31 (byte loads of the codes), 33, 777, 1,001, 4,097 (ragged boxes)
# and 25,088, N 1/64/100/129/1,000; the wgmma one at K 16 (below a box),
# ragged M and N; the gemm one at K 9/33/100/300/777 (no tensor map: K not
# a multiple of 16)
MVM_EDGES = [(129, 2, 1, "skinny"), (8, 9, 4, "skinny"),
             (129, 31, 4, "skinny"), (1, 9, 100, "stream"),
             (1, 33, 1, "stream"), (8, 31, 100, "stream"),
             (8, 2304, 100, "stream"), (1, 4097, 1, "stream"),
             (16, 777, 129, "stream"), (13, 1001, 1000, "stream"),
             (9, 4096, 1000, "stream"), (16, 25088, 64, "stream"),
             (129, 2304, 4, "wgmma"), (4096, 256, 256, "wgmma"),
             (100, 4096, 1000, "wgmma"), (300, 16, 70, "wgmma"),
             (17, 4608, 512, "wgmma"), (2048, 9, 64, "gemm"),
             (129, 33, 100, "gemm"), (33, 100, 257, "gemm"),
             (33, 300, 257, "gemm"), (33, 777, 129, "gemm")]

# (m, k, n, route) of photonic_mvm's float API on signed CRC codes
# (``ops.photonic_mvm``, ``nn.layers.dense(mode="kernel")``): M 1/8/64,
# ragged M/K/N, every route; LeNet's fc1 at M = 1 and VGG9-CA's at batch
# 64 among them, and both fc1s at M = 512 (several M tiles, as in the
# smoke's kernel-mode evaluation)
SIGNED_MVM_SHAPES = [(1, 31, 8, "skinny"), (8, 20, 5, "skinny"),
                     (64, 9, 3, "skinny"), (8, 31, 100, "stream"),
                     (1, 400, 120, "stream"), (8, 101, 53, "stream"),
                     (16, 8192, 100, "stream"), (64, 1024, 512, "wgmma"),
                     (40, 4096, 200, "wgmma"), (37, 777, 129, "gemm"),
                     (512, 400, 120, "wgmma"), (512, 1024, 512, "wgmma")]

# (b, h_out, w_out, c_in, c_out, k, stride) of conv_bank.strip.strip_config:
# ragged tiles and runs (a 16-byte-aligned 1-channel row among them), k 7,
# k outside 3/5/7, stride 2, C_in over several chunks, ragged output-channel
# blocks, and every (co_b, run) the kernel is built for
STRIP_EDGES = [(8, 70, 100, 3, 20, 3, 1), (8, 200, 130, 2, 3, 5, 1),
               (8, 70, 100, 3, 3, 7, 1), (8, 170, 132, 1, 1, 5, 1),
               (8, 100, 130, 1, 1, 3, 1),
               (2, 37, 67, 1, 1, 5, 1), (1, 45, 98, 1, 1, 3, 1),
               (2, 33, 40, 3, 5, 7, 1), (1, 20, 21, 2, 3, 4, 1),
               (1, 17, 19, 3, 2, 9, 2), (2, 21, 23, 4, 6, 3, 2),
               (2, 30, 70, 40, 10, 5, 1), (1, 24, 24, 64, 33, 3, 1)]


# (b, h_out, w_out, c_in, c_out, k) of the dense float kernel's tensor-core
# form (conv_bank.strip.f64mma_config, stride 1), each tile of
# ``strip.f64mma_launches`` forced: widths and heights not a multiple of
# the tile (one output row among them); C_in 8, 9 and 15 (a step of zeros
# past C_in, copies a channel at a time), 17, 24, 40, 64 and 128 (chunks
# of 8 to 48 channels, several at k = 7); C_out 8, 10 and 12 (a block past
# C_out, weights copied a channel at a time), 33 and 40 (a ragged second
# block, odd stores); batch 1, 5 and 13; the 32-channel blocks at 8 and 16
# rows; a VGG16-like layer. With ``CONV_BANK_CALLS`` at batches 8 and 1
F64MMA_EDGES = [(1, 13, 21, 16, 32, 3), (2, 30, 17, 9, 12, 5),
                (3, 9, 11, 15, 8, 7), (13, 8, 8, 17, 32, 3),
                (2, 12, 12, 24, 33, 5), (1, 16, 16, 128, 64, 3),
                (2, 16, 24, 64, 16, 7), (1, 20, 20, 40, 10, 7),
                (1, 1, 40, 8, 8, 3), (5, 16, 64, 16, 40, 5),
                (2, 56, 56, 64, 128, 3)]

# (b, h_out, w_out, c_in, c_out, k) of the int8 strip kernel's wgmma form,
# forced (conv_bank.strip.wgmma_config, stride 1; the rule gives those under
# ``strip.WG_MIN_C`` channels the mma.sync form): VGG16's conv9 at batch 1 and
# conv8 at batch 13; widths and heights not a multiple of 8 (ragged tiles);
# C_in 16 and 48 (a k-step half past C_in) and 7,360 (at k = 3 the largest
# C_in whose accumulate int32 holds: the extremes' 255 * 127 * 9 * 7,360 =
# 2,145,196,800 < 2^31), many chunks; C_out 7, 80 and 130 (ragged channel
# blocks); k 1 and 5
INT_WGMMA_EDGES = [(1, 28, 28, 512, 512, 3), (13, 28, 28, 256, 512, 3),
                   (8, 17, 30, 64, 64, 3), (2, 21, 13, 16, 64, 3),
                   (3, 9, 11, 48, 80, 3), (1, 12, 20, 32, 130, 5),
                   (2, 10, 9, 96, 7, 1), (1, 8, 8, 7360, 64, 3)]

# (b, h_out, w_out, c, k, stride) of conv_bank.strip.dw_config: 1, 3, 4, 5,
# 16 and 17 channels (whole-row and 4-channel blocks, ragged ones among
# them), k 3/5/7 at stride 1, k 4 and 9 and stride 2 (the generic
# instantiation), odd widths, and more tiles than CTAs (a CTA walks several,
# across channel blocks among them)
DW_EDGES = [(2, 37, 67, 1, 5, 1), (1, 45, 99, 1, 3, 1), (2, 33, 41, 3, 7, 1),
            (1, 20, 21, 3, 3, 1), (3, 17, 19, 4, 5, 1), (2, 30, 33, 5, 3, 1),
            (1, 24, 25, 16, 7, 1), (2, 19, 23, 17, 3, 2),
            (1, 17, 19, 3, 5, 2), (2, 21, 23, 4, 4, 1), (1, 9, 11, 1, 9, 2),
            (8, 70, 100, 3, 5, 1), (8, 100, 130, 17, 3, 1),
            (4, 90, 200, 3, 5, 2)]

# fused chains as (batch, h, w, c_in, [(c_out, k, stride, padding,
# depthwise, act, pool, bias)]) for conv_bank.fused.chain_config: LeNet's
# segment at batch 1, 3, 8 and 13 (clusters of 8, up to 104 CTAs); a
# 16-stage segment; a 3 x 3 avg pool (more window positions than a thread
# sums at once); reductions split over 16 and 32 lanes (depthwise and
# dense); frames that fill a CTA's shared memory, so the second stage's
# weights stay in device memory; and weights too large for any CTA beside
# the frames
_LENET = [(6, 5, 1, "SAME", False, "relu", ("avg", 2), True),
          (16, 5, 1, "VALID", False, "relu", ("avg", 2), True)]
_ACTS = ("relu", "abs", "sign", "none")
CHAIN_EDGES = [(b, 28, 28, 1, _LENET) for b in (1, 3, 8, 13)] + [
    (3, 10, 10, 2, [(4, 3, 1, "SAME", j % 2 == 1, _ACTS[j % 4],
                     ("max", 2) if j == 5 else None, j % 3 == 0)
                    for j in range(16)]),
    (3, 18, 18, 2, [(4, 3, 1, "SAME", False, "relu", ("avg", 3), True),
                    (4, 3, 1, "SAME", True, "abs", ("max", 3), False)]),
    (3, 4, 4, 8, [(8, 5, 1, "SAME", True, "relu", None, True),
                  (16, 5, 1, "SAME", False, "none", None, False)]),
    (2, 2, 2, 3, [(16, 5, 1, "SAME", False, "relu", None, True)]),
    (2, 85, 85, 4, [(4, 3, 1, "SAME", False, "relu", None, True),
                    (4, 3, 1, "SAME", False, "abs", None, True)]),
    (2, 12, 12, 16, [(128, 5, 1, "SAME", False, "relu", None, True),
                     (8, 3, 1, "SAME", False, "relu", ("max", 2), False)]),
]

# random fused chains (h, w, c_in, specs as above), each run at batch 3 and
# in the per-tensor batch-1 form (a 0-d incoming scale)
CHAINS = [
    (12, 12, 3, [(8, 3, 1, "SAME", False, "relu", ("max", 2), True),
                 (8, 3, 1, "SAME", True, "abs", None, False)]),
    (16, 16, 4, [(4, 3, 1, "SAME", True, "sign", ("avg", 2), True),
                 (6, 5, 1, "VALID", False, "none", None, True)]),
    (15, 15, 2, [(5, 3, 2, "SAME", False, "relu", None, False),
                 (7, 3, 1, "VALID", False, "abs", ("max", 2), True)]),
    (20, 20, 1, [(6, 5, 1, "SAME", False, "relu", ("avg", 2), True),
                 (6, 3, 1, "SAME", True, "relu", ("max", 2), True),
                 (10, 3, 1, "SAME", False, "sign", None, False)]),
]


# (b, h, w, c, p, gray, odd, route) of ca_pool.ops.ca_config: the served
# path shapes (imaging p = 1 and 2 at 8x256x256x3, VGG9's 8x32x32x3); every
# instantiated (p, C) of both modes on the vector route and on the scalar
# one (W/p not a multiple of R; rows whose byte length is not a multiple of
# 16; an input one float past an allocation, ``odd``); the generic route
# (C 2 and 4, p 3, gray p 1 at C 1); batch 1 and 8; a row of more runs than
# a CTA has threads (two CTAs along it); and more rows than one wave of
# CTAs (a grid-stride loop)
CA_EDGES = [(8, 256, 256, 3, 1, True, False, "vector"),
            (8, 256, 256, 3, 2, True, False, "vector"),
            (8, 32, 32, 3, 2, True, False, "vector"),
            (1, 32, 32, 3, 4, True, False, "vector"),
            (8, 32, 32, 1, 2, True, False, "vector"),
            (1, 16, 48, 1, 4, True, False, "vector"),
            (8, 32, 32, 3, 2, False, False, "vector"),
            (2, 16, 24, 3, 2, False, False, "vector"),
            (3, 16, 16, 1, 4, False, False, "vector"),
            (1, 20, 20, 3, 4, False, False, "vector"),
            (2, 16, 16, 1, 2, False, False, "vector"),
            (2, 8, 2600, 3, 2, True, False, "vector"),
            (16, 256, 512, 3, 1, True, False, "vector"),
            (8, 28, 28, 1, 2, True, False, "scalar"),
            (5, 28, 28, 1, 4, True, False, "scalar"),
            (2, 20, 20, 1, 2, True, False, "scalar"),
            (2, 30, 30, 3, 1, True, False, "scalar"),
            (1, 30, 30, 3, 2, True, False, "scalar"),
            (1, 18, 18, 3, 2, False, False, "scalar"),
            (4, 28, 28, 1, 2, False, False, "scalar"),
            (2, 20, 20, 1, 4, False, False, "scalar"),
            (8, 256, 256, 3, 1, True, True, "scalar"),
            (2, 32, 32, 3, 2, False, True, "scalar"),
            (1, 12, 12, 3, 4, True, True, "scalar"),
            (2, 12, 12, 4, 2, True, False, "generic"),
            (2, 12, 12, 4, 2, False, False, "generic"),
            (3, 18, 18, 3, 3, True, False, "generic"),
            (1, 9, 15, 2, 3, False, True, "generic"),
            (2, 16, 16, 1, 1, True, False, "generic")]


# VGG16 at 224x224x3 under the default 4 MiB conv budget: the distinct
# per-frame shapes of its kernel calls, as its compiled plan gives them
# (``tests/test_torch_vgg16.py`` holds them to the plan). conv1-conv10 run
# the dense strip kernel: (layers, launch output rows = n_strips *
# strip_rows, strip_rows, w_out, c_in, c_out, k, stride); conv11-13 (im2col)
# and the three dense layers run photonic_mvm: (layers, M per frame, K, N).
VGG16_SHAPES = {
    "conv_strip": [("conv1", 224, 224, 224, 3, 64, 3, 1),
                   ("conv2", 224, 32, 224, 64, 64, 3, 1),
                   ("conv3", 128, 64, 112, 64, 128, 3, 1),
                   ("conv4", 128, 32, 112, 128, 128, 3, 1),
                   ("conv5", 56, 56, 56, 128, 256, 3, 1),
                   ("conv6+conv7", 64, 32, 56, 256, 256, 3, 1),
                   ("conv8", 48, 24, 28, 256, 512, 3, 1),
                   ("conv9+conv10", 48, 24, 28, 512, 512, 3, 1)],
    "photonic_mvm": [("conv11+conv12+conv13", 196, 4608, 512),
                     ("fc1", 1, 25088, 4096), ("fc2", 1, 4096, 4096),
                     ("fc3", 1, 4096, 1000)]}

# the conv_bank op's own calls in chip_smoke.py: x [B, H, W, C_in] -> C_out,
# k x k (W4A4 with relu and bias, and in float mode, in both strategies)
CONV_BANK_CALLS = [(8, 32, 32, 16, 32, k) for k in (3, 5, 7)]
# and a call the float kernel's rule keeps on its CUDA-core form (3 -> 4
# channels, the reference tests' own width), so the op's run launches both
CONV_BANK_NARROW = [(8, 32, 32, 3, 4, 3)]

# (name, h_out = w_out, c_in, c_out, k) at which the int8 strip conv's two
# forms, each forced, are held to each other and timed (the gpu tests,
# chip_smoke.py's [vgg16] int8 forms, scripts/strip_int_forms.py): VGG16's
# conv2-conv10 (the distinct ``VGG16_SHAPES`` entries over the conv's own
# rows, as the int route launches them), conv11-13 forced onto the int8
# kernel (the plan runs them as im2col GEMMs) and the conv_bank op's calls
INT_FORM_SHAPES = [
    (name, w_out, ci, co, k)
    for name, _, _, w_out, ci, co, k, _ in VGG16_SHAPES["conv_strip"]
    if ci >= 16] + [("conv11+conv12+conv13", 14, 512, 512, 3)] + [
    (f"conv_bank_op_k{k}", h, ci, co, k)
    for _, h, _, ci, co, k in CONV_BANK_CALLS]


# the epilogue kernel pair (``epilogue.ops.epilogue_config``): (batch, x's
# shape a frame, act, bias, pool, operand (k, pads) or None, form): 4
# channels a unit and 1 (3 channels, odd ones, a misaligned copy), max and
# avg pools, a frame stride of its own (the float strip route's row slice,
# "rows"), the operand's channel pads (3 -> 4, 20 -> 32) and borders, a
# dense accumulate, a plain tensor ("plain": no act_scale), one frame and
# a batch past one block a frame
EPILOGUE_EDGES = [
    (8, (224, 224, 3), "none", False, None, (3, ((1, 1), (1, 1))), "plain"),
    (8, (56, 56, 64), "relu", True, ("max", 2), (3, ((1, 1), (1, 1))),
     "acc"),
    (3, (18, 10, 5), "sign", True, ("avg", 2), None, "acc"),
    (1, (28, 28, 6), "relu", True, ("avg", 2), None, "acc"),
    (2, (40, 40, 20), "abs", True, None, (5, ((2, 2), (0, 3))), "acc"),
    (8, (4096,), "relu", True, None, None, "acc"),
    (5, (33, 31, 7), "none", False, None, None, "rows"),
    (4, (16, 16, 8), "relu", False, ("max", 2), None, "odd"),
    (2, (64, 64, 1), "none", False, None, None, "plain"),
    (13, (8, 8, 16), "abs", True, None, (3, ((0, 0), (0, 0))), "acc")]


def epilogue_case(edge, per_frame, gen, device):
    """The arguments of ``epilogue.ops.epilogue`` for one
    ``EPILOGUE_EDGES`` entry, random from ``gen`` (a CPU generator):
    ``(x, act_scale, ws, bias, act, pool, a_qmax, per_frame, None,
    operand)``, x an integer accumulate (in ``(-600, 600)``) with a scale
    a frame or one, or a plain tensor in (-0.5, 1)."""
    b, shape, act, has_bias, pool, operand, form = edge
    c = shape[-1]
    if form == "plain":
        x = torch.rand((b, *shape), generator=gen) * 1.5 - 0.5
        s = ws = bias = None
    else:
        x = torch.randint(-600, 601, (b, *shape), generator=gen).float()
        s = torch.rand((b,) + (1,) * len(shape), generator=gen) * 0.01 + 1e-3
        s = s if per_frame else s.reshape(-1)[0]
        ws = torch.rand((c,), generator=gen) * 0.2 + 0.01
        bias = torch.randn((c,), generator=gen) * 0.3 if has_bias else None
    x = x.to(device)
    if form == "rows":            # a row slice: frames further apart
        x = torch.cat([x, x[:, :2]], dim=1)[:, :shape[0]]
    elif form == "odd":
        x = odd_offset(x)
    on = [None if t is None else t.to(device) for t in (s, ws, bias)]
    return (x, *on, act, pool, 15.0, per_frame, None, operand)


# the epilogue on an accumulate with a NaN and a +inf in it: (act, pool)
EPILOGUE_NAN_EDGES = [("relu", ("max", 2)), ("sign", None),
                      ("abs", ("avg", 2)), ("none", None)]


def epilogue_nan_case(edge, per_frame, gen, device):
    """The arguments of ``epilogue.ops.epilogue`` for one
    ``EPILOGUE_NAN_EDGES`` entry, as :func:`epilogue_case`'s: 3 frames of
    an 8x8x8 integer accumulate, frame 1 with a NaN in it and frame 2 a
    +inf, float32 codes. The kernel keeps them as its plain version does
    (a NaN scale and NaN codes; sign(NaN) is 0)."""
    act, pool = edge
    x = torch.randint(-600, 601, (3, 8, 8, 8), generator=gen).float()
    x[1, 2, 3, 4] = float("nan")
    x[2, 5, 1, 0] = float("inf")
    s = torch.rand((3, 1, 1, 1), generator=gen) * 0.01 + 1e-3
    s = s if per_frame else s.reshape(-1)[0]
    ws = torch.rand((8,), generator=gen) * 0.2 + 0.01
    bias = torch.randn((8,), generator=gen) * 0.3
    return (*[t.to(device) for t in (x, s, ws, bias)], act, pool, 15.0,
            per_frame, None, None)


@dataclass(frozen=True)
class EpilogueCall:
    """One epilogue call, by name: ``ops.epilogue``'s arguments (in its
    order, so a tuple of :func:`epilogue_case`'s is ``EpilogueCall(*args)``),
    ``x`` the accumulate; or, for a requant folded into its conv's store
    (``levels`` set), ``ops.epilogue_fold``'s: ``x`` the conv's uint8
    operand, ``levels`` its ``strip.IntWeights`` and ``stride`` its
    stride."""
    x: torch.Tensor
    act_scale: Optional[torch.Tensor] = None
    ws: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    act: str = "none"
    pool: Optional[tuple] = None
    a_qmax: Any = None
    per_frame: bool = False
    reduce_max: Any = None
    operand: Optional[tuple] = None
    levels: Any = None
    stride: int = 1

    @property
    def folded(self) -> bool:
        """Whether the requant is folded into its conv's store."""
        return self.levels is not None

    def requant(self) -> dict:
        """The requant's keyword arguments: ``ops.epilogue``'s but ``x``."""
        return dict(act_scale=self.act_scale, ws=self.ws, bias=self.bias,
                    act=self.act, pool=self.pool, a_qmax=self.a_qmax,
                    per_frame=self.per_frame, reduce_max=self.reduce_max,
                    operand=self.operand)


def epilogue_calls(exe, frames, per_frame: bool = True):
    """The epilogue kernel's calls in one run of ``exe`` (a compiled
    ``Executable`` on the kernel backend) on ``frames``, each an
    :class:`EpilogueCall` with its tensors cloned, so every call can be
    made again through the kernel and its plain version at the path's own
    shapes and values (:func:`epilogue_fns`); a requant folded into its
    conv's store (the plan's ``folded_epilogues``) with the conv's operand,
    levels and stride. A step left on the torch ops (tanh) is not one."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.conv_bank import strip
    calls = []
    real, real_fold = dispatch.epilogue, dispatch.conv_int_epilogue

    def cloned(t):
        return t.clone() if isinstance(t, torch.Tensor) else t

    def record(x, act_scale=None, ws=None, bias=None, act="none", pool=None,
               **kw):
        if kw["backend"] == "kernel":
            calls.append(EpilogueCall(
                cloned(x), cloned(act_scale), cloned(ws), cloned(bias), act,
                pool, a_qmax=kw["a_qmax"], per_frame=kw["per_frame"],
                operand=kw["operand"]))
        return real(x, act_scale, ws, bias, act, pool, **kw)

    def record_fold(codes, act_scale, wq, ws, bias, stride, pads, act, pool,
                    **kw):
        k = wq.shape[0]
        x8 = codes if kw["x_operand"] else strip.int_codes(codes, k, pads)
        levels = kw["levels"] if kw["levels"] is not None else \
            strip.int_weights(wq, stride=stride)
        calls.append(EpilogueCall(
            cloned(x8), cloned(act_scale), cloned(ws), cloned(bias), act,
            pool, a_qmax=kw["a_qmax"], per_frame=kw["per_frame"],
            operand=kw["operand"], levels=levels, stride=stride))
        return real_fold(codes, act_scale, wq, ws, bias, stride, pads, act,
                         pool, **kw)

    dispatch.epilogue = record
    dispatch.conv_int_epilogue = record_fold
    try:
        plan_mod._execute(exe.plan, exe.params(), frames,
                          per_frame=per_frame, backend=exe.options.backend)
    finally:
        dispatch.epilogue = real
        dispatch.conv_int_epilogue = real_fold
    return calls


def epilogue_fns(call: EpilogueCall):
    """``(kernel, plain)``: an :class:`EpilogueCall` through the kernel
    wrapper (``ops.epilogue``, or ``ops.epilogue_fold`` for a folded
    conv's) and through its plain version, each returning ``(codes,
    scale)``."""
    from repro_torch.kernels.epilogue import ops
    from repro_torch.kernels.epilogue.ref import epilogue_ref
    kw = call.requant()
    if call.folded:
        conv = dict(levels=call.levels, stride=call.stride)
        return (lambda: ops.epilogue_fold(call.x, **kw, **conv),
                lambda: ops.epilogue_fold_ref(call.x, **kw, **conv))
    return (lambda: ops.epilogue(call.x, **kw),
            lambda: epilogue_ref(call.x, **kw))


def quotient_ties(scale: float, top: int) -> np.ndarray:
    """float32 values y >= 0 whose codes at ``scale`` (``rint(y / scale)``,
    half to even) a half-integer quotient decides, for quotients up to
    ``top`` + 1: for each k the float32 nearest (k + 0.5) * scale and its
    neighbours up to 4 ulps each way, the values whose quotient is
    2^-23..2^-19 (relative) off the tie, and tiny quotients (2^-22 to
    2^-18); with 0 and ``top`` * scale. Where ``scale`` is a power of two
    the ties are exact and half to even decides them."""
    f32 = np.float32
    k = np.arange(0, top + 2, dtype=np.float64) + 0.5
    out = [f32(0), f32(top * float(scale))]
    for q in [k] + [k * (1 + sg * 2.0 ** -e) for e in range(19, 24)
                    for sg in (-1, 1)] + [2.0 ** -np.arange(18, 23)]:
        out.extend((q * float(scale)).astype(f32))
    ties = (k * float(scale)).astype(f32)
    lo, hi = ties.copy(), ties.copy()
    for _ in range(4):
        lo = np.nextafter(lo, f32(0))
        hi = np.nextafter(hi, f32(np.inf))
        out.extend(lo)
        out.extend(hi)
    return np.asarray(out, f32)


def vgg16_case(kernel, shape, batch, gen, device, levels=7):
    """Inputs of one ``VGG16_SHAPES`` entry at ``batch`` frames, random from
    ``gen`` (a generator on ``device``): conv_strip (x_padded [batch, rows
    + k - 1, w_out + k - 1, c_in] codes 0..15, w [k, k, c_in, c_out],
    stride, strip_h), photonic_mvm (a [M * batch, K] int8 codes 0..15, wq
    [K, N] int8); levels in -``levels``..``levels`` (W4)."""
    if kernel == "conv_strip":
        _, rows, strip_h, w_out, ci, co, k, stride = shape
        xp = torch.randint(0, 16, (batch, (rows - 1) * stride + k,
                                   (w_out - 1) * stride + k, ci),
                           generator=gen, device=device).float()
        w = torch.randint(-levels, levels + 1, (k, k, ci, co), generator=gen,
                          device=device).float()
        return xp, w, stride, strip_h
    _, m, k, n = shape
    a = torch.randint(0, 16, (m * batch, k), generator=gen, device=device,
                      dtype=torch.int8)
    wq = torch.randint(-levels, levels + 1, (k, n), generator=gen,
                       device=device, dtype=torch.int8)
    return a, wq


def chain_case(batch, h, w, c, specs, gen, device, levels=7):
    """Inputs of a fused chain from an edge list's spec: (codes [batch, h,
    w, c] 0..15, scale [batch, 1, 1, 1], stages ``(geom, wq int8, ws,
    bias)``), random from ``gen``; levels in -``levels``..``levels``."""
    from repro_torch.core.plan import padtype_to_pads
    from repro_torch.kernels.dispatch import ChainGeom
    stages, hh, ww, cc = [], h, w, c
    for j, (co, k, s, pad, dw, act, pool, bias) in enumerate(specs):
        co = cc if dw else co
        geom = ChainGeom(f"s{j}", hh, ww, cc, co, k, s,
                         padtype_to_pads((hh, ww), k, s, pad),
                         groups=cc if dw else 1, act=act, pool=pool)
        wq = torch.randint(-levels, levels + 1, (k, k, 1 if dw else cc, co),
                           generator=gen).to(torch.int8)
        ws = torch.rand((co,), generator=gen) * 0.1 + 0.01
        b = torch.randn((co,), generator=gen) * 0.1 if bias else None
        stages.append((geom, wq.to(device), ws.to(device),
                       None if b is None else b.to(device)))
        (hh, ww), cc = geom.out_hw(), co
    codes = torch.randint(0, 16, (batch, h, w, c), generator=gen).float()
    scale = torch.rand((batch, 1, 1, 1), generator=gen) + 0.01
    return codes.to(device), scale.to(device), stages


def odd_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past an
    allocation, so no 16-byte (or 8-, 4-byte) copy of it is aligned."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = base[1:].view(t.shape)
    out.copy_(t)
    return out
