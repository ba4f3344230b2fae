"""Compile-time plan verifier: prove the invariants the kernels assert.

The port's counterpart of ``repro.analysis.verifier``, over the port's
:class:`~repro_torch.core.plan.CompiledPlan`: the same checks, codes,
severities and message text, so a registered program's diagnostics equal
the reference's; and, under the same codes, audits of the Hopper launch
geometry the reference has no counterpart for.

**Accumulator range analysis** (``LTR001``–``LTR003``). Activations are
unsigned CRC codes in ``[0, a_qmax]`` (``a_qmax = 2^ACT_BITS - 1``: the
compile pass feeds ONE global divisor to the executor); weights are
symmetric signed codes in ``[-w_qmax, w_qmax]``. A dot product over ``K``
taps therefore satisfies

    |acc| <= a_qmax * w_qmax * K

exactly, with ``K = kernel^2 * (c_in / groups)`` for convs and
``K = fan_in`` for FC layers. float32 represents every integer with
``|x| <= 2^24`` exactly, so ``bound < 2^24`` *proves* the accumulate is
integer-exact for every possible input. The fused chain kernel sums in
float32 (``csrc/conv_chain.cu``), so this proof is what lets a verified
plan's chain launches skip ``fused.check_exact``.

**Shape legality** (``LTR010``–``LTR015``). An independent re-walk of the
layer IR from the frame shape: CA/pool divisibility, declared ``c_in`` /
``fan_in`` against the incoming tensor, depthwise channel equality, and
act/pool/upsample vocabulary.

**Strip / fusion audit** (``LTR020``–``LTR025``). The reference's checks
(the strip tiling covers the output, the resident im2col and one strip
against the budget, the fused segments' legality, halo recurrence and
working set), and the Hopper ones:

* every strip step's launch, as ``strip.dense_config`` (in the float
  kernel's form ``strip.dense_form`` gives it) / ``strip.dw_config`` /
  ``strip.igemm_config`` would choose it at batch 1 and at batch 8 (the
  last for a step the plan routed to the int8 kernel, over the conv's own
  rows), must have CTA tiles that cover the whole output (rows, columns,
  channel blocks; ``LTR020``, error), and shared memory that a CTA can
  hold (``LTR022``, warning);
* every dense layer's and resident conv's photonic_mvm launch, as
  ``photonic_mvm.ops.mvm_config`` chooses it at batch 1 and at batch 8,
  must have tiles that cover the output (``LTR020``, error), and shared
  memory a CTA can hold: 227 KB
  dynamic, 48 KB static without the opt-in (``LTR022``, warning);
* a fused segment's shared memory, the two ping-pong frame buffers and
  the reduce scratch re-derived here, must fit one CTA's
  ``SMEM_PER_BLOCK`` (``LTR024``, error);
* a conv whose requant folds into the int8 kernel's store
  (``CompiledPlan.folded_epilogues``) counts the fold's warp maxima in
  its CTA's shared memory (``LTR022``), and every requant the epilogue
  kernel runs as one clustered launch, at batch 1 and 8 under per-frame
  calibration, must have slices that cover the frame and fit a CTA
  (``LTR026``, error).

The geometry is re-derived from first principles, not imported from
``kernels.dispatch`` or ``fused.smem_layout``: a dispatch-side edit that
the kernels were not taught shows up here as an audit failure.

The port reads no environment variable: :func:`verify_mode` is ``auto``,
and ``budget=None`` means ``dispatch.DEFAULT_CONV_VMEM_BUDGET``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import (Diagnostic,
                                              PlanVerificationError, errors)

# f32 exact-integer window: every |int| <= 2^24 is representable exactly.
ACC_EXACT_LIMIT = 1 << 24

# Headroom (in bits) under which a layer gets a warning: one more doubling
# of fan-in or weight range would push it out of the exact window.
LOW_HEADROOM_BITS = 1.0

VERIFY_MODES = ("auto", "on", "off")

# Independent copies of the fusion pass's legality vocabulary, deliberately
# NOT imported from kernels.dispatch, so a dispatch-side edit that widens
# the heuristic without teaching the fused kernel shows up as an audit
# failure here instead of a silent numerics bug.
_FUSABLE_ACTS = ("relu", "abs", "sign", "none")
_KNOWN_ACTS = ("relu", "sign", "tanh", "abs", "none")
_POOL_KINDS = ("max", "avg")
_UPSAMPLE_METHODS = ("bilinear", "nearest")

# The H100's shared memory a CTA can opt into, in bytes, and the chain
# kernel's scratch after its two frame buffers (32 floats of cluster and
# warp maxima); restated from the CUDA sources, not imported.
_SMEM_PER_CTA = 232448
_CHAIN_SCRATCH = 32 * 4
# the int8 strip kernel's mma.sync forms: output pixel slots a CTA, bytes
# a staged pixel or weight row takes (a 32-byte C_in chunk and 16 unused
# bytes); its wgmma form: the tile's pixels a CTA (8 x 8 blocks, two
# warpgroups of one or two m64 blocks), the alignment of its stages and
# patch planes (a TMA box's), an mbarrier's bytes
_INT_SLOTS = 128
_INT_ROW_BYTES = 48
_INT_WGMMA_PIXELS = (128, 256)
_INT_WGMMA_ALIGN = 128
_MBARRIER = 8
# the dense float kernel's tensor-core form, as its launcher takes it: tile
# columns (an m16 block's), tile rows and output-channel blocks, a warp's
# rows and channels (an m16n8 block's), the doubles past a staged pixel's
# channels and a weight row's, its channel step and most warps a CTA
_F64_TW = 8
_F64_TH, _F64_BN = (8, 16), (16, 32)
_F64_M16_ROWS, _F64_N8 = 2, 8
_F64_PAD = 4
_F64_STEP = 8
_F64_MAX_WARPS = 16
# the batches whose strip launches are audited: batch 1 and the largest
# serving bucket
_AUDIT_BATCHES = (1, 8)
# the int8 kernel's folded epilogue: its (at most 8) warps' maxima after
# the stages;
# the epilogue's cluster CTA: the floats after its slice of y (its max,
# the warp maxima, the frame's), and the cluster sizes its entry takes
_FOLD_RED_BYTES = 8 * 4
_CLUSTER_SCRATCH = 32
# static shared memory a CTA has without the opt-in; photonic_mvm's K box
# (bytes of K a TMA box) and the skinny route's rows a CTA
_SMEM_STATIC = 48 * 1024
_MVM_KBOX = 128
_MVM_SKINNY_ROWS = 1024
_CLUSTER_SIZES = (4, 8, 16)


def verify_mode() -> str:
    """The ambient verify mode. The port reads no environment variable, so
    this is always ``auto``; ``Options(verify=)`` pins another."""
    return "auto"


# ---------------------------------------------------------------------------
# Accumulator range analysis
# ---------------------------------------------------------------------------

def acc_bound(a_qmax: int, w_qmax: int, fan_in: int) -> int:
    """Worst-case |accumulator| of a ``fan_in``-tap quantized dot product."""
    return int(a_qmax) * int(w_qmax) * int(fan_in)


def headroom_bits(bound: int) -> float:
    """log2(2^24 / bound): doublings of fan-in left inside the window."""
    return math.log2(ACC_EXACT_LIMIT / max(bound, 1))


def _check_accumulators(plan, out: List[Diagnostic],
                        include_info: bool = True) -> None:
    from repro_torch.core.plan import ConvStep, DenseStep

    a_qmax = int(plan.consts.get("a_qmax", 15))
    # the warning threshold, as a pure-integer comparison (the clean path
    # must not pay a log2 per step): headroom < LOW_HEADROOM_BITS bits
    # <=> bound * 2^LOW_HEADROOM_BITS > ACC_EXACT_LIMIT
    warn_above = int(ACC_EXACT_LIMIT / 2 ** LOW_HEADROOM_BITS)
    for step in plan.steps:
        if isinstance(step, ConvStep):
            g = step.geom
            fan_in = step.kernel * step.kernel * (g.c_in // g.groups)
        elif isinstance(step, DenseStep):
            fan_in = _dense_fan_in(plan, step)
        else:
            continue
        bound = a_qmax * step.wa.w_qmax * fan_in
        if bound < ACC_EXACT_LIMIT and bound <= warn_above \
                and not include_info:
            continue                       # proven clean: nothing to say
        kind = (f"conv k={step.kernel} c_in={step.geom.c_in}"
                + (f" groups={step.geom.groups}"
                   if step.geom.groups > 1 else "")
                if isinstance(step, ConvStep) else f"fc fan_in={fan_in}")
        if bound >= ACC_EXACT_LIMIT:
            out.append(Diagnostic(
                "LTR001", "error", step.name,
                f"worst-case |accumulator| = {a_qmax} * {step.wa.w_qmax} * "
                f"{fan_in} = {bound} >= 2^24 = {ACC_EXACT_LIMIT}: the f32 "
                f"accumulate is not integer-exact for all inputs ({kind}, "
                f"scheme {step.wa.name})",
                hint="lower w_bits for this layer (MixedPrecisionScheme), "
                     "reduce its fan-in, or split it into grouped partial "
                     "sums under 2^24 each"))
            continue
        hb = headroom_bits(bound)
        if hb < LOW_HEADROOM_BITS:
            out.append(Diagnostic(
                "LTR002", "warning", step.name,
                f"accumulator headroom is only {hb:.2f} bits "
                f"(worst-case |acc| = {bound} of {ACC_EXACT_LIMIT}): "
                f"one fan-in doubling away from losing integer "
                f"exactness",
                hint="treat this layer as frozen geometry, or lower "
                     "w_bits to buy headroom"))
        if include_info:
            out.append(Diagnostic(
                "LTR003", "info", step.name,
                f"|acc| <= {bound} < 2^24, headroom {hb:.2f} bits ({kind}, "
                f"scheme {step.wa.name})"))


def _dense_fan_in(plan, step) -> int:
    """The declared fan_in of a DenseStep, from its paired IR layer
    (steps and layers are built 1:1 by the compile pass)."""
    from repro_torch.core.accelerator import DenseSpec
    for layer, s in zip(plan.layers, plan.steps):
        if s is step and isinstance(layer, DenseSpec):
            return layer.fan_in
    raise AssertionError(f"dense step {step.name!r} has no paired DenseSpec")


# ---------------------------------------------------------------------------
# Shape legality (independent IR re-walk)
# ---------------------------------------------------------------------------

def _conv_out(hw: int, kernel: int, stride: int, padding: str) -> int:
    # independent of plan.conv_out_hw: XLA semantics re-stated from the doc
    if padding == "VALID":
        return (hw - kernel) // stride + 1
    return (hw + stride - 1) // stride            # SAME: ceil


def _check_shapes(layers: Sequence, frame_shape: Tuple[int, int, int],
                  out: List[Diagnostic]) -> None:
    from repro_torch.core.accelerator import (CASpec, ConvSpec, DenseSpec,
                                              FlattenSpec, UpsampleSpec)
    h, w, c = frame_shape
    for i, layer in enumerate(layers):
        name = getattr(layer, "name", None) \
            or f"{type(layer).__name__.lower()}.{i}"
        if isinstance(layer, CASpec):
            if h % layer.pool or w % layer.pool:
                out.append(Diagnostic(
                    "LTR010", "error", name,
                    f"CA pool={layer.pool} does not divide the incoming "
                    f"{h}x{w} frame",
                    hint="pick a frame size divisible by the CA pool, or "
                         "a pool that divides the frame"))
                return
            h, w = h // layer.pool, w // layer.pool
            rgb = (layer.rgb_to_gray if layer.rgb_to_gray is not None
                   else c == 3)
            c = 1 if (rgb or c == 1) else c
        elif isinstance(layer, ConvSpec):
            if layer.c_in != c:
                out.append(Diagnostic(
                    "LTR013", "error", name,
                    f"declares c_in={layer.c_in} but receives {c} "
                    f"channel(s): the jitted executor would fail at run "
                    f"time with a shape error",
                    hint=f"set c_in={c} (the upstream layer's output "
                         f"channels), or fix the upstream c_out"))
                return
            if layer.depthwise and layer.c_out != layer.c_in:
                out.append(Diagnostic(
                    "LTR012", "error", name,
                    f"depthwise conv needs c_out == c_in (got "
                    f"{layer.c_in} -> {layer.c_out})",
                    hint="set c_out = c_in, or drop depthwise"))
                return
            if layer.act not in _KNOWN_ACTS:
                out.append(Diagnostic(
                    "LTR015", "error", name,
                    f"unknown activation {layer.act!r}; supported: "
                    f"{_KNOWN_ACTS}",
                    hint="pick a supported activation"))
            h = _conv_out(h, layer.kernel, layer.stride, layer.padding)
            w = _conv_out(w, layer.kernel, layer.stride, layer.padding)
            c = layer.c_out
            if layer.pool is not None:
                kind, size = layer.pool
                if kind not in _POOL_KINDS:
                    out.append(Diagnostic(
                        "LTR015", "error", name,
                        f"unknown pool kind {kind!r}; supported: "
                        f"{_POOL_KINDS} (the executor would silently "
                        f"average an unknown kind)",
                        hint="use ('max', n) or ('avg', n)"))
                if h % size or w % size:
                    out.append(Diagnostic(
                        "LTR011", "error", name,
                        f"{kind}-pool size={size} does not divide the "
                        f"{h}x{w} conv output",
                        hint="adjust the frame size, conv padding, or "
                             "pool size so the output tiles evenly"))
                    return
                h, w = h // size, w // size
        elif isinstance(layer, UpsampleSpec):
            if layer.method not in _UPSAMPLE_METHODS:
                out.append(Diagnostic(
                    "LTR015", "error", name,
                    f"unknown upsample method {layer.method!r}; "
                    f"supported: {_UPSAMPLE_METHODS}",
                    hint="use 'bilinear' or 'nearest'"))
            h, w = h * layer.factor, w * layer.factor
        elif isinstance(layer, FlattenSpec):
            h, w, c = 1, 1, h * w * c
        elif isinstance(layer, DenseSpec):
            if layer.fan_in != h * w * c:
                out.append(Diagnostic(
                    "LTR014", "error", name,
                    f"declares fan_in={layer.fan_in} but receives "
                    f"{h * w * c} feature(s) "
                    f"({h}x{w}x{c}): the jitted executor would fail at "
                    f"run time with a shape error",
                    hint=f"set fan_in={h * w * c}, or insert/fix the "
                         f"Flatten/upstream layer"))
                return
            if layer.act not in _KNOWN_ACTS:
                out.append(Diagnostic(
                    "LTR015", "error", name,
                    f"unknown activation {layer.act!r}; supported: "
                    f"{_KNOWN_ACTS}",
                    hint="pick a supported activation"))
            h, w, c = 1, 1, layer.fan_out


# ---------------------------------------------------------------------------
# Strip / fusion audit (N-version re-derivation)
# ---------------------------------------------------------------------------

def _geom_out_hw(g) -> Tuple[int, int]:
    """Pre-pool conv output dims from a ChainGeom, re-derived."""
    (plo, phi), (qlo, qhi) = g.pads
    h = (g.h_in + plo + phi - g.kernel) // g.stride + 1
    w = (g.w_in + qlo + qhi - g.kernel) // g.stride + 1
    return h, w


def _geom_pooled_hw(g) -> Tuple[int, int]:
    h, w = _geom_out_hw(g)
    if g.pool is not None:
        h, w = h // g.pool[1], w // g.pool[1]
    return h, w


def _geom_stage_bytes(g) -> int:
    """f32 working set of one fused stage: padded input + output + weights
    (independent restatement of ``ChainGeom.stage_bytes``)."""
    (plo, phi), (qlo, qhi) = g.pads
    h_out, w_out = _geom_out_hw(g)
    in_b = (g.h_in + plo + phi) * (g.w_in + qlo + qhi) * g.c_in * 4
    out_b = h_out * w_out * g.c_out * 4
    w_b = g.kernel * g.kernel * (g.c_in // g.groups) * g.c_out * 4
    return in_b + out_b + w_b


def _chain_smem_bytes(geoms: Sequence) -> int:
    """Shared memory one CTA of the chain kernel needs for a segment: stage
    i reads the frame in buffer i % 2 and writes its pooled output into the
    other, so buffer 0 must hold the largest even-indexed frame (the input
    included) and buffer 1 the largest odd-indexed one; the reduce scratch
    follows them."""
    frames = [geoms[0].h_in * geoms[0].w_in * geoms[0].c_in]
    for g in geoms:
        h, w = _geom_pooled_hw(g)
        frames.append(h * w * g.c_out)
    return (max(frames[0::2]) + max(frames[1::2])) * 4 + _CHAIN_SCRATCH


def _chain_halo(geoms: Sequence) -> int:
    """Extra input rows one output row needs through the chain: the
    back-substituted recurrence ``rows_in = (rows_out - 1) * stride +
    kernel``, pool expanding ``rows_out`` first."""
    rows = 1
    for g in reversed(tuple(geoms)):
        if g.pool is not None:
            rows *= g.pool[1]
        rows = (rows - 1) * g.stride + g.kernel
    return rows - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch_rows(g, strat) -> int:
    """Output rows of the strip kernel's launch: the input is padded so
    ``n_strips`` strips of ``strip_rows`` rows tile exactly, unless it
    already has surplus rows."""
    (plo, phi), _ = g.pads
    hp = g.h_in + plo + phi
    hp = max(hp, (strat.n_strips * strat.strip_rows - 1) * g.stride
             + g.kernel)
    return (hp - g.kernel) // g.stride + 1


def _dense_smem(cfg, k: int, stride: int) -> int:
    """Shared memory of the dense strip kernel's CTA: ``stages`` C_in
    stages, each the chunk's input planes (rows padded to 4 floats,
    16-byte aligned), then its weights as float32 (16-byte aligned) and as
    float64 (``csrc/conv_strip.cu::conv_strip_launch``)."""
    rows_in = (cfg.tyt * cfg.run - 1) * stride + k
    cols_ld = _cdiv((cfg.tx - 1) * stride + k, 4) * 4
    n_w = k * k * cfg.cc * cfg.co_b
    stage = _cdiv(cfg.cc * rows_in * cols_ld * 4, 16) * 16 \
        + _cdiv(n_w * 4, 16) * 16 + n_w * 8
    return cfg.stages * stage


def _f64mma_smem(cfg, k: int) -> int:
    """Shared memory of the dense float kernel's tensor-core form: the
    stage the mma reads, the tile's input patch (halo included, ``cc``
    channels and the pad a pixel) and the chunk's k*k x ``cc`` weight
    rows (``bn`` channels and the pad) in float64, then the landing area
    of the next chunk's copies, the same without the pads in float32
    (``csrc/conv_strip_f64mma.cu::conv_strip_f64mma_launch``)."""
    pixels = (cfg.th + k - 1) * (_F64_TW + k - 1)
    weights = k * k * cfg.cc
    return (pixels * (cfg.cc + _F64_PAD) + weights * (cfg.bn + _F64_PAD)) \
        * 8 + (pixels * cfg.cc + weights * cfg.bn) * 4


def _dw_smem(cfg, k: int, stride: int) -> int:
    """Shared memory of the depthwise strip kernel's CTA: the input rows
    (``cols * cb`` floats padded to 4, plus 4), an int phase a row, 8-byte
    aligned, then the taps as float64
    (``csrc/conv_strip.cu::conv_strip_dw_launch``)."""
    rows_in = (cfg.tyt * cfg.run - 1) * stride + k
    ld = _cdiv(((cfg.tx - 1) * stride + k) * cfg.cb, 4) * 4 + 4
    return _cdiv((rows_in * ld + rows_in) * 4, 8) * 8 + k * k * cfg.cb * 8


def _int_smem(cfg, k: int, stride: int, folded: bool = False) -> int:
    """Shared memory of the int8 strip kernel's CTA. The mma.sync form:
    ``stages`` C_in stages, each the tile's input patch (halo included)
    and the chunk's k*k x ``bn`` weight rows, ``_INT_ROW_BYTES`` a pixel or
    row; with the taps folded into ``kf`` K bytes, one stage: the patch at
    4 bytes a pixel, 16-byte aligned, and ``bn`` weight rows of ``kf + 16``
    bytes. The wgmma form: the alignment's slack, then ``stages`` stages
    of ``ch / 16`` patch planes (16 channels of the patch, pitch rounded
    up to the alignment) and as many weight planes (k*k x ``bn`` rows of
    16 channels), and two mbarriers a stage
    (``csrc/conv_strip.cu::conv_strip_int_launch``,
    ``csrc/conv_strip_wgmma.cu::conv_strip_int_wgmma_launch``). Where the
    requant is ``folded`` into its store, the warp maxima after them."""
    rows_in = (cfg.th - 1) * stride + k
    cols_in = (cfg.tw - 1) * stride + k
    red = _FOLD_RED_BYTES if folded else 0
    if cfg.form == "wgmma":
        pitch = _cdiv(rows_in * cols_in * 16, _INT_WGMMA_ALIGN) * \
            _INT_WGMMA_ALIGN
        stage = cfg.ch // 16 * (pitch + k * k * cfg.bn * 16)
        return _INT_WGMMA_ALIGN + cfg.stages * (stage + 2 * _MBARRIER) + red
    if cfg.kf:
        return cfg.stages * (_cdiv(rows_in * cols_in * 4, 16) * 16
                             + cfg.bn * (cfg.kf + 16)) + red
    return cfg.stages * (rows_in * cols_in + k * k * cfg.bn) * \
        _INT_ROW_BYTES + red


def _strip_launches(g, strat, route: Optional[str] = None,
                    folded: bool = False) -> List[tuple]:
    """(kind, batch, rows, cols, c_in, c_out, config) of every strip
    kernel launch the step makes at each audited batch, with the
    configuration the wrapper would choose; general grouped convs launch
    the dense kernel once per group. ``route`` is the plan's: ``"int"``
    launches the int8 kernel over the conv's own rows (kind
    ``"int_folded"`` where its requant is ``folded`` into the store)."""
    from repro_torch.kernels.conv_bank import strip
    rows = _launch_rows(g, strat)
    h_out, w_out = _geom_out_hw(g)
    out = []
    for b in _AUDIT_BATCHES:
        if route == "int":
            cg, og = g.c_in // g.groups, g.c_out // g.groups
            out.append(("int_folded" if folded else "int", b, h_out, w_out,
                        cg, og,
                        strip.igemm_config(b, h_out, w_out, cg, og,
                                           g.kernel, g.stride)))
        elif g.groups > 1 and g.c_out == g.groups == g.c_in:
            out.append(("depthwise", b, rows, w_out, g.c_in, g.c_out,
                        strip.dw_config(b, rows, w_out, g.c_in, g.kernel,
                                        g.stride)))
        else:
            cg, og = g.c_in // g.groups, g.c_out // g.groups
            out.append(("dense", b, rows, w_out, cg, og,
                        strip.dense_config(b, rows, w_out, cg, og,
                                           g.kernel, g.stride)))
    return out


def _check_strip_launch(name: str, g, launch, out: List[Diagnostic]) -> None:
    """One strip launch against the output it must cover and the shared
    memory a CTA has. The kernel's grid is batch x row tiles x column
    tiles x channel blocks, each tile ``tx`` columns by ``tyt * run``
    rows, one block ``co_b`` (dense) or ``cb`` (depthwise) channels; the
    row tiles are what the recorded CTA count leaves after the others."""
    kind, b, rows, cols, c_in, c_out, cfg = launch
    folded = kind == "int_folded"
    kind = "int" if folded else kind
    if kind == "int":
        tile_w, tile_h, block = cfg.tw, cfg.th, cfg.bn
        degenerate = min(tile_w, tile_h, block) < 1 or (
            tile_w % 8 or tile_h % 8 or
            tile_w * tile_h not in _INT_WGMMA_PIXELS
            if cfg.form == "wgmma" else tile_w * tile_h > _INT_SLOTS)
    elif kind == "dense" and cfg.form == "f64mma":
        tile_w, tile_h, block = cfg.tw, cfg.th, cfg.bn
        degenerate = (
            tile_w != _F64_TW or tile_h not in _F64_TH or
            block not in _F64_BN or
            tile_h // _F64_M16_ROWS * (block // _F64_N8) >
            _F64_MAX_WARPS or cfg.cc < _F64_STEP or cfg.cc % _F64_STEP or
            cfg.cc > _cdiv(c_in, _F64_STEP) * _F64_STEP)
    else:
        tile_w, tile_h = cfg.tx, cfg.tyt * cfg.run
        block = cfg.co_b if kind == "dense" else cfg.cb
        degenerate = min(cfg.tx, cfg.tyt, cfg.run, block) < 1 or (
            kind == "dense" and not 1 <= cfg.cc <= c_in)
    what = (f"{kind} strip launch at batch {b} ({rows}x{cols}x{c_out}, "
            f"tile {tile_w}x{tile_h}, {block}-channel blocks, "
            f"{cfg.ctas} CTAs)")
    if degenerate:
        out.append(Diagnostic(
            "LTR020", "error", name,
            f"{what} has a degenerate tile or C_in chunk",
            hint="this is a strip_config/dw_config/igemm_config/"
                 "f64mma_config bug: every tile dimension must be >= 1, "
                 "the chunk within C_in, an int8 tile within its pixel "
                 "slots (the wgmma form: 8 x 8 blocks, 128 or 256 pixels) "
                 "and a float64 tensor-core tile its launcher takes (8 or "
                 "16 rows x 8 columns, 16 or 32 channels, 16 warps at "
                 "most) with a chunk "
                 "of 8-channel steps"))
        return
    col_tiles = _cdiv(cols, tile_w)
    blocks = _cdiv(c_out, block)
    row_tiles = cfg.ctas // max(b * col_tiles * blocks, 1)
    covered = (row_tiles * tile_h, col_tiles * tile_w, blocks * block)
    if covered[0] < rows or covered[1] < cols or covered[2] < c_out:
        out.append(Diagnostic(
            "LTR020", "error", name,
            f"{what} does not cover the output: its tiles reach "
            f"{covered[0]} rows, {covered[1]} columns and {covered[2]} "
            f"channels of {rows}x{cols}x{c_out} — the kernel would drop "
            f"outputs",
            hint="this is a strip_config/dw_config/igemm_config bug in "
                 "the CTA count or the tile it records"))
    smem = (_int_smem(cfg, g.kernel, g.stride, folded) if kind == "int"
            else _f64mma_smem(cfg, g.kernel)
            if kind == "dense" and cfg.form == "f64mma"
            else {"dense": _dense_smem, "depthwise": _dw_smem}[kind](
                cfg, g.kernel, g.stride))
    if smem > _SMEM_PER_CTA:
        out.append(Diagnostic(
            "LTR022", "warning", name,
            f"{what} needs {smem} bytes of shared memory; a CTA has "
            f"{_SMEM_PER_CTA} — the launch would be refused",
            hint="a smaller tile or C_in chunk in strip_config/dw_config/"
                 "igemm_config"))


def mvm_launches(plan) -> List[tuple]:
    """(name, batch, m, k, n, config) of every photonic_mvm launch the
    plan's per-layer path makes at each audited batch: each dense layer's
    ([batch, fan_in] codes) and each resident conv's im2col GEMM (one a
    group, all alike), with the launch ``photonic_mvm.ops.mvm_config``
    gives it."""
    from repro_torch.core.accelerator import DenseSpec
    from repro_torch.core.plan import ConvStep, DenseStep
    from repro_torch.kernels.photonic_mvm.ops import mvm_config
    out = []
    for layer, step in zip(plan.layers, plan.steps):
        for b in _AUDIT_BATCHES:
            if isinstance(step, DenseStep) and isinstance(layer, DenseSpec):
                m, k, n = b, layer.fan_in, layer.fan_out
            elif isinstance(step, ConvStep) and step.strategy is not None \
                    and step.strategy.kind == "resident":
                g = step.geom
                h, w = _geom_out_hw(g)
                m, k = b * h * w, g.kernel * g.kernel * (g.c_in // g.groups)
                n = g.c_out // g.groups
            else:
                continue
            out.append((step.name, b, m, k, n, mvm_config(m, k, n)))
    return out


def _mvm_smem(cfg, n: int) -> Tuple[int, bool]:
    """Shared memory of one photonic_mvm CTA under ``cfg`` and whether it
    is dynamic (opted into past 48 KB), restated from
    ``csrc/photonic_mvm.cu``: skinny, static, 1,024 rows of 32 codes (+16)
    and 32 x N int32 levels; gemm, static, a 3-stage ring of (bm + bn)
    rows of 48 bytes; stream, dynamic, 4 stages of 8 boxes of 16 x 128
    bytes, sixteen 16 x 16 int32 tiles, 8 mbarriers and 1 KB of
    alignment; wgmma, dynamic, 4 stages of a 64 x 128-byte box of codes and one of
    levels, 8 mbarriers and 1 KB of alignment."""
    if cfg.route == "skinny":
        return _MVM_SKINNY_ROWS * 32 + 16 + 4 * 32 * n, False
    if cfg.route == "gemm":
        return 3 * (cfg.bm + cfg.bn) * 48, False
    if cfg.route == "stream":
        return 4 * 8 * 16 * _MVM_KBOX + 16 * 256 * 4 + 8 * 8 + 1024, True
    return 4 * (cfg.bm + cfg.bn) * _MVM_KBOX + 8 * 8 + 1024, True


def _check_mvm_launch(name: str, b: int, m: int, k: int, n: int, cfg,
                      out: List[Diagnostic]) -> None:
    """One photonic_mvm launch against the output it must cover and the
    shared memory a CTA has. The grid is the route's tiles, each over all
    of K: the stream route's 16-channel tiles cover every row of codes (bm
    of them), the skinny route's 1,024-row runs every channel, the others
    bm x bn tiles."""
    what = (f"photonic_mvm launch at batch {b} ({m}x{k}x{n}, {cfg.route} "
            f"tile {cfg.bm}x{cfg.bn}, {cfg.ctas} CTAs)")
    if min(cfg.bm, cfg.bn) < 1:
        out.append(Diagnostic(
            "LTR020", "error", name,
            f"{what} has a degenerate tile",
            hint="this is a photonic_mvm.ops.mvm_config bug: every tile "
                 "dimension must be >= 1"))
        return
    tiles = cfg.ctas
    if cfg.route == "skinny":
        covered = (tiles * cfg.bm, cfg.bn)
    elif cfg.route == "stream":
        covered = (cfg.bm, tiles * cfg.bn)
    else:
        col_tiles = _cdiv(n, cfg.bn)
        covered = (tiles // col_tiles * cfg.bm, col_tiles * cfg.bn)
    if covered[0] < m or covered[1] < n:
        out.append(Diagnostic(
            "LTR020", "error", name,
            f"{what} does not cover the output: its tiles reach "
            f"{covered[0]} rows and {covered[1]} channels of {m}x{n} — "
            f"the kernel would drop outputs",
            hint="this is a photonic_mvm.ops.mvm_config bug in the CTA "
                 "count or the tile it records"))
    smem, dynamic = _mvm_smem(cfg, n)
    if smem > _SMEM_PER_CTA or (not dynamic and smem > _SMEM_STATIC):
        out.append(Diagnostic(
            "LTR022", "warning", name,
            f"{what} needs {smem} bytes of "
            f"{'dynamic' if dynamic else 'static'} shared memory; a CTA "
            f"has {_SMEM_PER_CTA if dynamic else _SMEM_STATIC} "
            f"{'' if dynamic else 'without the opt-in '}— the launch "
            f"would be refused",
            hint="a smaller tile or ring in photonic_mvm.ops.mvm_config"))


def _check_strategies(plan, budget: int, out: List[Diagnostic]) -> None:
    from repro_torch.core.plan import ConvStep

    for step in plan.steps:
        if not isinstance(step, ConvStep) or step.strategy is None:
            continue
        g = step.geom
        h_out, w_out = _geom_out_hw(g)
        strat = step.strategy
        if strat.kind == "resident":
            patch = h_out * w_out * step.kernel * step.kernel * g.c_in * 4
            if patch > budget:
                out.append(Diagnostic(
                    "LTR021", "warning", step.name,
                    f"resident conv's im2col patch matrix is "
                    f"{patch / 2**20:.1f} MB, over the "
                    f"{budget / 2**20:.1f} MB VMEM budget (forced "
                    f"resident, or a heuristic/budget mismatch)",
                    hint="let conv_strategy='auto' strip-mine this "
                         "layer, or raise REPRO_CONV_VMEM_BUDGET"))
        elif strat.kind == "strip":
            if strat.strip_rows < 1 or strat.n_strips < 1:
                out.append(Diagnostic(
                    "LTR020", "error", step.name,
                    f"strip strategy carries degenerate geometry "
                    f"(strip_rows={strat.strip_rows}, "
                    f"n_strips={strat.n_strips})",
                    hint="this is a dispatch-heuristic bug: "
                         "_strip_geometry must return >= 1 rows/strips"))
                continue
            if strat.strip_rows * strat.n_strips < h_out:
                out.append(Diagnostic(
                    "LTR020", "error", step.name,
                    f"strip tiling does not cover the output: "
                    f"{strat.n_strips} strips x {strat.strip_rows} rows "
                    f"= {strat.n_strips * strat.strip_rows} < "
                    f"h_out={h_out} — the kernel would drop output rows",
                    hint="this is a dispatch-heuristic bug in "
                         "_strip_geometry's ceil-division"))
            (plo, phi), (qlo, qhi) = g.pads
            in_rows = (strat.strip_rows - 1) * g.stride + g.kernel
            strip_bytes = in_rows * (g.w_in + qlo + qhi) * g.c_in * 4
            if strat.strip_rows > 1 and strip_bytes > budget:
                out.append(Diagnostic(
                    "LTR022", "warning", step.name,
                    f"one input strip (+halo) is "
                    f"{strip_bytes / 2**20:.1f} MB, over the full "
                    f"{budget / 2**20:.1f} MB VMEM budget",
                    hint="shrink REPRO_CONV_VMEM_BUDGET-derived strips "
                         "or check _strip_geometry's row bound"))
            for launch in _strip_launches(
                    g, strat, plan.strip_routes.get(step.name),
                    step.name in getattr(plan, "folded_epilogues", ())):
                _check_strip_launch(step.name, g, launch, out)
        else:
            out.append(Diagnostic(
                "LTR020", "error", step.name,
                f"unknown conv strategy kind {strat.kind!r}",
                hint="expected 'resident' or 'strip'"))


def _epilogue_requants(plan) -> List[tuple]:
    """(name, n, c, p, operand words) of each requant the epilogue kernel
    runs in a per-frame run of ``plan``: the frames', and each step's
    outside the fused segments (which run under per-frame calibration),
    the torch epilogues and the folded convs, re-derived from the layer
    walk: ``n`` pooled elements a frame of ``c`` channels (a flat
    vector's: ``c`` its length), pooled by ``p``; the next int8 conv's
    operand words a frame where the plan hands it one, else 0."""
    from repro_torch.core.accelerator import CASpec, DenseSpec
    from repro_torch.core.plan import (CAStep, ConvStep, DenseStep,
                                       FlattenStep, UpsampleStep)
    from repro_torch.kernels.conv_bank.strip import igemm_c_in
    steps = plan.steps
    fused = {i for sg in plan.fused_segments
             for i in range(sg.start, sg.start + sg.length)}
    skip = set(plan.torch_epilogues) | set(
        getattr(plan, "folded_epilogues", ()))

    def words(i, h, w, c):
        nxt = steps[i] if i < len(steps) else None
        if not isinstance(nxt, ConvStep) or nxt.name not in \
                plan.int_operands:
            return 0
        (top, bottom), (left, right) = nxt.pads
        return (h + top + bottom) * (w + left + right) * \
            igemm_c_in(c, nxt.kernel) // 4

    h, w, c = plan.frame_shape
    out = [("frames", h * w * c, c, 1, words(0, h, w, c))]
    for i, (layer, step) in enumerate(zip(plan.layers, steps)):
        p, flat = 1, False
        if isinstance(step, CAStep) and isinstance(layer, CASpec):
            h, w = h // step.pool, w // step.pool
            c = 1 if step.rgb_to_gray else c
        elif isinstance(step, ConvStep):
            h, w = _geom_pooled_hw(step.geom)
            c = step.geom.c_out
            p = step.pool[1] if step.pool is not None else 1
        elif isinstance(step, UpsampleStep):
            h, w = h * step.factor, w * step.factor
        elif isinstance(step, FlattenStep):
            h, w, c, flat = 1, 1, h * w * c, True
        elif isinstance(step, DenseStep) and isinstance(layer, DenseSpec):
            h, w, c, flat = 1, 1, layer.fan_out, True
            if step.act == "none":
                continue
        if i in fused or getattr(step, "name", None) in skip:
            continue
        out.append((getattr(step, "name", type(step).__name__), h * w * c,
                    c, p, 0 if flat else words(i + 1, h, w, c)))
    return out


def _check_epilogue_clusters(plan, out: List[Diagnostic]) -> None:
    """Every requant the epilogue kernel runs as one clustered launch (at
    batch 1 and 8, per frame, frames aligned or not), with the launch
    ``epilogue.ops.epilogue_config`` would choose: its CTAs' slices of y,
    re-derived here (whole ``vec``-units; whole groups of pixels where it
    writes an operand), must cover the frame and, with the scratch after
    them, fit a CTA's shared memory, in a cluster the kernel takes."""
    from repro_torch.kernels.epilogue.ops import epilogue_config
    for name, n, c, p, op_words in _epilogue_requants(plan):
        for b in _AUDIT_BATCHES:
            for aligned in (True, False):
                cfg = epilogue_config(b, n, c, aligned, op_words, p, True)
                if not cfg.cluster:
                    continue
                vec, cl = cfg.vec, cfg.cluster
                if op_words:
                    gp = 1 if vec == 1 or c % 4 == 0 else (
                        4 if c % 2 else 2)
                    per = _cdiv(_cdiv(n // c, gp), cl) * gp * c
                else:
                    per = _cdiv(n // vec, cl) * vec
                smem = (_cdiv(per, 4) * 4 + _CLUSTER_SCRATCH) * 4
                bad = None
                if cl not in _CLUSTER_SIZES:
                    bad = f"a cluster of {cl} CTAs"
                elif n % vec or per * cl < n:
                    bad = (f"{cl} slices of {per} elements for a frame of "
                           f"{n} in units of {vec}")
                elif smem > cfg.smem or smem > _SMEM_PER_CTA:
                    bad = (f"{smem} bytes of shared memory a CTA (launched "
                           f"with {cfg.smem}; a CTA has {_SMEM_PER_CTA})")
                if bad:
                    out.append(Diagnostic(
                        "LTR026", "error", name,
                        f"the epilogue's clustered requant at batch {b} "
                        f"({n} elements a frame, {c} channels): {bad} — "
                        f"the launch would be refused or drop codes",
                        hint="epilogue_config's cluster rule and the "
                             "audit disagree"))
                    return


def audit_fused_segments(geoms: Sequence, segments: Sequence,
                         budget: int) -> List[Diagnostic]:
    """Audit ``select_fused_segments`` output against an independent
    legality re-derivation.

    ``geoms`` is the step-aligned geometry list the selector consumed
    (``ChainGeom`` per conv step, ``None`` elsewhere); ``segments`` its
    output. Errors mean the heuristic selected a segment the fused
    kernel cannot legally execute (an illegal stage, or frames over one
    CTA's shared memory), or recorded halo/VMEM numbers that disagree
    with the recurrence.
    """
    out: List[Diagnostic] = []
    covered: set = set()
    for seg in segments:
        name = "+".join(seg.names) or f"segment@{seg.start}"
        span = range(seg.start, seg.start + seg.length)
        if seg.start < 0 or seg.start + seg.length > len(geoms):
            out.append(Diagnostic(
                "LTR023", "error", name,
                f"fused segment [{seg.start}, {seg.start + seg.length}) "
                f"falls outside the {len(geoms)}-step plan",
                hint="select_fused_segments emitted a bad start/length"))
            continue
        if any(i in covered for i in span):
            out.append(Diagnostic(
                "LTR023", "error", name,
                "fused segments overlap: one step is claimed by two "
                "launches",
                hint="select_fused_segments must emit disjoint runs"))
        covered.update(span)
        run = [geoms[i] for i in span]
        bad = None
        for g in run:
            if g is None:
                bad = "covers a non-conv step"
            elif g.groups != 1 and not g.depthwise:
                bad = f"stage {g.name!r} is grouped but not depthwise"
            elif g.act not in _FUSABLE_ACTS:
                bad = (f"stage {g.name!r} activation {g.act!r} has no "
                       f"fused epilogue (supported: {_FUSABLE_ACTS})")
            elif g.pool is not None and g.pool[0] not in _POOL_KINDS:
                bad = f"stage {g.name!r} pool kind {g.pool[0]!r} unknown"
            if bad:
                break
        if bad:
            out.append(Diagnostic(
                "LTR023", "error", name,
                f"illegal fused segment: {bad} — the megakernel would "
                f"compute the wrong epilogue or crash",
                hint="this is a _fusable/select_fused_segments bug; the "
                     "segment must be split at the illegal stage"))
            continue
        halo = _chain_halo(run)
        if halo != seg.halo_rows:
            out.append(Diagnostic(
                "LTR024", "error", name,
                f"halo audit mismatch: plan records {seg.halo_rows} "
                f"rows, the back-substituted recurrence derives {halo}",
                hint="_chain_halo_rows and the audit disagree — one of "
                     "them mis-handles a stride/pool/kernel case"))
        vmem = max(_geom_stage_bytes(g) for g in run)
        if vmem != seg.vmem_bytes:
            out.append(Diagnostic(
                "LTR024", "error", name,
                f"VMEM audit mismatch: plan records {seg.vmem_bytes} "
                f"bytes, the independent footprint sum derives {vmem}",
                hint="ChainGeom.stage_bytes and the audit disagree on "
                     "padded-input/output/weight accounting"))
        elif vmem > budget:
            out.append(Diagnostic(
                "LTR025", "warning", name,
                f"fused segment peak stage working set "
                f"{vmem / 2**20:.1f} MB exceeds the "
                f"{budget / 2**20:.1f} MB VMEM budget (fuse='on' skips "
                f"the budget check)",
                hint="let fuse='auto' split the run, or raise "
                     "REPRO_CONV_VMEM_BUDGET"))
        smem = _chain_smem_bytes(run)
        if smem > _SMEM_PER_CTA:
            out.append(Diagnostic(
                "LTR024", "error", name,
                f"shared-memory audit: the segment's two frame buffers "
                f"and reduce scratch need {smem} bytes, over the "
                f"{_SMEM_PER_CTA} one CTA of the chain kernel has — the "
                f"plan selected a segment the kernel cannot launch",
                hint="select_fused_segments' fit rule and the audit "
                     "disagree; the run must be split where it stops "
                     "fitting"))
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def verify_plan(plan, budget: Optional[int] = None,
                include_info: bool = True) -> Tuple[Diagnostic, ...]:
    """Run every verifier check over a :class:`CompiledPlan`.

    Returns ALL diagnostics (info included), ordered check-by-check; use
    :func:`repro_torch.analysis.diagnostics.errors` for the fatal subset,
    or :func:`raise_on_errors` to throw. ``budget`` is the conv budget the
    plan was compiled under; ``None`` means
    ``dispatch.DEFAULT_CONV_VMEM_BUDGET`` (what ``Options()`` compiles
    with). ``include_info=False`` skips constructing info-severity
    diagnostics (the per-step headroom report): the compile path uses it,
    because ``ModelReport.verification`` stores warnings and errors only.
    """
    from repro_torch.core.plan import ConvStep
    from repro_torch.kernels import dispatch

    if budget is None:
        budget = dispatch.DEFAULT_CONV_VMEM_BUDGET
    out: List[Diagnostic] = []
    _check_shapes(plan.layers, plan.frame_shape, out)
    _check_accumulators(plan, out, include_info=include_info)
    _check_strategies(plan, budget, out)
    for launch in mvm_launches(plan):
        _check_mvm_launch(*launch, out)
    _check_epilogue_clusters(plan, out)
    geoms = [s.geom if isinstance(s, ConvStep) else None
             for s in plan.steps]
    out.extend(audit_fused_segments(geoms, plan.fused_segments, budget))
    return tuple(out)


def raise_on_errors(diags: Sequence[Diagnostic]) -> None:
    """Raise :class:`PlanVerificationError` if any error-severity
    diagnostic is present; no-op otherwise."""
    if errors(diags):
        raise PlanVerificationError(diags)
