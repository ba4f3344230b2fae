"""Static compile pass + eager execute pass for the Lightator device.

  _compile_model(layers, input_shape, scheme, ...) -> CompiledPlan
      Shape inference over the layer IR, per-layer ``WASpec``s, every
      ``OCSchedule`` and the power/latency ``ModelReport``, the conv
      strategies and the fused segments — once per (IR, frame shape,
      scheme, hardware, strategy options), cached. Plans and reports equal
      the reference package's field for field.

  _execute_steps(steps, params, frames, consts, per_frame, segments, backend)
      The device forward, batch-first, every device op through
      ``kernels.dispatch``. It runs eagerly, op by op, so no two float
      operations are ever contracted into an FMA, and every division is a
      true IEEE division (``quant.true_div``): the numerics are the
      reference's jitted executor's, bit for bit.

Observation (``repro_torch.obs``): ``plan.cache.hit`` / ``plan.cache.miss``
counters and events and a ``plan.compile`` span per cache miss. The
reference's jit-trace-time hooks (the ``dispatch.fused.fallback`` counter
and event, the ``plan.trace.fused_segment`` span, the ``dispatch.conv.*``
counters) fire in the first run of each trace family of a plan: its
backend, device, calibration and batch shape (``_execute``). The port has
no trace time; this is its equivalent, on the eager path and on the
bound path (whose eager run before each capture is a bucket's first).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import optical_core as ocore
from repro_torch.core import power_model as pmod
from repro_torch.core.accelerator import (CASpec, ConvSpec, DenseSpec,
                                          FlattenSpec, UpsampleSpec,
                                          _activation, _crc_requant, _pool)
from repro_torch.core.compressive import upsample_reconstruct
from repro_torch.core.quant import (ACT_BITS, MixedPrecisionScheme, WASpec,
                                    quantize_weight, resolve_layer_specs)
from repro_torch.kernels import dispatch


def conv_out_hw(hw: int, kernel: int, stride: int, padding: str) -> int:
    """Spatial output size of a conv, matching XLA's SAME/VALID semantics."""
    if padding == "VALID":
        return (hw - kernel) // stride + 1
    return -(-hw // stride)                      # SAME: ceil(hw / stride)


def padtype_to_pads(hw: Tuple[int, int], kernel: int, stride: int,
                    padding: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((lo, hi), (lo, hi)) explicit padding of a SAME/VALID conv."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    pads = []
    for n in hw:
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


# ---------------------------------------------------------------------------
# Plan steps: the IR annotated with everything shape-derived
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CAStep:
    pool: int
    rgb_to_gray: bool


@dataclasses.dataclass(frozen=True)
class ConvStep:
    name: str
    wa: WASpec
    kernel: int
    stride: int
    act: str
    pool: Optional[Tuple[str, int]]
    pads: Tuple[Tuple[int, int], Tuple[int, int]]
    groups: int = 1
    strategy: Optional[dispatch.ConvStrategy] = None
    geom: Optional[dispatch.ChainGeom] = None


@dataclasses.dataclass(frozen=True)
class UpsampleStep:
    factor: int
    method: str                     # "bilinear" | "nearest"


@dataclasses.dataclass(frozen=True)
class FlattenStep:
    pass


@dataclasses.dataclass(frozen=True)
class DenseStep:
    name: str
    wa: WASpec
    act: str


PlanStep = CAStep | ConvStep | UpsampleStep | FlattenStep | DenseStep


@dataclasses.dataclass(eq=False)
class CompiledPlan:
    """Everything the execute pass needs, resolved once from shapes.

    ``report`` is the power/latency/FPS-per-W report for one frame. A plan
    is batch-agnostic. ``consts`` holds the quantization divisors.
    """

    layers: tuple
    frame_shape: Tuple[int, int, int]         # per-frame [H, W, C]
    scheme: WASpec | MixedPrecisionScheme
    steps: Tuple[PlanStep, ...]
    schedules: Tuple[ocore.OCSchedule, ...]
    layer_specs: Tuple[WASpec, ...]
    report: pmod.ModelReport
    out_features: int
    consts: Dict[str, object] = dataclasses.field(default_factory=dict)
    fused_segments: Tuple[dispatch.FusedSegmentSpec, ...] = ()
    # the trace families this plan has run (``_execute``)
    _families: set = dataclasses.field(default_factory=set, repr=False)

    def first_run(self, family: tuple) -> bool:
        """Record that ``family`` runs; True the first time."""
        with _FAMILY_LOCK:
            if family in self._families:
                return False
            self._families.add(family)
            return True


_FAMILY_LOCK = threading.Lock()
_NO_SPAN = contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Compile pass
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict[tuple, CompiledPlan] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def plan_cache_stats() -> Dict[str, int]:
    return dict(_CACHE_STATS)


def _compile_model(layers: Sequence, input_shape: Tuple[int, ...],
                   scheme: WASpec | MixedPrecisionScheme,
                   oc: ocore.OCConfig = ocore.DEFAULT_OC,
                   circuit: pmod.CircuitConstants = pmod.DEFAULT_CIRCUIT,
                   profile: pmod.AcceleratorProfile = pmod.LIGHTATOR_PROFILE,
                   weight_sram_kb: float = 512.0,
                   act_sram_kb: float = 256.0,
                   fc_batch: int = 1,
                   conv_strategy: str = "auto",
                   conv_vmem_budget: int = dispatch.DEFAULT_CONV_VMEM_BUDGET,
                   fuse: Optional[str] = None) -> CompiledPlan:
    """Resolve specs, shapes, OC schedules and the power report — once.

    ``input_shape`` is [B, H, W, C] or [H, W, C]; plans are cached on the
    per-frame dims. ``fc_batch`` schedules FC layers at the served batch
    size (the report stays per frame). ``fuse`` defaults to the mode the
    conv strategy implies (``dispatch.conv_fuse_mode``).
    """
    if fc_batch < 1:
        raise ValueError(f"fc_batch must be >= 1, got {fc_batch}")
    layers = tuple(layers)
    frame_shape = tuple(int(d) for d in input_shape[-3:])
    if len(frame_shape) != 3:
        raise ValueError(f"input_shape {input_shape} must be [B,H,W,C] or "
                         f"[H,W,C]")
    fuse_mode = fuse if fuse is not None else dispatch.conv_fuse_mode(
        conv_strategy)
    key = (layers, frame_shape, scheme, oc, circuit, profile,
           weight_sram_kb, act_sram_kb, fc_batch,
           (conv_strategy, conv_vmem_budget, fuse_mode))
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _CACHE_STATS["hits"] += 1
        obs.counter("plan.cache.hit").inc()
        if obs.enabled():
            obs.event("plan.cache.hit",
                      attrs={"frame_shape": list(frame_shape),
                             "layers": len(layers)})
        return cached
    _CACHE_STATS["misses"] += 1
    obs.counter("plan.cache.miss").inc()
    with obs.span("plan.compile",
                  attrs={"frame_shape": list(frame_shape),
                         "layers": len(layers), "fc_batch": fc_batch,
                         "conv_strategy": conv_strategy, "fuse": fuse_mode}):
        plan = _compile_model_uncached(
            layers, frame_shape, scheme, oc, circuit, profile,
            weight_sram_kb, act_sram_kb, fc_batch, conv_strategy,
            conv_vmem_budget, fuse_mode)
    _PLAN_CACHE[key] = plan
    return plan


def _compile_model_uncached(layers, frame_shape, scheme, oc, circuit,
                            profile, weight_sram_kb, act_sram_kb, fc_batch,
                            conv_mode, conv_budget,
                            fuse_mode) -> CompiledPlan:
    compute_layers = [l for l in layers if isinstance(l, (ConvSpec, DenseSpec))]
    spec_iter = iter(resolve_layer_specs(len(compute_layers), scheme))

    steps: List[PlanStep] = []
    schedules: List[ocore.OCSchedule] = []
    spec_list: List[WASpec] = []

    h, w, c = frame_shape
    out_features = 0
    for layer in layers:
        if isinstance(layer, CASpec):
            if h % layer.pool or w % layer.pool:
                raise ValueError(
                    f"CA pool={layer.pool} does not divide frame {h}x{w}")
            h, w = h // layer.pool, w // layer.pool
            rgb = layer.rgb_to_gray if layer.rgb_to_gray is not None else (c == 3)
            c_out = 1 if (rgb or c == 1) else c
            schedules.append(ocore.schedule_ca(
                "CA", h, w, layer.pool, channels=frame_shape[-1], oc=oc))
            spec_list.append(WASpec(4, 4))
            steps.append(CAStep(layer.pool, rgb))
            c = c_out
        elif isinstance(layer, ConvSpec):
            wa = next(spec_iter)
            if layer.depthwise and layer.c_out != layer.c_in:
                raise ValueError(
                    f"{layer.name}: depthwise conv needs c_out == c_in "
                    f"(got {layer.c_in} -> {layer.c_out})")
            pads = padtype_to_pads((h, w), layer.kernel, layer.stride,
                                   layer.padding)
            h_out = conv_out_hw(h, layer.kernel, layer.stride, layer.padding)
            w_out = conv_out_hw(w, layer.kernel, layer.stride, layer.padding)
            groups = layer.c_in if layer.depthwise else 1
            strat = dispatch.select_conv_strategy(
                h_out, w_out, layer.c_in, layer.c_out, layer.kernel,
                layer.stride, groups=groups, mode=conv_mode,
                budget=conv_budget)
            geom = dispatch.ChainGeom(
                layer.name, h, w, layer.c_in, layer.c_out, layer.kernel,
                layer.stride, pads, groups=groups, act=layer.act,
                pool=layer.pool)
            h, w, c = h_out, w_out, layer.c_out
            if layer.pool is not None:
                kind, size = layer.pool
                if h % size or w % size:
                    raise ValueError(
                        f"{layer.name}: {kind}-pool size={size} does not "
                        f"divide its {h}x{w} conv output")
                h, w = h // size, w // size
                if kind == "avg":
                    # avg pooling runs on CA banks with pre-set weights,
                    # scheduled before the conv (the reference's order)
                    schedules.append(ocore.schedule_ca(
                        f"{layer.name}.pool", h, w, size, channels=1, oc=oc))
                    spec_list.append(WASpec(4, 4))
            # the conv is scheduled with its post-pool output dims, and a
            # depthwise conv's output channels each see one input channel
            # (both as the reference schedules them)
            sched_c_in = 1 if layer.depthwise else layer.c_in
            schedules.append(ocore.schedule_conv(
                layer.name, h, w, sched_c_in, layer.c_out, layer.kernel,
                oc=oc))
            spec_list.append(wa)
            steps.append(ConvStep(layer.name, wa, layer.kernel, layer.stride,
                                  layer.act, layer.pool, pads, groups=groups,
                                  strategy=strat, geom=geom))
        elif isinstance(layer, UpsampleSpec):
            if layer.method not in ("bilinear", "nearest"):
                raise ValueError(f"unknown upsample method {layer.method!r}")
            h, w = h * layer.factor, w * layer.factor
            taps = 2 if layer.method == "bilinear" else 1
            schedules.append(ocore.schedule_ca(
                f"upsample.{len(steps)}", h, w * c, taps, channels=1, oc=oc))
            spec_list.append(WASpec(4, 4))
            steps.append(UpsampleStep(layer.factor, layer.method))
        elif isinstance(layer, FlattenSpec):
            h, w, c = 1, 1, h * w * c
            steps.append(FlattenStep())
        elif isinstance(layer, DenseSpec):
            wa = next(spec_iter)
            schedules.append(ocore.schedule_fc(
                layer.name, layer.fan_in, layer.fan_out, batch=fc_batch,
                oc=oc))
            spec_list.append(wa)
            steps.append(DenseStep(layer.name, wa, layer.act))
            c = layer.fan_out
            out_features = layer.fan_out
        else:
            raise TypeError(f"unknown layer IR {layer!r}")

    power = pmod.PowerModel(oc, circuit, profile, weight_sram_kb, act_sram_kb)
    lps = []
    for s, sp in zip(schedules, spec_list):
        lp = power.layer_power(pmod.LayerSchedule(s, sp))
        if fc_batch > 1 and s.kind == "fc":
            lp.cycles = -(-lp.cycles // fc_batch)
            lp.remap_cycles = -(-lp.remap_cycles // fc_batch)
        lps.append(lp)
    report = power.finalize_report(lps, schedules, scheme)
    report.conv_strategy = {
        s.name: dataclasses.asdict(s.strategy) for s in steps
        if isinstance(s, ConvStep)}
    fused_segments = dispatch.select_fused_segments(
        [s.geom if isinstance(s, ConvStep) else None for s in steps],
        mode=fuse_mode, budget=conv_budget)
    report.fused_segments = [dataclasses.asdict(f) for f in fused_segments]

    consts = {
        "a_qmax": float((1 << ACT_BITS) - 1),
        "w_qmax": {s.name: float(s.wa.w_qmax) for s in steps
                   if isinstance(s, (ConvStep, DenseStep))},
    }
    return CompiledPlan(layers, frame_shape, scheme, tuple(steps),
                        tuple(schedules), tuple(spec_list), report,
                        out_features or c, consts,
                        fused_segments=fused_segments)


# ---------------------------------------------------------------------------
# Execute pass
# ---------------------------------------------------------------------------

def quantized_weights(steps: Tuple[PlanStep, ...], params: Dict[str, Dict],
                      consts: Dict[str, object]) -> Dict[str, Tuple]:
    """Each conv and dense layer's ``(wq, ws)``: the ``quantize_weight``
    call :func:`_execute_steps` makes per layer when it is not given them
    (the same function of the same weights, so the same tensors)."""
    return {s.name: quantize_weight(params[s.name]["w"], s.wa,
                                    consts["w_qmax"][s.name])
            for s in steps if isinstance(s, (ConvStep, DenseStep))}


def _execute_steps(steps: Tuple[PlanStep, ...], params: Dict[str, Dict],
                   frames: torch.Tensor, consts: Dict[str, object],
                   per_frame: bool = False,
                   segments: Tuple[dispatch.FusedSegmentSpec, ...] = (),
                   backend: str = "kernel",
                   weights: Optional[Dict[str, Tuple]] = None
                   ) -> torch.Tensor:
    """The device forward, batch-first, kernels via ``kernels.dispatch``.

    ``per_frame`` switches every CRC requant to per-frame calibration
    (scale [B, 1, ...] instead of one batch-wide scalar): each frame's
    result is then a pure function of that frame, the invariant the
    serving micro-batcher's padding and coalescing rest on.

    ``segments`` are the plan's fused runs: when a run's start comes up,
    its conv steps execute as one ``dispatch.conv_chain`` launch. The
    inter-stage CRC scale is a whole-frame max, so fusion applies only
    under per-frame calibration or at batch 1; per-tensor calibration at
    batch > 1 runs the unfused per-layer path (bitwise the same numbers).

    ``weights`` are the layers' quantized ``(wq, ws)`` from
    :func:`quantized_weights`, made once by a bound view, which has also
    run the chain kernel's range check (``fused.check_exact``) over every
    fused segment; ``None`` quantizes each layer's weights on every call.
    """
    def qweight(step):
        if weights is not None:
            return weights[step.name]
        return quantize_weight(params[step.name]["w"], step.wa,
                               consts["w_qmax"][step.name])

    a_qmax = consts["a_qmax"]
    x, act_scale = _crc_requant(frames, a_qmax, per_frame)
    fuse_ok = per_frame or frames.shape[0] == 1
    hooks = dispatch.trace_hooks()
    if segments and not fuse_ok and hooks:
        # per-tensor calibration at batch > 1 couples frames through the
        # batch-wide CRC max: the fused segments cannot run, and this
        # family runs the per-layer path
        obs.counter("dispatch.fused.fallback").inc(len(segments))
        if obs.enabled():
            obs.event("dispatch.fused.fallback",
                      attrs={"segments": len(segments),
                             "batch": int(frames.shape[0])})
    seg_at = {s.start: s for s in segments} if fuse_ok else {}
    i, n = 0, len(steps)
    while i < n:
        step = steps[i]
        seg = seg_at.get(i)
        if seg is not None:
            with (obs.span("plan.trace.fused_segment",
                           attrs={"names": list(seg.names)})
                  if hooks else _NO_SPAN):
                stages = []
                for s in steps[i:i + seg.length]:
                    wq, ws = qweight(s)
                    stages.append((s.geom, wq, ws, params[s.name].get("b")))
                x, act_scale = dispatch.conv_chain(
                    x, act_scale, stages, a_qmax, per_frame, backend,
                    exact_checked=weights is not None)
            i += seg.length
            continue
        if isinstance(step, CAStep):
            intens = x * act_scale
            g = dispatch.ca_acquire(intens, step.pool, step.rgb_to_gray,
                                    backend)
            if g.ndim == 3:
                g = g[..., None]
            x, act_scale = _crc_requant(g, a_qmax, per_frame)
        elif isinstance(step, ConvStep):
            p = params[step.name]
            wq, ws = qweight(step)
            acc = dispatch.conv_int(x, wq, step.stride, step.pads,
                                    groups=step.groups,
                                    strategy=step.strategy, backend=backend)
            out = acc * (act_scale * ws.reshape(1, 1, 1, -1))
            if p.get("b") is not None:
                out = out + p["b"]
            y = _activation(out, step.act)
            if step.pool is not None:
                y = _pool(y, *step.pool)
            x, act_scale = _crc_requant(y, a_qmax, per_frame)
        elif isinstance(step, UpsampleStep):
            intens = x * act_scale
            up = upsample_reconstruct(intens, step.factor, step.method)
            x, act_scale = _crc_requant(up, a_qmax, per_frame)
        elif isinstance(step, FlattenStep):
            intens = x * act_scale
            flat = intens.reshape(intens.shape[0], -1)
            x, act_scale = _crc_requant(flat, a_qmax, per_frame)
        elif isinstance(step, DenseStep):
            p = params[step.name]
            wq, ws = qweight(step)
            acc = dispatch.matmul_int(x, wq, backend)
            out = acc * (act_scale * ws.reshape(1, -1))
            if p.get("b") is not None:
                out = out + p["b"]
            if step.act != "none":
                y = _activation(out, step.act)
                x, act_scale = _crc_requant(y, a_qmax, per_frame)
            else:
                x, act_scale = out, None
        else:
            raise TypeError(f"unknown plan step {step!r}")
        i += 1
    # dequantize the final stage (a no-act dense head leaves the logits as
    # they are: the reference multiplies them by exactly 1.0)
    return x if act_scale is None else x * act_scale


def _execute(plan: CompiledPlan, params: Dict[str, Dict],
             frames: torch.Tensor, per_frame: bool = False,
             backend: str = "kernel",
             weights: Optional[Dict[str, Tuple]] = None) -> torch.Tensor:
    """Run ``frames`` [B, H, W, C] (or one [H, W, C]) through a plan.

    Returns logits [B, n] for classifier plans, or an image [B, H', W', C']
    for plans whose last step is spatial. The trace-time hooks fire only
    in the first run of the call's trace family (backend, device,
    calibration, batch shape); every later run of it is silenced.
    """
    if frames.ndim == 3:
        frames = frames[None]
    if frames.ndim != 4 or tuple(frames.shape[1:]) != plan.frame_shape:
        raise ValueError(f"frames {tuple(frames.shape)} do not match plan "
                         f"frame shape {plan.frame_shape}; expected "
                         f"[B, {', '.join(map(str, plan.frame_shape))}]")
    family = (backend, frames.device.type, per_frame, tuple(frames.shape))
    with torch.no_grad(), dispatch.repeat_family(
            not plan.first_run(family)):
        return _execute_steps(plan.steps, params, frames.float(),
                              plan.consts, per_frame=per_frame,
                              segments=plan.fused_segments, backend=backend,
                              weights=weights)
