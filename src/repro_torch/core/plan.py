"""Static compile pass + eager execute pass for the Lightator device.

  _compile_model(layers, input_shape, scheme, ...) -> CompiledPlan
      Shape inference over the layer IR, per-layer ``WASpec``s, every
      ``OCSchedule`` and the power/latency ``ModelReport``, the conv
      strategies and the fused segments — once per (IR, frame shape,
      scheme, hardware, strategy options), cached. Plans and reports equal
      the reference package's field for field.

  _execute_steps(steps, params, frames, consts, per_frame, segments, backend)
      The device forward, batch-first, every device op through
      ``kernels.dispatch``: the MACs on their kernels, and each requant
      with its dequant, bias, activation and pool on the epilogue kernel
      (``dispatch.epilogue``; after a dense int8 strip conv folded into
      its store, ``dispatch.conv_int_epilogue``), the counterpart of XLA's
      fusion of the reference's jitted executor. Every float step rounds once, in the
      reference's association (the kernel's explicit ``_rn`` intrinsics;
      the plain torch ops run eagerly, op by op, with every division a
      true IEEE division, ``quant.true_div``): the numerics are the
      reference's jitted executor's, bit for bit.

``compile_model`` / ``execute`` are the reference's deprecated front doors
over these two passes (``core.program`` is the public one); each warns
once per process.

Verification (``repro_torch.analysis``): ``_compile_model(verify=)`` runs
the plan verifier before a plan is cached (``plan.verify`` span,
``plan.verify.run`` / ``plan.verify.error`` counters), as the reference's
compile does. A plan it has proven clean (``CompiledPlan.exact_proven``)
runs its fused chains without the chain kernel's per-launch range check.

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
import functools
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import optical_core as ocore
from repro_torch.core import power_model as pmod
from repro_torch.core.accelerator import (CASpec, ConvSpec, DenseSpec,
                                          FlattenSpec, UpsampleSpec)
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
    # each strip conv's dense kernel, by step name: "int" (the int8
    # tensor-core kernel) or "float" (``dispatch.select_strip_route``;
    # depthwise strips have none). Kept off the steps, which equal the
    # reference's field for field.
    strip_routes: Dict[str, str] = dataclasses.field(default_factory=dict)
    # the dense convs on the int8 strip route whose operand the epilogue
    # before them writes (``dispatch.epilogue(operand=)``: uint8, their
    # border and zero channels), so they take it as it is -- where that
    # epilogue runs: after a fused segment that ran, the chain's float
    # codes come instead, and the conv casts and pads them; and the conv and
    # dense steps whose act the epilogue kernel does not take (tanh), whose
    # dequant, act, pool and requant stay torch ops. Both by step name,
    # kept off the steps as ``strip_routes`` is.
    int_operands: Tuple[str, ...] = ()
    torch_epilogues: Tuple[str, ...] = ()
    # the dense convs on the int8 strip route, outside any fused segment,
    # whose requant (an act the epilogue kernel takes, a max pool or none)
    # folds the epilogue's first pass into the conv's store
    # (``dispatch.conv_int_epilogue``); by step name, kept off the steps
    folded_epilogues: Tuple[str, ...] = ()
    # the trace families this plan has run (``_execute``)
    _families: set = dataclasses.field(default_factory=set, repr=False)
    # the executors handed out (``executor``), by per_frame
    _exec_fns: Dict[bool, object] = dataclasses.field(
        default_factory=dict, repr=False)
    # set once the analysis verifier has run over this plan (its warning
    # and error findings are then in ``report.verification``)
    _verified: bool = dataclasses.field(default=False, repr=False)

    @property
    def exact_proven(self) -> bool:
        """Has the verifier proven every accumulate below 2^24 (verified,
        with no ``LTR001``)? Then the fused chains need no range check."""
        return self._verified and not any(
            d["code"] == "LTR001" for d in self.report.verification)

    def executor(self, per_frame: bool = False):
        """The ``(params, frames) -> logits`` function of this plan: the
        execute pass on the kernels under ``per_frame`` calibration, one
        object per key (the reference's jitted executor). The reference's
        ``donate`` has no counterpart: eager PyTorch donates no buffer."""
        fn = self._exec_fns.get(per_frame)
        if fn is None:
            fn = functools.partial(_execute, self, per_frame=per_frame)
            self._exec_fns[per_frame] = fn
        return fn

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


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)


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
                   fuse: Optional[str] = None,
                   verify: str = "auto") -> CompiledPlan:
    """Resolve specs, shapes, OC schedules and the power report — once.

    ``input_shape`` is [B, H, W, C] or [H, W, C]; plans are cached on the
    per-frame dims. ``fc_batch`` schedules FC layers at the served batch
    size (the report stays per frame). ``fuse`` defaults to the mode the
    conv strategy implies (``dispatch.conv_fuse_mode``).

    ``verify`` is the plan verifier's mode (``Options(verify=)``): "auto"
    verifies every cache-miss compile and raises
    :class:`~repro_torch.analysis.PlanVerificationError` at error severity
    before the plan is cached, so a plan that fails is never published;
    "on" also re-verifies cache hits (a stored error re-raises); "off"
    skips. Warning and error findings land in ``report.verification``.
    The mode stays out of the cache key: verification never changes what
    is compiled.
    """
    from repro_torch.analysis.verifier import VERIFY_MODES
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}; expected one "
                         f"of {VERIFY_MODES}")
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
        if verify == "on":
            # a hit may predate verification (first compiled under "off")
            _verify_plan(cached, conv_vmem_budget)
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
    if verify != "off":
        # verify BEFORE caching: a plan that fails at error severity is
        # never published, so a later verify="off" compile starts clean
        _verify_plan(plan, conv_vmem_budget)
    _PLAN_CACHE[key] = plan
    return plan


def _verify_plan(plan: CompiledPlan, budget: int) -> None:
    """Run the analysis verifier over ``plan`` once (idempotent).

    Warning and error findings are stored in ``plan.report.verification``
    (the info-level headroom facts stay out); error severity raises
    :class:`~repro_torch.analysis.PlanVerificationError`. A plan already
    verified re-raises from its stored findings instead of re-walking.
    """
    from repro_torch import analysis
    if plan._verified:
        stored = plan.report.verification
        if any(d["severity"] == "error" for d in stored):
            raise analysis.PlanVerificationError(
                [analysis.Diagnostic(**d) for d in stored])
        return
    with obs.span("plan.verify", attrs={"layers": len(plan.layers)}):
        diags = analysis.verify_plan(plan, budget=budget,
                                     include_info=False)
    plan.report.verification = [d.asdict() for d in diags
                                if d.severity != "info"]
    plan._verified = True
    obs.counter("plan.verify.run").inc()
    if analysis.errors(diags):
        obs.counter("plan.verify.error").inc()
        raise analysis.PlanVerificationError(diags)


def _compile_model_uncached(layers, frame_shape, scheme, oc, circuit,
                            profile, weight_sram_kb, act_sram_kb, fc_batch,
                            conv_mode, conv_budget,
                            fuse_mode) -> CompiledPlan:
    compute_layers = [l for l in layers if isinstance(l, (ConvSpec, DenseSpec))]
    spec_iter = iter(resolve_layer_specs(len(compute_layers), scheme))

    steps: List[PlanStep] = []
    schedules: List[ocore.OCSchedule] = []
    spec_list: List[WASpec] = []
    strip_routes: Dict[str, str] = {}

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
            if strat.kind == "strip" and not layer.depthwise:
                strip_routes[layer.name] = dispatch.select_strip_route(
                    layer.c_in, layer.c_out, layer.kernel, layer.stride,
                    groups)
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
    fused = {name for f in fused_segments for name in f.names}
    int_operands = tuple(
        s.name for s in steps if isinstance(s, ConvStep) and s.groups == 1
        and strip_routes.get(s.name) == "int" and s.name not in fused)
    torch_epilogues = tuple(
        s.name for s in steps if isinstance(s, (ConvStep, DenseStep))
        and s.act not in dispatch.FUSABLE_ACTS)
    folded_epilogues = tuple(
        s.name for s in steps if isinstance(s, ConvStep) and s.groups == 1
        and strip_routes.get(s.name) == "int" and s.name not in fused
        and s.act in dispatch.FUSABLE_ACTS
        and (s.pool is None or s.pool[0] == "max"))

    consts = {
        "a_qmax": float((1 << ACT_BITS) - 1),
        "w_qmax": {s.name: float(s.wa.w_qmax) for s in steps
                   if isinstance(s, (ConvStep, DenseStep))},
    }
    return CompiledPlan(layers, frame_shape, scheme, tuple(steps),
                        tuple(schedules), tuple(spec_list), report,
                        out_features or c, consts,
                        fused_segments=fused_segments,
                        strip_routes=strip_routes, int_operands=int_operands,
                        torch_epilogues=torch_epilogues,
                        folded_epilogues=folded_epilogues)


# ---------------------------------------------------------------------------
# Execute pass
# ---------------------------------------------------------------------------

def quantized_weights(steps: Tuple[PlanStep, ...], params: Dict[str, Dict],
                      consts: Dict[str, object],
                      routes: Optional[Dict[str, str]] = None
                      ) -> Dict[str, Tuple]:
    """Each conv and dense layer's ``(wq, ws, levels)``: ``(wq, ws)`` the
    ``quantize_weight`` call :func:`_execute_steps` makes per layer when it
    is not given them (the same function of the same weights, so the same
    tensors); ``levels`` the integer levels laid out once for the kernel
    that runs the layer, where an unbound run lays them out per call: a
    dense conv's on the int8 strip route (``routes``, the plan's
    ``strip_routes``) for that kernel (``strip.int_weights``), a dense
    layer's and a resident conv's (one group) for ``photonic_mvm``
    (``photonic_mvm.ops.mvm_weights``), and None for every other layer."""
    from repro_torch.kernels.conv_bank.strip import int_weights
    from repro_torch.kernels.photonic_mvm.ops import mvm_weights
    routes = routes or {}
    out = {}
    for s in steps:
        if isinstance(s, (ConvStep, DenseStep)):
            wq, ws = quantize_weight(params[s.name]["w"], s.wa,
                                     consts["w_qmax"][s.name])
            levels = None
            if isinstance(s, DenseStep):
                levels = mvm_weights(wq)
            elif s.groups == 1 and routes.get(s.name) == "int":
                levels = int_weights(wq, stride=s.stride)
            elif s.groups == 1 and s.strategy is not None and \
                    s.strategy.kind == "resident":
                levels = mvm_weights(wq.reshape(-1, wq.shape[-1]))
            out[s.name] = (wq, ws, levels)
    return out


def _execute_steps(steps: Tuple[PlanStep, ...], params: Dict[str, Dict],
                   frames: torch.Tensor, consts: Dict[str, object],
                   per_frame: bool = False,
                   segments: Tuple[dispatch.FusedSegmentSpec, ...] = (),
                   backend: str = "kernel",
                   weights: Optional[Dict[str, Tuple]] = None,
                   exact_checked: bool = False,
                   reduce_max=None,
                   routes: Optional[Dict[str, str]] = None,
                   int_operands: Sequence[str] = (),
                   torch_epilogues: Sequence[str] = (),
                   folded_epilogues: Sequence[str] = ()) -> torch.Tensor:
    """The device forward, batch-first, kernels via ``kernels.dispatch``.

    ``per_frame`` switches every CRC requant to per-frame calibration
    (scale [B, 1, ...] instead of one batch-wide scalar): each frame's
    result is then a pure function of that frame, the invariant the
    serving micro-batcher's padding and coalescing rest on.

    Every requant -- the frames', the CA's, each unfused conv's (with its
    dequant, bias, act and pool), the upsample's, the flatten's and each
    dense layer's with an activation -- is one ``dispatch.epilogue`` call:
    the epilogue kernel pair on the kernel backend. Where the next step is
    in ``int_operands`` (the plan's), the epilogue writes that conv's
    int8 operand and the conv takes it as it is (a conv there that comes
    straight after a fused segment that ran gets the chain's float codes,
    and casts and pads them itself); the steps in
    ``torch_epilogues`` run theirs as the plain torch ops. A conv in
    ``folded_epilogues`` and its requant are one
    ``dispatch.conv_int_epilogue`` call on the kernel backend: the
    epilogue's first pass folded into the conv's store.

    ``segments`` are the plan's fused runs: when a run's start comes up,
    its conv steps execute as one ``dispatch.conv_chain`` launch. The
    inter-stage CRC scale is a whole-frame max, so fusion applies only
    under per-frame calibration or at batch 1; per-tensor calibration at
    batch > 1 runs the unfused per-layer path (bitwise the same numbers).

    ``routes`` are the plan's ``strip_routes`` (``None``: each strip conv
    resolves its own with the default rule).

    ``weights`` are the layers' ``(wq, ws, levels)`` from
    :func:`quantized_weights` (quantized, and the levels laid out for the
    int8 strip conv's and photonic_mvm's kernels), made once by a bound
    view; ``None`` quantizes each layer's weights, and lays the levels
    out, on every call.
    ``exact_checked``: the fused chains' float32 range is already known to
    hold (the verifier proved the plan, or a bound view ran
    ``fused.check_exact`` over its weights), so no chain launch checks it
    again. ``reduce_max``: ``frames`` are one shard of a batch
    (``Options.shard_batch``), and each per-tensor requant's max is taken
    across the shards through it; the fused chains then do not run (their
    inter-stage max is the shard's own).
    """
    def qweight(step):
        if weights is not None:
            return weights[step.name]
        return (*quantize_weight(params[step.name]["w"], step.wa,
                                 consts["w_qmax"][step.name]), None)

    routes = routes or {}
    a_qmax = consts["a_qmax"]
    n = len(steps)
    handed = frozenset(int_operands) if backend == "kernel" else frozenset()
    folded = (frozenset(folded_epilogues) if backend == "kernel"
              else frozenset())

    # x is the int8 operand the last epilogue wrote for the step at hand
    x_operand = False

    def next_operand(nxt):
        """The operand form step ``nxt`` takes its codes in, or None."""
        s = steps[nxt] if nxt < n else None
        return ((s.kernel, s.pads) if s is not None
                and getattr(s, "name", None) in handed else None)

    def epilogue(t, nxt, act_scale=None, ws=None, bias=None, act="none",
                 pool=None, name=None):
        """The requant whose codes step ``nxt`` takes."""
        nonlocal x_operand
        operand = next_operand(nxt)
        x_operand = operand is not None
        return dispatch.epilogue(
            t, act_scale, ws, bias, act, pool, a_qmax=a_qmax,
            per_frame=per_frame, reduce_max=reduce_max, operand=operand,
            backend="reference" if name in torch_epilogues else backend)

    x, act_scale = epilogue(frames, 0)
    fuse_ok = per_frame or (frames.shape[0] == 1 and reduce_max is None)
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
    i = 0
    while i < n:
        step = steps[i]
        seg = seg_at.get(i)
        if seg is not None:
            with (obs.span("plan.trace.fused_segment",
                           attrs={"names": list(seg.names)})
                  if hooks else _NO_SPAN):
                stages = []
                for s in steps[i:i + seg.length]:
                    wq, ws, _ = qweight(s)
                    stages.append((s.geom, wq, ws, params[s.name].get("b")))
                x, act_scale = dispatch.conv_chain(
                    x, act_scale, stages, a_qmax, per_frame, backend,
                    exact_checked=exact_checked)
            x_operand = False
            i += seg.length
            continue
        if isinstance(step, CAStep):
            intens = x * act_scale
            g = dispatch.ca_acquire(intens, step.pool, step.rgb_to_gray,
                                    backend)
            if g.ndim == 3:
                g = g[..., None]
            x, act_scale = epilogue(g, i + 1)
        elif isinstance(step, ConvStep) and step.name in folded:
            wq, ws, levels = qweight(step)
            operand = next_operand(i + 1)
            x, act_scale = dispatch.conv_int_epilogue(
                x, act_scale, wq, ws, params[step.name].get("b"),
                step.stride, step.pads, step.act, step.pool, a_qmax=a_qmax,
                per_frame=per_frame, reduce_max=reduce_max, operand=operand,
                x_operand=x_operand, levels=levels, backend=backend)
            x_operand = operand is not None
        elif isinstance(step, ConvStep):
            p = params[step.name]
            wq, ws, levels = qweight(step)
            acc = dispatch.conv_int(x, wq, step.stride, step.pads,
                                    groups=step.groups,
                                    strategy=step.strategy, backend=backend,
                                    route=routes.get(step.name),
                                    operand=x_operand,
                                    levels=levels)
            x, act_scale = epilogue(acc, i + 1, act_scale, ws, p.get("b"),
                                    step.act, step.pool, step.name)
        elif isinstance(step, UpsampleStep):
            intens = x * act_scale
            up = upsample_reconstruct(intens, step.factor, step.method)
            x, act_scale = epilogue(up, i + 1)
        elif isinstance(step, FlattenStep):
            b = x.shape[0]
            x, act_scale = epilogue(
                x.reshape(b, -1), i + 1, act_scale if act_scale.ndim == 0
                else act_scale.reshape(b, 1))
        elif isinstance(step, DenseStep):
            p = params[step.name]
            wq, ws, levels = qweight(step)
            acc = dispatch.matmul_int(x, wq, backend, levels=levels)
            if step.act != "none":
                x, act_scale = epilogue(acc, i + 1, act_scale, ws,
                                        p.get("b"), step.act, None,
                                        step.name)
            else:
                out = acc * (act_scale * ws.reshape(1, -1))
                if p.get("b") is not None:
                    out = out + p["b"]
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
             weights: Optional[Dict[str, Tuple]] = None,
             reduce_max=None) -> torch.Tensor:
    """Run ``frames`` [B, H, W, C] (or one [H, W, C]) through a plan.

    Returns logits [B, n] for classifier plans, or an image [B, H', W', C']
    for plans whose last step is spatial. The trace-time hooks fire only
    in the first run of the call's trace family (backend, device,
    calibration, batch shape); every later run of it is silenced.
    ``weights`` come from a bound view, which has checked the chains'
    range over them unless the plan is :attr:`CompiledPlan.exact_proven`.
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
                              weights=weights,
                              exact_checked=(weights is not None
                                             or plan.exact_proven),
                              reduce_max=reduce_max,
                              routes=plan.strip_routes,
                              int_operands=plan.int_operands,
                              torch_epilogues=plan.torch_epilogues,
                              folded_epilogues=plan.folded_epilogues)


# ---------------------------------------------------------------------------
# Back-compat shims
#
# ``core.program`` (Program / Options / Executable) is the public front door;
# these keep the reference's first function API working, bitwise (they call
# the very internals the new API calls), with a one-shot DeprecationWarning.
# ---------------------------------------------------------------------------

_DEPRECATION_WARNED: set = set()


def _warn_deprecated(old: str, replacement: str,
                     doc: str = "docs/api.md") -> None:
    """One-shot-per-process DeprecationWarning (the shared shim helper --
    ``launch.serve`` reuses it with its own ``doc``)."""
    if old in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(old)
    warnings.warn(f"{old} is deprecated; use {replacement} "
                  f"(see {doc})", DeprecationWarning, stacklevel=3)


def compile_model(layers: Sequence, input_shape: Tuple[int, ...],
                  scheme: WASpec | MixedPrecisionScheme,
                  oc: ocore.OCConfig = ocore.DEFAULT_OC,
                  circuit: pmod.CircuitConstants = pmod.DEFAULT_CIRCUIT,
                  profile: pmod.AcceleratorProfile = pmod.LIGHTATOR_PROFILE,
                  weight_sram_kb: float = 512.0,
                  act_sram_kb: float = 256.0,
                  fc_batch: int = 1) -> CompiledPlan:
    """Deprecated shim over the compile pass -- use ``repro_torch.Program``.

    ``Program(layers, params, input_hwc).compile(Options(scheme=...))``
    resolves the same cached plan; this wrapper keeps the reference's full
    signature (positional calls included).
    """
    _warn_deprecated(
        "core.plan.compile_model",
        "repro_torch.Program(...).compile(repro_torch.Options(scheme=...))")
    return _compile_model(layers, input_shape, scheme, oc=oc,
                          circuit=circuit, profile=profile,
                          weight_sram_kb=weight_sram_kb,
                          act_sram_kb=act_sram_kb, fc_batch=fc_batch)


def execute(plan: CompiledPlan, params: Dict[str, Dict],
            frames: torch.Tensor) -> torch.Tensor:
    """Deprecated shim over the execute pass -- use ``Executable.run``.
    ``params`` and ``frames`` are tensors on one device."""
    _warn_deprecated("core.plan.execute",
                     "repro_torch.Program(...).compile(...).run(frames)")
    return plan.executor()(params, frames)
