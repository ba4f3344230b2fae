"""LightatorDevice — the paper's "custom in-house simulator" (Sec. 5),
and the layer IR the paper's models are written in.

The device models a vision model the way the hardware runs it:

  step 1  frame captured; CRC quantizes pixels to uint4 (ADC-less imager)
  step 2  optional Compressive Acquisitor (fused RGB->gray + pooling)
  step 3  All-in-One Convolver runs the layer's MACs on the OC banks
  step 4  electronic activation (Sign/ReLU/tanh) + CRC requantization feeds
          the DMVA for the next layer (activation banks eliminated)
  step 5  repeat 3<->4 until the classifier output

``LightatorDevice.run`` is the two passes of ``core.plan``: a cached
compile and the execute pass, whose MACs go through the kernels
(``kernels.dispatch``). ``run_eager`` is the seed's per-layer interpreter,
the executable specification the compiled path matches bit for bit: its
conv and dense accumulates are exact float64 sums independent of every
kernel (it launches none of them, on the CPU or on the card).

The IR dataclasses are field-for-field copies of the reference package's,
so a plan compiled from them resolves the same steps, schedules and power
report.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import optical_core as ocore
from repro_torch.core import power_model as pmod
from repro_torch.core.quant import (ACT_BITS, MixedPrecisionScheme, WASpec,
                                    quantize_weight, resolve_layer_specs,
                                    true_div)


@dataclasses.dataclass(frozen=True)
class CASpec:
    pool: int = 2
    rgb_to_gray: bool = True


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    c_in: int
    c_out: int
    kernel: int = 3
    stride: int = 1
    padding: str = "SAME"
    act: str = "relu"               # relu | sign | tanh | abs | none
    pool: Optional[Tuple[str, int]] = None   # ("avg"|"max", size)
    depthwise: bool = False         # c_out == c_in, weights [k, k, 1, c]


@dataclasses.dataclass(frozen=True)
class UpsampleSpec:
    """Reconstruction upsample (the CA's inverse for compress->recon)."""

    factor: int = 2
    method: str = "bilinear"        # bilinear | nearest


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    name: str
    fan_in: int
    fan_out: int
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class FlattenSpec:
    pass


LayerIR = CASpec | ConvSpec | DenseSpec | FlattenSpec | UpsampleSpec


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.relu(x)
    if kind == "sign":
        return torch.sign(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "abs":
        # magnitude readout: the BPD's two rails measured without sign
        return torch.abs(x)
    if kind == "none":
        return x
    raise ValueError(f"unknown activation {kind}")


def window_mean(xr: torch.Tensor) -> torch.Tensor:
    """Mean over the window axes of ``xr`` [..., H', p, W', p, C].

    The window is summed row-major from zero, ``(((0 + a00) + a01) + a10)
    + a11`` for p = 2, then divided by p*p: the order XLA's reduce takes on
    the reference's ``mean(axis=(2, 4))``, bitwise. ``torch.mean`` sums
    pairwise and differs from it by 1 ulp on about 5% of the elements.
    """
    p = xr.shape[-2]
    acc = torch.zeros_like(xr[..., 0, :, 0, :])
    for di in range(p):
        for dj in range(p):
            acc = acc + xr[..., di, :, dj, :]
    return true_div(acc, float(p * p))


def _pool(y: torch.Tensor, kind: str, size: int) -> torch.Tensor:
    """``kind`` ("max" | "avg") pooling of ``y`` [B, H, W, C] by ``size``."""
    b, h, w, c = y.shape
    yr = y.reshape(b, h // size, size, w // size, size, c)
    if kind == "max":
        return yr.amax(dim=(2, 4))
    return window_mean(yr)


def _crc_requant(x: torch.Tensor, a_qmax=None, per_frame: bool = False,
                 reduce_max=None):
    """Electronic output -> CRC codes for the next layer's DMVA.

    Returns ``(codes, scale)``; codes are float-carried 0..15. Per-tensor
    calibration (the seed semantics) reduces one max over the whole tensor,
    batch axis included, giving a 0-d scale; ``per_frame`` reduces each
    frame's own axes instead (scale shape [B, 1, ...]), so a frame's codes
    never depend on its batch neighbours. ``a_qmax`` is the divisor,
    ideally a tensor on ``x``'s device (default: the 4-bit CRC's 15).
    ``reduce_max`` (per-tensor only): where ``x`` is one shard of a
    batch, the 0-d max of every shard's 0-d max (``Options.shard_batch``),
    so the scale is the whole batch's.
    """
    if a_qmax is None:
        a_qmax = float((1 << ACT_BITS) - 1)
    x = torch.clamp_min(x, 0.0)
    if per_frame:
        amax = x.amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    else:
        amax = x.amax()
        if reduce_max is not None:
            amax = reduce_max(amax)
    scale = true_div(torch.clamp_min(amax, 1e-8), a_qmax)
    codes = torch.clamp(torch.round(true_div(x, scale)), 0,
                        (1 << ACT_BITS) - 1)
    return codes, scale


class LightatorDevice:
    """Execute a layer-IR model with photonic quantized semantics + report.

    ``oc``, ``circuit`` and ``profile`` are the reference's. The rest are
    :class:`~repro_torch.core.program.Options`' fields, with its defaults,
    where the reference reads process-wide switches (the kernel backend,
    ``REPRO_CONV_STRATEGY``, ``REPRO_CONV_VMEM_BUDGET``): ``device``
    (``cuda`` unless the caller asks for the CPU; raises with no GPU),
    ``backend`` (``run``'s), ``conv_strategy`` and ``conv_vmem_budget``
    (``compile``'s; ``run_eager`` reports the conv strategies and fused
    segments they resolve).
    """

    def __init__(self, oc: ocore.OCConfig = ocore.DEFAULT_OC,
                 circuit: pmod.CircuitConstants = pmod.DEFAULT_CIRCUIT,
                 profile: pmod.AcceleratorProfile = pmod.LIGHTATOR_PROFILE,
                 *, device: str = "cuda", backend: str = "kernel",
                 conv_strategy: Optional[str] = None,
                 conv_vmem_budget: Optional[int] = None):
        from repro_torch.core.program import Options
        self.options = Options(
            oc=oc, circuit=circuit, profile=profile, device=device,
            backend=backend, conv_strategy=conv_strategy,
            conv_vmem_budget=conv_vmem_budget).resolve()
        self.oc = oc
        self.power = pmod.PowerModel(oc, circuit, profile)
        self.device = torch.device(self.options.device)

    def _tensor(self, x) -> torch.Tensor:
        """``x`` (a tensor or an array) as float32 on the device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def _params(self, params: Dict[str, Dict]) -> Dict[str, Dict]:
        return {layer: {k: self._tensor(v) for k, v in p.items()
                        if v is not None}
                for layer, p in params.items()}

    # -- numerics ---------------------------------------------------------
    def _conv(self, codes: torch.Tensor, act_scale: torch.Tensor,
              w: torch.Tensor, b: Optional[torch.Tensor], spec: ConvSpec,
              wa: WASpec) -> torch.Tensor:
        """Integer-exact quantized conv. codes: [B,H,W,Cin] uint codes."""
        from repro_torch.core.plan import padtype_to_pads
        from repro_torch.kernels.conv_bank.ref import conv_int_ref
        wq, ws = quantize_weight(w, wa)            # w: [k,k,cin,cout]
        pads = padtype_to_pads((codes.shape[1], codes.shape[2]),
                               spec.kernel, spec.stride, spec.padding)
        acc = conv_int_ref(codes, wq, spec.stride, pads)
        out = acc * (act_scale * ws.reshape(1, 1, 1, -1))
        if b is not None:
            out = out + b
        return out

    def _dense(self, codes: torch.Tensor, act_scale: torch.Tensor,
               w: torch.Tensor, b: Optional[torch.Tensor],
               wa: WASpec) -> torch.Tensor:
        wq, ws = quantize_weight(w, wa)
        # every partial sum of small integers is exact in float64, so the
        # product rounds once, to the exact accumulate
        acc = torch.matmul(codes.double(), wq.double()).float()
        out = acc * (act_scale * ws.reshape(1, -1))
        if b is not None:
            out = out + b
        return out

    # -- the device -------------------------------------------------------
    def compile(self, layers: Sequence[LayerIR],
                input_shape: Tuple[int, ...],
                scheme: WASpec | MixedPrecisionScheme):
        """Static pass: layers + input shape -> cached ``CompiledPlan``."""
        from repro_torch.core import plan as plan_mod
        o = self.options
        return plan_mod._compile_model(
            tuple(layers), tuple(input_shape), scheme, oc=self.oc,
            circuit=self.power.c, profile=self.power.profile,
            weight_sram_kb=self.power.weight_sram_kb,
            act_sram_kb=self.power.act_sram_kb,
            conv_strategy=o.conv_strategy,
            conv_vmem_budget=o.conv_vmem_budget, fuse=o.fuse,
            verify=o.verify)

    def run(self, layers: Sequence[LayerIR], params: Dict[str, Dict],
            image, scheme: WASpec | MixedPrecisionScheme
            ) -> Tuple[torch.Tensor, pmod.ModelReport]:
        """image: [B,H,W,C] float in [0,1]. Returns (logits, report).

        Deprecated compatibility wrapper (cached compile + the batched
        execute pass with per-tensor calibration, bitwise ``run_eager``'s)
        -- the front door is ``repro_torch.Program(layers, params, hwc)
        .compile(Options(...))``, which also exposes the report.
        """
        from repro_torch.core import plan as plan_mod
        plan_mod._warn_deprecated(
            "LightatorDevice.run",
            "repro_torch.Program(layers, params, input_hwc)"
            ".compile(repro_torch.Options(scheme=...)).run(image)")
        frames = self._tensor(image)
        plan = self.compile(layers, frames.shape, scheme)
        logits = plan_mod._execute(plan, self._params(params), frames,
                                   backend=self.options.backend)
        # deep copy: the plan (and its report) is shared through the plan
        # cache; callers mutating their report must not corrupt later runs
        return logits, copy.deepcopy(plan.report)

    def run_eager(self, layers: Sequence[LayerIR], params: Dict[str, Dict],
                  image, scheme: WASpec | MixedPrecisionScheme
                  ) -> Tuple[torch.Tensor, pmod.ModelReport]:
        """The seed per-layer eager interpreter (reference semantics).

        Re-schedules and re-runs the power model on every call; kept as the
        specification the compiled path is held to, and as the eager
        baseline of the pipeline timing. Per-tensor calibration.

        Covers the seed IR only: the imaging extensions (depthwise convs,
        ``UpsampleSpec``) execute on the compiled path alone and are
        rejected here.
        """
        from repro_torch.core.compressive import compressive_acquire
        from repro_torch.core.plan import padtype_to_pads
        from repro_torch.kernels import dispatch
        o = self.options
        compute_layers = [l for l in layers
                          if isinstance(l, (ConvSpec, DenseSpec))]
        spec_iter = iter(resolve_layer_specs(len(compute_layers), scheme))
        params = self._params(params)
        image = self._tensor(image)

        schedules: List[ocore.OCSchedule] = []
        spec_list: List[WASpec] = []
        conv_strategy: Dict[str, Dict] = {}
        # chain geoms aligned with the plan's step indices (each seed-IR
        # layer compiles to exactly one step), so the fused-segment report
        # resolves as the compile pass resolves it
        geoms: List[Optional[dispatch.ChainGeom]] = []

        with torch.no_grad():
            # step 1: ADC-less imager -- CRC on raw pixels
            x, act_scale = _crc_requant(image)
            for layer in layers:
                if isinstance(layer, CASpec):
                    # step 2: compressive acquisition on *dequantized*
                    # intensities
                    g = compressive_acquire(x * act_scale, layer.pool,
                                            layer.rgb_to_gray)
                    if g.ndim == 3:
                        g = g[..., None]
                    schedules.append(ocore.schedule_ca(
                        "CA", g.shape[1], g.shape[2], layer.pool,
                        channels=image.shape[-1], oc=self.oc))
                    spec_list.append(WASpec(4, 4))
                    geoms.append(None)
                    x, act_scale = _crc_requant(g)
                elif isinstance(layer, ConvSpec):
                    if layer.depthwise:
                        raise NotImplementedError(
                            f"{layer.name}: depthwise convs run on the "
                            f"compiled path only (core.plan.execute); the "
                            f"eager interpreter covers the seed IR")
                    wa = next(spec_iter)
                    p = params[layer.name]
                    pads = padtype_to_pads((x.shape[1], x.shape[2]),
                                           layer.kernel, layer.stride,
                                           layer.padding)
                    geoms.append(dispatch.ChainGeom(
                        layer.name, x.shape[1], x.shape[2], layer.c_in,
                        layer.c_out, layer.kernel, layer.stride, pads,
                        act=layer.act, pool=layer.pool))
                    y = self._conv(x, act_scale, p["w"], p.get("b"), layer,
                                   wa)
                    # the strategy the kernel path resolves for this
                    # layer's (pre-pool) output dims, as the compile pass
                    conv_strategy[layer.name] = dataclasses.asdict(
                        dispatch.select_conv_strategy(
                            y.shape[1], y.shape[2], layer.c_in, layer.c_out,
                            layer.kernel, layer.stride,
                            mode=o.conv_strategy,
                            budget=o.conv_vmem_budget))
                    y = _activation(y, layer.act)
                    if layer.pool is not None:
                        kind, size = layer.pool
                        y = _pool(y, kind, size)
                        if kind == "avg":
                            # avg pooling runs on CA banks with pre-set
                            # weights
                            schedules.append(ocore.schedule_ca(
                                f"{layer.name}.pool", y.shape[1], y.shape[2],
                                size, channels=1, oc=self.oc))
                            spec_list.append(WASpec(4, 4))
                    schedules.append(ocore.schedule_conv(
                        layer.name, y.shape[1], y.shape[2], layer.c_in,
                        layer.c_out, layer.kernel, oc=self.oc))
                    spec_list.append(wa)
                    x, act_scale = _crc_requant(y)     # step 4: DMVA reuse
                elif isinstance(layer, FlattenSpec):
                    intens = x * act_scale
                    geoms.append(None)
                    x, act_scale = _crc_requant(
                        intens.reshape(intens.shape[0], -1))
                elif isinstance(layer, DenseSpec):
                    geoms.append(None)
                    wa = next(spec_iter)
                    p = params[layer.name]
                    y = self._dense(x, act_scale, p["w"], p.get("b"), wa)
                    schedules.append(ocore.schedule_fc(
                        layer.name, layer.fan_in, layer.fan_out, batch=1,
                        oc=self.oc))
                    spec_list.append(wa)
                    if layer.act != "none":
                        x, act_scale = _crc_requant(
                            _activation(y, layer.act))
                    else:
                        # classifier head: logits leave the device as
                        # they are (the reference multiplies them by 1.0)
                        x, act_scale = y, None
                else:
                    raise TypeError(f"unknown layer IR {layer!r}")
            logits = x if act_scale is None else x * act_scale

        # architecture report with the per-layer specs actually used
        lps = [self.power.layer_power(pmod.LayerSchedule(s, sp))
               for s, sp in zip(schedules, spec_list)]
        report = self.power.finalize_report(lps, schedules, scheme)
        report.conv_strategy = conv_strategy
        report.fused_segments = [
            dataclasses.asdict(f) for f in dispatch.select_fused_segments(
                geoms, mode=o.fuse, budget=o.conv_vmem_budget)]
        return logits, report
