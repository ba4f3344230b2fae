"""Device-to-architecture power / latency / FPS-per-W simulator (paper Fig. 7).

The paper evaluates Lightator bottom-up: device (MR spectra) -> circuit
(CRC/VCSEL/driver/DAC power in 45nm) -> architecture (bank scheduling ->
execution time + power) -> application (accuracy). This module is the
architecture level: it consumes ``OCSchedule``s from ``core.optical_core``
and per-component circuit constants, and emits the quantities of Fig. 8
(layer-wise power breakdown), Fig. 9 (component pie), Fig. 10 (execution
time) and Table 1 (max power, kFPS/W).

Component model (who burns power in Lightator):
  DAC   - weight-tuning DACs. One per concurrently-mapped MR; power scales
          ~2^w_bits (current-steering DAC with per-bit power gating — the
          paper's stated source of the 2.4x saving when dropping bits and of
          the >85% DAC share in Fig. 9).
  TUN   - microheater holding power per active MR (mean detuning).
  DMVA  - CRC comparators + VCSEL + driver transistors (activation path).
          This replaces the ADC+DAC activation path of prior designs.
  BPD   - balanced photodetectors + TIA per arm.
  ADC   - 0 for Lightator (ADC-less); >0 for baseline profiles that read
          analog MAC results back to digital per output.
  MISC  - controller + weight/activation SRAM (Cacti-class constants).

Calibration: constants below are set so that VGG9/CIFAR on the 96-bank OC
lands at Table 1's operating points (5.28 / 2.71 / 1.46 W and O(100) kFPS/W).
They are *circuit-level inputs*, not fit per-experiment; every reported
number downstream is computed from schedules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

from repro_torch.core.optical_core import OCConfig, DEFAULT_OC, OCSchedule
from repro_torch.core.quant import WASpec, MixedPrecisionScheme, resolve_layer_specs


@dataclasses.dataclass(frozen=True)
class CircuitConstants:
    """45nm-class per-component constants (device/circuit layer outputs)."""

    # Weight path ------------------------------------------------------
    dac_unit_w: float = 70e-6        # per-MR DAC power at 1 effective bit-slice
    tun_per_mr_w: float = 4.2e-6     # mean microheater holding power per MR
    # Activation path (DMVA) -------------------------------------------
    crc_comparator_w: float = 0.8e-6   # per comparator (15 per CRC unit)
    vcsel_w: float = 1.9e-6            # per VCSEL (incl. bias)
    driver_w: float = 1.1e-6           # per driver stack (16 transistors)
    # Readout ----------------------------------------------------------
    bpd_w: float = 2.6e-6              # per BPD + TIA
    adc_w: float = 3.1e-3              # per ADC channel (baselines only)
    # Electronic misc ----------------------------------------------------
    summation_w: float = 0.9e-6        # per summation-tree adder
    sram_w_per_kb: float = 1.6e-6      # weight/act SRAM leakage+dynamic proxy
    controller_w: float = 8.0e-2       # sequencer/controller
    # Timing -------------------------------------------------------------
    cycle_hz: float = 20e9             # optical cycle rate (photodetection >100GHz)
    remap_cycles: int = 128            # DAC settle + SRAM fetch per weight remap


DEFAULT_CIRCUIT = CircuitConstants()


def dac_power_per_mr(w_bits: int, c: CircuitConstants = DEFAULT_CIRCUIT) -> float:
    """Current-steering DAC with power-gated bit slices: ~ 2^bits."""
    return c.dac_unit_w * (2 ** w_bits)


@dataclasses.dataclass(frozen=True)
class AcceleratorProfile:
    """What a design spends energy on. Lightator vs prior MR accelerators."""

    name: str
    act_in_mrs: bool = False     # activations tuned into MRs (needs DAC each)
    adc_readout: bool = False    # analog MAC results digitized by ADCs
    dac_weights: bool = True     # weights tuned via DACs
    process_nm: int = 45


LIGHTATOR_PROFILE = AcceleratorProfile("Lightator", act_in_mrs=False,
                                       adc_readout=False, dac_weights=True)
# Prior designs (Sec. 2): activation values also occupy MRs (tuning + DAC) and
# outputs go through ADCs.
CROSSLIGHT_PROFILE = AcceleratorProfile("CrossLight", act_in_mrs=True,
                                        adc_readout=True, process_nm=45)
LIGHTBULB_PROFILE = AcceleratorProfile("LightBulb", act_in_mrs=True,
                                       adc_readout=True, process_nm=32)
HOLYLIGHT_PROFILE = AcceleratorProfile("HolyLight", act_in_mrs=True,
                                       adc_readout=False, process_nm=32)
ROBIN_PROFILE = AcceleratorProfile("Robin", act_in_mrs=True,
                                   adc_readout=True, process_nm=45)


@dataclasses.dataclass
class LayerSchedule:
    """An OCSchedule + the [W:A] spec it runs under."""

    schedule: OCSchedule
    spec: WASpec


@dataclasses.dataclass
class LayerPower:
    name: str
    breakdown_w: Dict[str, float]
    cycles: int
    remap_cycles: int

    @property
    def total_w(self) -> float:
        return sum(self.breakdown_w.values())

    @property
    def time_s(self) -> float:
        return (self.cycles + self.remap_cycles) / DEFAULT_CIRCUIT.cycle_hz


@dataclasses.dataclass
class ModelReport:
    layers: List[LayerPower]
    max_power_w: float
    avg_power_w: float
    exec_time_s: float
    fps: float
    kfps_per_w: float
    # conv execution strategy per conv layer (resident vs strip-mined +
    # strip geometry), recorded by the compile pass (core.plan) and by the
    # eager interpreter so reports stay comparable field-for-field; empty
    # for schedule-only reports (PowerModel.model_report)
    conv_strategy: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    # fused megakernel segments (runs of conv steps executing as one
    # launch, kernels.dispatch.select_fused_segments) — recorded by both
    # the compile pass and the eager interpreter; empty when fusion is off
    # or for schedule-only reports
    fused_segments: List[Dict] = dataclasses.field(default_factory=list)
    # plan-verifier findings (warning/error dicts). The port has no plan
    # verifier yet, so its reports always carry [] here; the field stays so
    # a report keeps the reference's shape field for field
    verification: List[Dict] = dataclasses.field(default_factory=list)

    def component_totals(self) -> Dict[str, float]:
        """Time-weighted component powers across the model (Fig. 9 pie)."""
        acc: Dict[str, float] = {}
        t_total = sum(l.time_s for l in self.layers) or 1.0
        for l in self.layers:
            for k, v in l.breakdown_w.items():
                acc[k] = acc.get(k, 0.0) + v * l.time_s / t_total
        return acc


class PowerModel:
    """Architecture-level simulator: schedules -> power/latency/FPS/W."""

    def __init__(self, oc: OCConfig = DEFAULT_OC,
                 circuit: CircuitConstants = DEFAULT_CIRCUIT,
                 profile: AcceleratorProfile = LIGHTATOR_PROFILE,
                 weight_sram_kb: float = 512.0,
                 act_sram_kb: float = 256.0):
        self.oc = oc
        self.c = circuit
        self.profile = profile
        self.weight_sram_kb = weight_sram_kb
        self.act_sram_kb = act_sram_kb

    # -- per-layer -----------------------------------------------------
    def layer_power(self, ls: LayerSchedule) -> LayerPower:
        s, spec = ls.schedule, ls.spec
        c, oc, prof = self.c, self.oc, self.profile
        # MRs concurrently holding weights while this layer runs:
        mapped_mrs = min(s.mapped_mrs_avg, float(oc.total_mrs))
        arms_active = mapped_mrs / oc.mrs_per_arm
        # weight DACs: per concurrently-mapped MR (weights stay mapped, DACs
        # hold the tuning voltage). Pre-set CA banks need no DAC (kind=="ca").
        dac_w = 0.0
        if prof.dac_weights and s.kind != "ca":
            dac_w = mapped_mrs * dac_power_per_mr(spec.w_bits, c)
        if prof.act_in_mrs:
            # prior designs burn DAC + tuning for activations too, at a_bits
            dac_w += mapped_mrs * dac_power_per_mr(spec.a_bits, c)
        tun_w = mapped_mrs * c.tun_per_mr_w * (2 if prof.act_in_mrs else 1)
        # DMVA: one CRC+VCSEL+driver per wavelength channel in flight (the
        # activations of one input window, broadcast to all banks).
        dmva_w = 0.0
        if not prof.act_in_mrs:
            dmva_w = s.vcsel_channels * (c.crc_comparator_w * 15 / 16.0
                                         + c.vcsel_w + c.driver_w)
        bpd_w = arms_active * c.bpd_w
        adc_w = 0.0
        if prof.adc_readout:
            outputs_per_cycle = s.bpd_reads / max(s.cycles, 1)
            adc_w = outputs_per_cycle * c.adc_w
        sum_w = (s.summation_ops / max(s.cycles, 1)) * c.summation_w
        misc_w = (c.controller_w
                  + (self.weight_sram_kb + self.act_sram_kb) * c.sram_w_per_kb)
        breakdown = {"DAC": dac_w, "TUN": tun_w, "DMVA": dmva_w,
                     "BPD": bpd_w, "ADC": adc_w,
                     "MISC": misc_w + sum_w}
        return LayerPower(s.name, breakdown, s.cycles,
                          s.weight_remaps * c.remap_cycles)

    # -- whole model -----------------------------------------------------
    def model_report(self, layers: Sequence[OCSchedule],
                     scheme: WASpec | MixedPrecisionScheme) -> ModelReport:
        """Whole-model report.

        Lightator-MX co-mapping model: the first layer's weight banks stay
        resident at [4:*] for the whole frame (the first layer runs on every
        frame, so re-tuning it is wasted DAC settle time); later layers map
        into the remaining capacity. That costs (i) a constant first-layer
        DAC/TUN power rail under all layers and (ii) a capacity reduction
        (more remap rounds) for the rest — reproducing the paper's
        observation that MX sits between the pure configurations in both
        power and kFPS/W.
        """
        specs = resolve_layer_specs(len(layers), scheme)
        lps = [self.layer_power(LayerSchedule(s, sp))
               for s, sp in zip(layers, specs)]
        return self.finalize_report(lps, layers, scheme)

    def finalize_report(self, lps: List["LayerPower"],
                        layers: Sequence[OCSchedule],
                        scheme: WASpec | MixedPrecisionScheme) -> ModelReport:
        if isinstance(scheme, MixedPrecisionScheme) and len(lps) > 1:
            first_compute = next((i for i, s in enumerate(layers)
                                  if s.kind != "ca"), None)
            if first_compute is not None:
                s1 = layers[first_compute]
                m1 = min(s1.mapped_mrs_avg, float(self.oc.total_mrs))
                rail_dac = m1 * dac_power_per_mr(scheme.first.w_bits, self.c)
                rail_tun = m1 * self.c.tun_per_mr_w
                cap = max(1.0 - m1 / self.oc.total_mrs, 1e-3)
                for i, l in enumerate(lps):
                    if i <= first_compute:
                        continue
                    l.breakdown_w["DAC"] += rail_dac
                    l.breakdown_w["TUN"] += rail_tun
                    l.cycles = int(math.ceil(l.cycles / cap))
                    l.remap_cycles = int(math.ceil(l.remap_cycles / cap))
        t = sum(l.time_s for l in lps)
        max_p = max(l.total_w for l in lps)
        avg_p = sum(l.total_w * l.time_s for l in lps) / t if t else 0.0
        fps = 1.0 / t if t else 0.0
        kfps_w = fps / avg_p / 1e3 if avg_p else 0.0
        return ModelReport(lps, max_p, avg_p, t, fps, kfps_w)
