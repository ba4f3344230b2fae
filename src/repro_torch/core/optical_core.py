"""Optical Core geometry and the paper's hardware-mapping methodology (Sec. 4).

Geometry: MRs are organized in groups of 9 per arm (matched to the ubiquitous
3x3 kernel), 6 arms per bank, 96 banks in an 8-column x 12-row array:
9 * 6 * 96 = 5184 MRs => at most 5184 MACs per optical cycle.

Mapping rules reproduced exactly (Fig. 6):
  3x3 kernel  -> 9 taps  -> 1 arm/stride,  6 strides/bank, 0 idle MRs, summation unused
  5x5 kernel  -> 25 taps -> 3 arms/stride, 2 strides/bank, 2 idle MRs/stride, stage-1 sum
  7x7 kernel  -> 49 taps -> 6 arms/stride, 1 stride/bank,  5 idle MRs/stride, stage-1+2 sum
  FC          -> fan-in segmented into 9-MAC chunks + summation tree

Execution model (weight-stationary, non-replicated — Sec. 3: "weight values
are stored in a dedicated memory and then mapped to the MRs during the
processing of each layer"):

  1. Map as many distinct kernels / output neurons as fit the 576 arms.
  2. Stream every input window (position / token) through the mapped set —
     one optical cycle per window; the DMVA broadcasts the window's
     activations to all banks.
  3. Remap the next round of kernels (DAC settle = ``remap`` latency) and
     repeat until all output channels are produced.

The scheduler turns layer shapes into optical cycles, remap rounds, and
mapped-MR occupancy — the inputs to the power/latency model (Fig. 8/9/10).
Pure arithmetic on shapes: a copy of the reference package's module, kept
field for field so the port's power reports equal the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class OCConfig:
    mrs_per_arm: int = 9
    arms_per_bank: int = 6
    bank_cols: int = 8
    bank_rows: int = 12

    @property
    def n_banks(self) -> int:
        return self.bank_cols * self.bank_rows           # 96

    @property
    def mrs_per_bank(self) -> int:
        return self.mrs_per_arm * self.arms_per_bank      # 54

    @property
    def total_mrs(self) -> int:
        return self.mrs_per_bank * self.n_banks           # 5184

    @property
    def total_arms(self) -> int:
        return self.arms_per_bank * self.n_banks          # 576

    @property
    def macs_per_cycle(self) -> int:
        return self.total_mrs                             # 5184


DEFAULT_OC = OCConfig()


@dataclasses.dataclass(frozen=True)
class ConvMapping:
    """How one stride (output position) of a kernel maps onto bank arms."""

    kernel_taps: int          # k*k*c_in taps feeding one output
    arms_per_stride: int      # arms needed for one stride
    strides_per_bank: int     # concurrent strides in one bank (0 => multi-bank)
    banks_per_stride: int     # banks needed when a stride spans banks
    idle_mrs_per_stride: int  # MRs left unused (gray in Fig. 6)
    summation_stages: int     # 0 (BPD only), 1, or 2


def conv_mapping(kernel_size: int, c_in: int = 1, oc: OCConfig = DEFAULT_OC) -> ConvMapping:
    """Paper Fig. 6 mapping, generalized to multi-channel inputs.

    For the paper's single-channel examples this reproduces exactly:
      k=3 -> (1 arm, 6 strides/bank, 0 idle, 0 stages)
      k=5 -> (3 arms, 2 strides/bank, 2 idle, 1 stage)
      k=7 -> (6 arms, 1 stride/bank, 5 idle, 2 stages)
    """
    taps = kernel_size * kernel_size * c_in
    arms = math.ceil(taps / oc.mrs_per_arm)
    if arms <= oc.arms_per_bank:
        strides_per_bank = oc.arms_per_bank // arms
        banks_per_stride = 1
    else:
        strides_per_bank = 0
        banks_per_stride = math.ceil(arms / oc.arms_per_bank)
    idle = arms * oc.mrs_per_arm - taps
    if arms == 1:
        stages = 0
    elif arms <= 3:
        stages = 1
    else:
        stages = 2
    return ConvMapping(taps, arms, strides_per_bank, banks_per_stride, idle, stages)


def fc_mapping(fan_in: int, oc: OCConfig = DEFAULT_OC) -> ConvMapping:
    """FC layers: segment fan_in into 9-MAC chunks, aggregate in the tree."""
    return conv_mapping(1, c_in=fan_in, oc=oc)


def kernels_resident(m: ConvMapping, oc: OCConfig = DEFAULT_OC) -> int:
    """Distinct kernels / output neurons concurrently mapped on the OC."""
    if m.strides_per_bank > 0:
        return m.strides_per_bank * oc.n_banks
    return max(oc.n_banks // m.banks_per_stride, 1)


# ---------------------------------------------------------------------------
# Cycle scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OCSchedule:
    """Optical-cycle schedule for one layer — feeds the power/latency model."""

    name: str
    kind: str                 # "conv" | "fc" | "ca" | "matmul"
    cycles: int               # streaming optical cycles
    macs: int                 # useful MACs
    mapped_mrs_avg: float     # MRs concurrently holding weights (DAC/TUN load)
    idle_mr_fraction: float   # fraction of occupied-arm MRs idle (mapping waste)
    weight_remaps: int        # weight-mapping rounds (DAC settle events)
    vcsel_channels: float     # concurrent activation wavelengths (DMVA load)
    bpd_reads: int            # arm read-outs over the layer
    summation_ops: int        # electronic partial-sum additions over the layer
    mapping: ConvMapping | None = None

    @property
    def utilization(self) -> float:
        """Useful MACs / theoretical OC MACs over the streaming cycles."""
        total = self.cycles * DEFAULT_OC.macs_per_cycle
        return self.macs / total if total else 0.0


def _schedule_mvm(name: str, kind: str, n_windows: int, taps: int,
                  n_outputs: int, m: ConvMapping,
                  oc: OCConfig = DEFAULT_OC,
                  preset_weights: bool = False) -> OCSchedule:
    """Common engine: n_outputs kernels of ``taps`` taps over n_windows."""
    resident = min(kernels_resident(m, oc), n_outputs)
    rounds = math.ceil(n_outputs / resident)
    cycles = rounds * n_windows
    macs = n_windows * n_outputs * taps
    mapped_mrs = resident * m.arms_per_stride * oc.mrs_per_arm
    # average over rounds (last round may be partially filled)
    avg_resident = n_outputs / rounds
    mapped_mrs_avg = avg_resident * m.arms_per_stride * oc.mrs_per_arm
    vcsel_channels = min(float(taps), float(oc.total_mrs))
    bpd_reads = n_windows * n_outputs * m.arms_per_stride
    summation_ops = n_windows * n_outputs * max(m.arms_per_stride - 1, 0)
    idle_frac = m.idle_mrs_per_stride / (m.arms_per_stride * oc.mrs_per_arm)
    return OCSchedule(name, kind, cycles, macs,
                      min(mapped_mrs_avg, float(oc.total_mrs)), idle_frac,
                      0 if preset_weights else rounds,
                      vcsel_channels, bpd_reads, summation_ops, m)


def schedule_conv(name: str, h_out: int, w_out: int, c_in: int, c_out: int,
                  kernel_size: int, oc: OCConfig = DEFAULT_OC) -> OCSchedule:
    """Conv layer: windows = output positions, outputs = output channels."""
    m = conv_mapping(kernel_size, c_in, oc)
    return _schedule_mvm(name, "conv", h_out * w_out, m.kernel_taps,
                         c_out, m, oc)


def schedule_fc(name: str, fan_in: int, fan_out: int, batch: int = 1,
                oc: OCConfig = DEFAULT_OC) -> OCSchedule:
    m = fc_mapping(fan_in, oc)
    return _schedule_mvm(name, "fc", batch, fan_in, fan_out, m, oc)


def schedule_matmul(name: str, m_rows: int, k: int, n_cols: int,
                    oc: OCConfig = DEFAULT_OC) -> OCSchedule:
    """Generic MVM (used for the LM-arch cost model): [M,K] @ [K,N]."""
    m = fc_mapping(k, oc)
    s = _schedule_mvm(name, "matmul", m_rows, k, n_cols, m, oc)
    return s


def schedule_ca(name: str, h_out: int, w_out: int, pool: int,
                channels: int = 3, oc: OCConfig = DEFAULT_OC) -> OCSchedule:
    """Compressive Acquisitor: fused RGB->gray + pool x pool mean pooling.

    One fused "kernel" with pre-set coefficients (paper eq. (1)): no DACs,
    no remaps — the CA banks are weight-preset at design time.
    """
    m = conv_mapping(pool, channels, oc)
    return _schedule_mvm(name, "ca", h_out * w_out, m.kernel_taps, 1, m, oc,
                         preset_weights=True)


def layer_dict(s: OCSchedule) -> Dict:
    d = dataclasses.asdict(s)
    d["utilization"] = s.utilization
    return d
