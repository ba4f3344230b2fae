"""Lightator quantization: ADC-less CRC activations + MR weight imprinting.

The paper's compute model (Sec. 3), as the reference package states it:

* Activations are captured through the Comparator-based Reading Circuit
  (CRC): 15 comparators -> 16 levels -> unsigned 4-bit codes. Activation
  precision is fixed at 4 bits throughout.
* Weights sit on microring resonators as symmetric signed integers with
  ``2^(b-1)-1`` magnitude levels per rail: [4] -> [-7, 7], [3] -> [-3, 3].
* Lightator-MX keeps the first layer at [4:4] and drops the rest to [3:4]
  or [2:4].

Divisions go through :func:`true_div`, which is the IEEE float32 quotient
whatever device or operand shapes: PyTorch rewrites a division by a scalar
operand into a multiply by its reciprocal, which is 1 ulp off for divisors
such as 15 and 7.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

CRC_LEVELS = 16          # 15 comparators -> 16 output codes
CRC_COMPARATORS = 15
ACT_BITS = 4             # fixed by the DMVA hardware


@dataclasses.dataclass(frozen=True)
class WASpec:
    """A [W:A] configuration, e.g. WASpec(4, 4) == "[4:4]"."""

    w_bits: int = 4
    a_bits: int = ACT_BITS
    per_channel: bool = True        # per-output-channel weight scales
    # photonic non-ideality (std of MR transmission noise, in quant steps);
    # carried for field-for-field parity with the reference, unused here
    mr_noise_std: float = 0.0

    def __post_init__(self):
        if self.w_bits not in (1, 2, 3, 4, 8):
            raise ValueError(f"unsupported weight bit-width {self.w_bits}")
        if self.a_bits != ACT_BITS and self.a_bits not in (2, 3, 8):
            raise ValueError(f"unsupported activation bit-width {self.a_bits}")

    @property
    def w_qmax(self) -> int:
        return (1 << (self.w_bits - 1)) - 1  # symmetric signed

    @property
    def a_qmax(self) -> int:
        return (1 << self.a_bits) - 1        # unsigned (light intensity)

    @property
    def name(self) -> str:
        return f"[{self.w_bits}:{self.a_bits}]"


@dataclasses.dataclass(frozen=True)
class MixedPrecisionScheme:
    """Lightator-MX: first layer [4:4], remaining layers at ``rest``."""

    first: WASpec = WASpec(4, 4)
    rest: WASpec = WASpec(3, 4)

    def spec_for_layer(self, layer_idx: int) -> WASpec:
        return self.first if layer_idx == 0 else self.rest

    @property
    def name(self) -> str:
        return f"MX {self.first.name}{self.rest.name}"


W4A4 = WASpec(4, 4)
W3A4 = WASpec(3, 4)
W2A4 = WASpec(2, 4)
MX_43 = MixedPrecisionScheme(W4A4, W3A4)
MX_42 = MixedPrecisionScheme(W4A4, W2A4)


def true_div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE float32 ``a / b``, correctly rounded, on any device.

    The quotient is taken in float64 and rounded once to float32: for
    division a 53-bit intermediate is wide enough (>= 2*24+2 bits) that the
    double rounding is innocuous, so the result is exactly the float32
    quotient XLA and ``__fdiv_rn`` produce. A number ``b`` becomes a 0-d
    tensor filled on ``a``'s device (no host copy, no sync): PyTorch only
    rewrites division by a *host* scalar into a reciprocal multiply.
    """
    if isinstance(b, torch.Tensor):
        b = b.to(device=a.device, dtype=torch.float32)
    else:
        b = torch.full((), float(b), dtype=torch.float32, device=a.device)
    return (a.double() / b.double()).float()


def quantize_weight(w: torch.Tensor, spec: WASpec, w_qmax=None):
    """-> (q int8, scale f32). q in [-w_qmax, w_qmax]; dequant = q * scale.

    Per-channel scales reduce over every axis but the last (the output
    channel of HWIO conv and [K, N] dense weights), keeping dims.
    """
    w = w.float()
    if spec.per_channel:
        amax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    else:
        amax = w.abs().amax()
    s = true_div(torch.clamp_min(amax, 1e-8),
                 spec.w_qmax if w_qmax is None else w_qmax)
    q = torch.clamp(torch.round(true_div(w, s)), -spec.w_qmax, spec.w_qmax)
    return q.to(torch.int8), s


def resolve_layer_specs(n_layers: int,
                        scheme: WASpec | MixedPrecisionScheme
                        ) -> Sequence[WASpec]:
    if isinstance(scheme, MixedPrecisionScheme):
        return [scheme.spec_for_layer(i) for i in range(n_layers)]
    return [scheme] * n_layers
