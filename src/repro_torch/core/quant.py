"""Lightator quantization: ADC-less CRC activations + MR weight imprinting.

The paper's compute model (Sec. 3), as the reference package states it:

* Activations are captured through the Comparator-based Reading Circuit
  (CRC): 15 comparators -> 16 levels -> unsigned 4-bit codes. Activation
  precision is fixed at 4 bits throughout.
* Weights sit on microring resonators as symmetric signed integers with
  ``2^(b-1)-1`` magnitude levels per rail: [4] -> [-7, 7], [3] -> [-3, 3].
* Lightator-MX keeps the first layer at [4:4] and drops the rest to [3:4]
  or [2:4].

QAT uses straight-through estimators (STE): the forward pass sees the exact
quantized values the optical core computes with, the backward pass sees
identity through the rounding.

Divisions go through :func:`true_div`, which is the IEEE float32 quotient
whatever device or operand shapes: PyTorch rewrites a division by a scalar
operand into a multiply by its reciprocal, which is 1 ulp off for divisors
such as 15 and 7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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
    # photonic non-ideality: std of Gaussian noise on the dequantized MR
    # transmission, in quant steps (``fake_quant_weight``'s noise)
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


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``. A value on a bound
    gets half the gradient, as JAX gives it (``torch.clamp`` gives all)."""
    def bound(v):
        return torch.full((), float(v), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) in the forward pass (half to even), identity gradient in the
    backward pass: the reference's ``x + stop_gradient(round(x) - x)``."""
    return x + (torch.round(x) - x).detach()


# ---------------------------------------------------------------------------
# Activation quantization (CRC / VCSEL path)
# ---------------------------------------------------------------------------

def crc_quantize_act(x: torch.Tensor, scale, a_bits: int = ACT_BITS
                     ) -> torch.Tensor:
    """The CRC: compare against 15 reference levels -> integer code 0..15
    (int8 carrier). ``scale`` maps one quant step to physical units."""
    qmax = (1 << a_bits) - 1
    return _clip(torch.round(true_div(x, scale)), 0, qmax).to(torch.int8)


def fake_quant_act(x: torch.Tensor, scale, a_bits: int = ACT_BITS,
                   train: bool = True) -> torch.Tensor:
    """Fake-quantized activation: the value the optical core streams.
    Unsigned (light intensity); STE when ``train``."""
    qmax = (1 << a_bits) - 1
    xs = _clip(true_div(x, scale), 0.0, float(qmax))
    q = _ste_round(xs) if train else torch.round(xs)
    return q * scale


def act_scale_for_range(max_val, a_bits: int = ACT_BITS) -> torch.Tensor:
    """Scale that maps [0, max_val] onto the CRC's levels."""
    qmax = (1 << a_bits) - 1
    return true_div(torch.as_tensor(max_val, dtype=torch.float32), qmax)


# ---------------------------------------------------------------------------
# Weight quantization (MR imprinting path)
# ---------------------------------------------------------------------------

def weight_scale(w: torch.Tensor, w_bits: int, per_channel: bool = True,
                 axis: int = -1) -> torch.Tensor:
    """Symmetric scale. Per-channel = per output feature (axis=-1 for
    [in, out]), keeping dims."""
    return true_div(_weight_amax(w, per_channel, axis),
                    (1 << (w_bits - 1)) - 1)


def _weight_amax(w: torch.Tensor, per_channel: bool, axis: int = -1
                 ) -> torch.Tensor:
    """|w|'s maximum per output channel (all axes but ``axis``, dims kept)
    or over the tensor, floored at 1e-8: the MR scale's numerator."""
    if per_channel:
        keep = axis % w.ndim
        amax = w.abs().amax(dim=tuple(i for i in range(w.ndim) if i != keep),
                            keepdim=True)
    else:
        amax = w.abs().amax()
    floor = torch.full((), 1e-8, dtype=amax.dtype, device=amax.device)
    return torch.maximum(amax, floor)


def fake_quant_weight(w: torch.Tensor, spec: WASpec, axis: int = -1,
                      noise_generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Fake-quantized weight with STE; optional MR transmission noise.

    The noise models thermal drift of the ring resonance: a Gaussian
    perturbation of the level, std ``spec.mr_noise_std`` quant steps, drawn
    from ``noise_generator`` (on ``w``'s device). The reference draws it
    from ``jax.random``: the two agree in distribution only.
    """
    s = weight_scale(w, spec.w_bits, spec.per_channel, axis)
    q = _ste_round(_clip(true_div(w, s), -float(spec.w_qmax),
                         float(spec.w_qmax)))
    if spec.mr_noise_std > 0.0 and noise_generator is not None:
        q = q + spec.mr_noise_std * torch.randn(
            q.shape, generator=noise_generator, dtype=q.dtype,
            device=q.device)
    return q * s


def quantize_weight(w: torch.Tensor, spec: WASpec, w_qmax=None):
    """-> (q int8, scale f32). q in [-w_qmax, w_qmax]; dequant = q * scale.

    Per-channel scales reduce over every axis but the last (the output
    channel of HWIO conv and [K, N] dense weights), keeping dims.
    """
    w = w.float()
    s = (weight_scale(w, spec.w_bits, spec.per_channel) if w_qmax is None
         else true_div(_weight_amax(w, spec.per_channel), w_qmax))
    q = torch.clamp(torch.round(true_div(w, s)), -spec.w_qmax, spec.w_qmax)
    return q.to(torch.int8), s


# ---------------------------------------------------------------------------
# Quantized matmul semantics (the reference the kernels must match)
# ---------------------------------------------------------------------------

def qmatmul_reference(x: torch.Tensor, w: torch.Tensor, spec: WASpec,
                      act_scale=1.0) -> torch.Tensor:
    """Integer-exact photonic MVM semantics on float carriers.

    x [..., K] non-negative activations, w [K, N]: CRC codes of x times the
    per-output-channel MR levels of w, an exact accumulate, dequantized by
    ``acc * (act_scale * w_scale)`` in the reference's association.
    """
    a_codes = _clip(torch.round(true_div(x.float(), act_scale)), 0,
                    spec.a_qmax)
    wq, ws = quantize_weight(w, spec)
    acc = torch.matmul(a_codes.double(), wq.double()).float()
    scale = torch.as_tensor(act_scale, dtype=torch.float32, device=acc.device)
    return acc * (scale * ws.reshape(-1))


def resolve_layer_specs(n_layers: int,
                        scheme: WASpec | MixedPrecisionScheme
                        ) -> Sequence[WASpec]:
    if isinstance(scheme, MixedPrecisionScheme):
        return [scheme.spec_for_layer(i) for i in range(n_layers)]
    return [scheme] * n_layers
