"""The layer IR the paper's models are written in, plus the elementwise
pieces of the device semantics (activation, CRC requantization).

The IR dataclasses are field-for-field copies of the reference package's,
so a plan compiled from them resolves the same steps, schedules and power
report. The device interpreter itself (``LightatorDevice``) is not ported:
``core.plan`` is the executor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import ACT_BITS, true_div


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


def _crc_requant(x: torch.Tensor, a_qmax=None, per_frame: bool = False):
    """Electronic output -> CRC codes for the next layer's DMVA.

    Returns ``(codes, scale)``; codes are float-carried 0..15. Per-tensor
    calibration (the seed semantics) reduces one max over the whole tensor,
    batch axis included, giving a 0-d scale; ``per_frame`` reduces each
    frame's own axes instead (scale shape [B, 1, ...]), so a frame's codes
    never depend on its batch neighbours. ``a_qmax`` is the divisor,
    ideally a tensor on ``x``'s device (default: the 4-bit CRC's 15).
    """
    if a_qmax is None:
        a_qmax = float((1 << ACT_BITS) - 1)
    x = torch.clamp_min(x, 0.0)
    if per_frame:
        amax = x.amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    else:
        amax = x.amax()
    scale = true_div(torch.clamp_min(amax, 1e-8), a_qmax)
    codes = torch.clamp(torch.round(true_div(x, scale)), 0,
                        (1 << ACT_BITS) - 1)
    return codes, scale
