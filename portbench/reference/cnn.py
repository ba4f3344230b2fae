"""Plain PyTorch reference of a served Lightator CNN, frame by frame.

It follows the device's numerics as the paper and the configuration file
state them, written out here with plain torch ops and nothing of the
program under test:

* every frame is calibrated on its own (the serving semantics): a tensor
  is requantized by clamping at 0, taking the frame's maximum, the scale
  ``max(amax, 1e-8) / 15`` and the codes ``clamp(round(y / scale), 0, 15)``;
* weights sit on ``2^(b-1) - 1`` symmetric levels a side, one scale per
  output channel: ``max|w| / qmax`` floored at 1e-8, levels
  ``clamp(round(w / scale), -qmax, qmax)``;
* a conv or dense layer accumulates codes times levels exactly (float64,
  then rounded: every partial sum is an integer far below 2^53), and its
  requant takes ``acc * (act_scale * w_scale) + bias``, the activation and
  the pool in float32;
* the compressive acquisition (CA) front mixes RGB to gray and averages
  ``pool x pool`` windows as one chain of float32 fused multiply-adds over
  the taps, channel-major (channel, row, column), from 0;
* each division is the correctly rounded float32 quotient (taken in
  float64 and rounded once).

``precision="bfloat16"`` computes every float32 step of the requants in
bfloat16 instead (the control of ``portbench/control.py``); ``w_bits``
overrides the configuration's weight bits (the other control).

Layers come as the configuration file's dicts (``kind``: ``ca``, ``conv``,
``flatten``, ``dense``); weights as ``{name: {"w": HWIO or [K, N],
"b": [N]}}`` float32 tensors on any device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

RGB = (0.299, 0.587, 0.114)


def true_div(a: torch.Tensor, b) -> torch.Tensor:
    """float32 ``a / b``, correctly rounded (one rounding of the float64
    quotient, which is exact enough for division)."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    return (a.double() / b).to(a.dtype)


class Numerics:
    """The float steps of the requants, in float32 or (the control) in
    bfloat16."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = (torch.float32 if precision == "float32"
                      else torch.bfloat16)

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def requant(self, y: torch.Tensor, a_bits: int):
        """Per-frame CRC requant of ``y`` [B, ...] -> (codes, scale), the
        codes float32 0..2^a_bits-1, the scale [B, 1, ...]."""
        qmax = float((1 << a_bits) - 1)
        y = self.cast(y).clamp_min(0.0)
        amax = y.flatten(1).amax(1).reshape((-1,) + (1,) * (y.ndim - 1))
        scale = true_div(amax.clamp_min(1e-8), qmax)
        codes = torch.clamp(torch.round(true_div(y, scale)), 0.0, qmax)
        return codes.float(), scale.float()

    def dequant(self, acc: torch.Tensor, act_scale: torch.Tensor,
                w_scale: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        """``acc * (act_scale * w_scale) + bias`` (w_scale broadcast over
        the last axis), each step rounded once."""
        s = self.cast(act_scale) * self.cast(
            w_scale.reshape((1,) * (acc.ndim - 1) + (-1,)))
        y = self.cast(acc) * s
        if bias is not None:
            y = y + self.cast(bias)
        return y


def quantize_weight(w: torch.Tensor, w_bits: int):
    """-> (levels float32, scale float32 with one value an output channel,
    dims kept)."""
    qmax = float((1 << (w_bits - 1)) - 1)
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = true_div(amax.clamp_min(1e-8), qmax)
    levels = torch.clamp(torch.round(true_div(w, scale)), -qmax, qmax)
    return levels, scale


def fma_f32(x: torch.Tensor, c: torch.Tensor,
            acc: torch.Tensor) -> torch.Tensor:
    """float32 ``x * c + acc`` rounded once. The product is exact in
    float64; the float64 sum is rounded, and where it lands exactly on a
    float32 midpoint its rounding error (TwoSum) picks the side."""
    p = x.double() * c.double()
    a = acc.double()
    s = a + p
    z = s - a
    err = (a - (s - z)) + (p - z)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    dn = torch.nextafter(r, torch.full_like(r, -math.inf))
    hi = torch.where(r.double() >= s, r, up)
    lo = torch.where(r.double() <= s, r, dn)
    tie = ((hi.double() - s) == (s - lo.double())) & (hi != lo)
    return torch.where(tie & (err != 0), torch.where(err > 0, hi, lo), r)


def ca_gray(x: torch.Tensor, pool: int) -> torch.Tensor:
    """The CA front: [B, H, W, 3] -> [B, H/p, W/p, 1], RGB to gray fused
    with p x p mean pooling, coefficient (1/p^2) * c_rgb a tap."""
    b, h, w, c = x.shape
    xr = x.float().reshape(b, h // pool, pool, w // pool, pool, c)
    quarter = torch.tensor(1.0, dtype=torch.float32) / float(pool * pool)
    acc = torch.zeros_like(xr[:, :, 0, :, 0, 0])
    for ch in range(c):
        coef = (quarter * torch.tensor(RGB[ch], dtype=torch.float32)).to(
            x.device)
        for di in range(pool):
            for dj in range(pool):
                acc = fma_f32(xr[:, :, di, :, dj, ch], coef, acc)
    return acc[..., None]


def same_pads(n: int, kernel: int, stride: int, padding: str):
    if padding == "VALID":
        return 0, 0
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def conv_acc(codes: torch.Tensor, levels: torch.Tensor, stride: int,
             padding: str) -> torch.Tensor:
    """Exact accumulate of NHWC codes by HWIO levels -> float32 NHWC."""
    k = levels.shape[0]
    ph = same_pads(codes.shape[1], k, stride, padding)
    pw = same_pads(codes.shape[2], k, stride, padding)
    x = F.pad(codes.permute(0, 3, 1, 2).double(), (*pw, *ph))
    acc = F.conv2d(x, levels.permute(3, 2, 0, 1).double(), stride=stride)
    return acc.round().float().permute(0, 2, 3, 1).contiguous()


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "none":
        return y
    raise ValueError(f"activation {act!r} is not in the reference")


def max_pool(y: torch.Tensor, size: int) -> torch.Tensor:
    b, h, w, c = y.shape
    return y.reshape(b, h // size, size, w // size, size, c).amax(dim=(2, 4))


class Reference:
    """A configuration's CNN over given float weights: quantizes them once,
    then runs blocks of frames (:meth:`logits`)."""

    def __init__(self, layers: List[Dict], weights: Dict[str, Dict],
                 w_bits: int, a_bits: int, precision: str = "float32"):
        self.layers = layers
        self.a_bits = a_bits
        self.num = Numerics(precision)
        self.q = {}
        for layer in layers:
            if layer["kind"] in ("conv", "dense"):
                p = weights[layer["name"]]
                levels, scale = quantize_weight(p["w"], w_bits)
                self.q[layer["name"]] = (levels, scale, p.get("b"))

    @torch.no_grad()
    def logits(self, frames: torch.Tensor) -> torch.Tensor:
        """``frames`` [B, H, W, C] float32 -> logits [B, classes] float32."""
        num, a_bits = self.num, self.a_bits
        x, scale = num.requant(frames.float(), a_bits)
        for layer in self.layers:
            kind = layer["kind"]
            if kind == "ca":
                if not layer.get("rgb_to_gray", True) or x.shape[-1] != 3:
                    raise ValueError("the reference's CA is the RGB front")
                intens = num.cast(x) * num.cast(scale)
                x, scale = num.requant(ca_gray(intens.float(),
                                               layer["pool"]), a_bits)
            elif kind == "conv":
                levels, ws, bias = self.q[layer["name"]]
                acc = conv_acc(x, levels, layer["stride"], layer["padding"])
                y = activation(num.dequant(acc, scale, ws, bias),
                               layer["act"])
                if layer.get("pool"):
                    pool_kind, size = layer["pool"]
                    if pool_kind != "max":
                        raise ValueError("the reference pools by max only")
                    y = max_pool(y, size)
                x, scale = num.requant(y, a_bits)
            elif kind == "flatten":
                b = x.shape[0]
                x, scale = num.requant(
                    num.cast(x.reshape(b, -1)) * num.cast(
                        scale.reshape(b, 1)), a_bits)
            elif kind == "dense":
                levels, ws, bias = self.q[layer["name"]]
                acc = (x.double() @ levels.double()).round().float()
                y = num.dequant(acc, scale.reshape(-1, 1), ws, bias)
                if layer["act"] == "none":
                    return y.float()
                x, scale = num.requant(activation(y, layer["act"]), a_bits)
            else:
                raise ValueError(f"unknown layer kind {kind!r}")
        raise ValueError("the configuration ends in no classifier head")
