"""Compressive Acquisitor (CA) — paper Sec. 3.2.

The CA fuses RGB->grayscale conversion and pool x pool average pooling into
one weighted-sum MAC with pre-set MR weights (paper eq. (1)):

    P_AvgGray = sum_{i in pool} sum_{j in {R,G,B}} (1/k^2) * c_j * P_ij
    c = (0.299, 0.587, 0.114)

``compressive_acquire`` is the plain version of the ``ca_pool`` kernel and
reproduces the reference's jitted einsum bit for bit: that einsum is a
sequential float32 FMA chain over the taps in channel-major order (c, then
di, then dj), starting from 0. PyTorch has no fused multiply-add, so each
step is computed exactly by :func:`fma_f32`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.accelerator import window_mean

RGB_COEFFS = (0.299, 0.587, 0.114)


def ca_coefficients(pool: int, channels: int = 3,
                    device=None) -> torch.Tensor:
    """The pre-set MR weights for one CA stride: shape [pool, pool, C].

    channels == 3 -> RGB->gray fused with mean pooling; otherwise a plain
    channel mean fused with the pooling. They are computed on the CPU and
    copied to ``device`` (synchronously), so they are the same on every
    device: PyTorch's CUDA division by a scalar multiplies by its
    reciprocal, which could change 1/p^2 for a p that is no power of two.
    """
    if channels == 3:
        chan = torch.tensor(RGB_COEFFS, dtype=torch.float32)
    else:
        chan = torch.full((channels,), 1.0 / channels, dtype=torch.float32)
    w = torch.ones((pool, pool, channels), dtype=torch.float32) \
        / float(pool * pool)
    return (w * chan[None, None, :]).to(device)


def fma_f32(x: torch.Tensor, c: torch.Tensor, acc: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``fma(x, c, acc)``: ``x * c + acc`` rounded once.

    The product of two float32 values is exact in float64. The float64 sum
    ``s`` is rounded, but TwoSum recovers its error ``err`` exactly, and
    ``s`` rounds to the same float32 as the exact sum unless ``s`` lies on a
    float32 midpoint; there the sign of ``err`` breaks the tie.
    """
    p = x.double() * c.double()
    a = acc.double()
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)
    r = s.float()
    rd = r.double()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    dn = torch.nextafter(r, torch.full_like(r, -math.inf))
    hi = torch.where(rd >= s, r, up)
    lo = torch.where(rd <= s, r, dn)
    midpoint = ((hi.double() - s) == (s - lo.double())) & (hi != lo)
    return torch.where(midpoint & (err != 0),
                       torch.where(err > 0, hi, lo), r)


def compressive_acquire(img: torch.Tensor, pool: int = 2,
                        rgb_to_gray: bool | None = None) -> torch.Tensor:
    """Fused channel mix + pool x pool average pooling (one weighted MAC).

    img: [..., H, W, C] with H, W divisible by pool. Returns [..., H/p, W/p]
    (fused gray) or [..., H/p, W/p, C] (per-channel mean pooling when
    rgb_to_gray=False; the default for C != 3).
    """
    *lead, h, w, c = img.shape
    if h % pool or w % pool:
        raise ValueError(f"H({h}), W({w}) must be divisible by pool={pool}")
    if rgb_to_gray is None:
        rgb_to_gray = c == 3
    x = img.float().reshape(*lead, h // pool, pool, w // pool, pool, c)
    if not rgb_to_gray:
        return window_mean(x)
    coeffs = ca_coefficients(pool, c, device=img.device)
    acc = torch.zeros_like(x[..., 0, :, 0, 0])
    for ch in range(c):
        for di in range(pool):
            for dj in range(pool):
                acc = fma_f32(x[..., di, :, dj, ch], coeffs[di, dj, ch], acc)
    return acc
