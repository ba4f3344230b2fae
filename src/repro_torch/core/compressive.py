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

``upsample_reconstruct`` is the CA's inverse (bilinear or nearest), bitwise
equal to the reference's ``jax.image.resize``, with the same FMA emulation.
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _bilinear_taps(n_in: int, n_out: int, device: torch.device):
    """JAX's triangle-kernel resize weights along one axis, as (input
    index, weight) per output position, on ``device``: [T, n_out] each, the
    nonzero taps in ascending input index, padded with zero weights. Made
    once per (sizes, device) and never written again.

    The weights are computed in float32 exactly as ``jax.image.resize``
    does: sample = (o + 0.5) * (1 / scale) - 0.5, w = max(0, 1 - |sample -
    i|), each output's weights divided by their sum (so an edge output's
    lone tap weighs 1), and zero where the sample lies outside the input.
    """
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / f32(max(inv_scale, 1.0))
    weights = np.maximum(f32(0), f32(1) - dist)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0)).astype(f32)
    n_taps = max(1, int((weights != 0).sum(axis=0).max()))
    idx = np.zeros((n_taps, n_out), np.int64)
    wts = np.zeros((n_taps, n_out), f32)
    for o in range(n_out):
        nz = np.nonzero(weights[:, o])[0]
        idx[:len(nz), o] = nz
        wts[:len(nz), o] = weights[nz, o]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wts).to(device))


def _interp_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """One separable bilinear pass: each output a float32 FMA chain over
    its taps in ascending input index, from 0."""
    idx, wts = _bilinear_taps(x.shape[axis], n_out, x.device)
    shape = [1] * x.ndim
    shape[axis] = n_out
    acc = None
    for t in range(idx.shape[0]):
        xt = x.index_select(axis, idx[t])
        acc = fma_f32(xt, wts[t].reshape(shape),
                      torch.zeros_like(xt) if acc is None else acc)
    return acc


@functools.lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int,
                   device: torch.device) -> torch.Tensor:
    """JAX's nearest-neighbour source rows, floor((o + 0.5) * n_in / n_out)
    in float32, on ``device``."""
    f32 = np.float32
    pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
    return torch.from_numpy(np.floor(pos).astype(np.int64)).to(device)


def upsample_reconstruct(img: torch.Tensor, factor: int = 2,
                         method: str = "bilinear") -> torch.Tensor:
    """The CA's inverse: [B, H, W, C] -> [B, H*factor, W*factor, C].

    ``bilinear`` models preset interpolation banks (each output a fixed
    weighted sum of at most 4 inputs); ``nearest`` is a copy. Bitwise equal
    to the reference's ``jax.image.resize``: a separable pass over H, then
    over W, each output a float32 FMA chain (``fma_f32``) over its nonzero
    taps in ascending input index, with JAX's weights. It runs as PyTorch
    ops on the tensor's device.
    """
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"unknown upsample method {method!r}")
    x = img.float()
    for axis in (1, 2):
        n_in = x.shape[axis]
        n_out = n_in * factor
        if n_out == n_in:
            continue                 # JAX skips dimensions it does not resize
        if method == "nearest":
            x = x.index_select(axis, _nearest_index(n_in, n_out, x.device))
        else:
            x = _interp_axis(x, axis, n_out)
    return x
