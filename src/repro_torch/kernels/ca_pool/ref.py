"""Plain versions of the ca_pool kernel: ``core.compressive`` is the oracle.

The kernel's two modes are ``compressive_acquire``'s: the fused weighted
acquisition (an exact float32 FMA chain over c, then di, then dj) and the
per-channel mean (a row-major window sum, then one division).
:func:`ca_pool_ref_generic` is the weighted mode with any coefficients,
the plain twin of the public ``ops.ca_pool``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.compressive import (ca_coefficients,
                                          compressive_acquire, fma_f32)


def ca_pool_ref(img: torch.Tensor, pool: int = 2,
                rgb_to_gray: Optional[bool] = None) -> torch.Tensor:
    """The fused gray acquisition of ``compressive_acquire``; the
    per-channel mode raises, as the reference's oracle does (the public op
    covers the fused path only)."""
    out = compressive_acquire(img, pool, rgb_to_gray)
    if out.ndim == img.ndim:                # per-channel pooling
        raise ValueError("ca_pool kernel covers the fused gray path; "
                         "use rgb_to_gray semantics")
    return out


def ca_pool_ref_generic(img: torch.Tensor, coeffs: torch.Tensor,
                        pool: int) -> torch.Tensor:
    """img [..., H, W, C], coeffs [p, p, C] -> [..., H/p, W/p] float32: the
    same float32 FMA chain over c, then di, then dj, from +0.0f, that
    ``compressive_acquire`` takes with the preset bank (bitwise equal to it
    there), so the kernel's weighted routes are bitwise to this with any
    coefficients."""
    *lead, h, w, c = img.shape
    x = img.float().reshape(*lead, h // pool, pool, w // pool, pool, c)
    k = coeffs.float()
    acc = torch.zeros_like(x[..., 0, :, 0, 0])
    for ch in range(c):
        for di in range(pool):
            for dj in range(pool):
                acc = fma_f32(x[..., di, :, dj, ch], k[di, dj, ch], acc)
    return acc


__all__ = ["ca_coefficients", "ca_pool_ref", "ca_pool_ref_generic"]
