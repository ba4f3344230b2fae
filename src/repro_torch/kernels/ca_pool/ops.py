"""Wrapper of the Compressive Acquisitor kernel (``csrc/ca_pool.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``core.compressive.compressive_acquire``). There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ca_pool.ref import ca_coefficients, ca_pool_ref

LAUNCHES = _build.LaunchCounter("ca_pool")
_SIGNATURES = {"ca_pool_launch": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)}


@functools.lru_cache(maxsize=None)
def _coefficients(pool: int, channels: int, device: torch.device
                  ) -> torch.Tensor:
    """The CA weights on ``device``, made once per (pool, C, device) and
    never written again (``ca_coefficients`` copies them there
    synchronously, so any stream may read them)."""
    return ca_coefficients(pool, channels, device=device)


def ca_pool(img: torch.Tensor, pool: int = 2,
            rgb_to_gray: Optional[bool] = None) -> torch.Tensor:
    """img [B, H, W, C] -> [B, H/p, W/p] (fused weighted acquisition with
    the pre-set CA weights) or [B, H/p, W/p, C] (per-channel mean,
    ``rgb_to_gray=False``). Same contract as ``compressive_acquire``,
    bitwise."""
    if img.ndim != 4:
        raise ValueError(f"ca_pool: img must be [B, H, W, C], got "
                         f"{tuple(img.shape)}")
    b, h, w, c = img.shape
    if h % pool or w % pool:
        raise ValueError(f"H({h}), W({w}) must be divisible by pool={pool}")
    if rgb_to_gray is None:
        rgb_to_gray = c == 3
    if not img.is_cuda:
        return ca_pool_ref(img, pool, rgb_to_gray)
    if img.dtype != torch.float32:
        raise TypeError(f"ca_pool: the kernel takes float32, got {img.dtype}")
    x = img.contiguous()
    if rgb_to_gray:
        coef = _coefficients(pool, c, x.device)
        out = torch.empty((b, h // pool, w // pool), dtype=torch.float32,
                          device=x.device)
        coef_ptr = coef.data_ptr()
    else:
        out = torch.empty((b, h // pool, w // pool, c), dtype=torch.float32,
                          device=x.device)
        coef_ptr = None
    if out.numel() == 0:
        return out
    lib = _build.library("ca_pool", _SIGNATURES)
    err = lib.ca_pool_launch(
        x.data_ptr(), coef_ptr, out.data_ptr(), b, h, w, c, pool,
        int(rgb_to_gray), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ca_pool")
    LAUNCHES.inc()
    return out
