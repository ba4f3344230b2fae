"""Wrapper of the Compressive Acquisitor kernel (``csrc/ca_pool.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``core.compressive.compressive_acquire``). There is no fallback between
the two, nor between the kernel's routes: :func:`ca_config` picks the
route, run and grid from the shape and the operands' alignment before the
launch (tested on the CPU), and a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ca_pool.ref import ca_coefficients, ca_pool_ref

LAUNCHES = _build.LaunchCounter("ca_pool")
_SIGNATURES = {"ca_pool_launch": (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 12
               + (ctypes.c_void_p,)}

SMS = 132                       # H100 SXM
THREADS = (256, 128, 64, 32)    # CTA sizes in order of preference
THREADS_PER_SM = 2048           # resident threads an SM holds at most
MAX_GRID_Y = 65535
INT_MAX = 2**31 - 1
# (p, C) -> R, the outputs a thread, of the instantiated kernels (the
# CA_GRAY_SHAPES / CA_MEAN_SHAPES lists of ca_pool.cu); any other (p, C)
# takes the generic route, one output pixel a thread
GRAY_SHAPES = {(1, 3): 4, (2, 3): 4, (4, 3): 1, (2, 1): 4, (4, 1): 4}
MEAN_SHAPES = {(2, 1): 4, (2, 3): 4, (4, 1): 4, (4, 3): 1}
ROUTES = {"generic": 0, "scalar": 1, "vector": 2}


@dataclass(frozen=True)
class CaConfig:
    """One launch of the ca_pool kernel: CTAs of ``tx`` x ``ty`` threads,
    ``tx`` along an output row's runs of ``r`` outputs and ``ty`` rows; a
    grid of ``grid[0]`` CTAs along a row and ``grid[1]`` down the rows (a
    grid-stride loop where ``grid[1] * ty`` is fewer than the rows)."""
    route: str
    r: int
    tx: int
    ty: int
    grid: Tuple[int, int]

    @property
    def threads(self) -> int:
        return self.tx * self.ty

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def ca_config(b: int, h: int, w: int, c: int, p: int, gray: bool,
              sm_count: int = SMS, aligned: bool = True) -> CaConfig:
    """The launch for img [b, h, w, c] at pool ``p`` in the gray (fused
    weighted) or mean mode. ``aligned``: the input and output start on 16
    bytes.

    Route: ``vector`` (16-byte loads) for an instantiated (p, C) with W/p
    a multiple of R and aligned operands (rows are then a multiple of 16
    bytes: W*C is a multiple of p*R*C, which each instantiation keeps a
    multiple of 4); ``scalar`` (4-byte loads, a masked row tail) for an
    instantiated (p, C) otherwise; ``generic`` for any other (p, C).
    Threads: the first of ``THREADS`` that gives every SM a CTA, else the
    one with the most CTAs; ``tx`` the smallest power of two that covers a
    row's runs (at most the CTA). Rows beyond one wave of resident CTAs, or
    beyond ``MAX_GRID_Y`` CTAs, are walked by a grid-stride loop."""
    ho, wo = h // p, w // p
    r = (GRAY_SHAPES if gray else MEAN_SHAPES).get((p, c))
    if r is None:
        route, r = "generic", 1
    elif aligned and wo % r == 0:
        route = "vector"
    else:
        route = "scalar"
    runs, rows = _cdiv(wo, r), b * ho
    span = 1 << max(0, runs - 1).bit_length()       # runs rounded up to 2^k
    best = None
    for threads in THREADS:
        tx = min(threads, span)
        ty = threads // tx
        gx = _cdiv(runs, tx)
        wave = max(1, sm_count * (THREADS_PER_SM // threads) // gx)
        gy = min(_cdiv(rows, ty), wave, MAX_GRID_Y)
        cfg = CaConfig(route, r, tx, ty, (gx, gy))
        if cfg.ctas >= sm_count:
            return cfg
        if best is None or cfg.ctas > best.ctas:
            best = cfg
    return best


@functools.lru_cache(maxsize=None)
def _coefficients(pool: int, channels: int, device: torch.device
                  ) -> torch.Tensor:
    """The CA weights on ``device``, made once per (pool, C, device) and
    never written again (``ca_coefficients`` copies them there
    synchronously, so any stream may read them)."""
    return ca_coefficients(pool, channels, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if b * h > INT_MAX or pool * w * c > INT_MAX:
        raise ValueError(f"ca_pool: {b}x{h} rows or {pool}x{w}x{c} floats "
                         f"of a window row pass a 32-bit index")
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
    cfg = ca_config(b, h, w, c, pool, bool(rgb_to_gray), _sm_count(x.device),
                    x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.library("ca_pool", _SIGNATURES)
    err = lib.ca_pool_launch(
        x.data_ptr(), coef_ptr, out.data_ptr(), b, h, w, c, pool,
        int(rgb_to_gray), ROUTES[cfg.route], cfg.r, cfg.tx, cfg.ty,
        *cfg.grid, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ca_pool")
    LAUNCHES.inc()
    return out
