"""Wrappers of the Compressive Acquisitor kernel (``csrc/ca_pool.cu``).

Two ops share the kernel:

* :func:`ca_pool` is the reference's public op (``kernels/ca_pool/ops.py``
  there): any [p, p, C] coefficients (``coeffs=``), the preset CA bank
  (gray) or uniform ``1/(p*p*C)`` weights (``rgb_to_gray=False``), always
  [B, H/p, W/p] in the image's dtype. Its plain version is
  ``ref.ca_pool_ref_generic``.
* :func:`acquire` has ``compressive_acquire``'s contract, the one the
  served path uses (``dispatch.ca_acquire``): the preset bank, or the
  per-channel mean [B, H/p, W/p, C] with ``rgb_to_gray=False``; float32.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
There is no fallback between the two, nor between the kernel's routes:
:func:`ca_config` picks the route, run and grid from the shape and the
operands' alignment before the launch (tested on the CPU), and a refused
launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.core.compressive import compressive_acquire
from repro_torch.core.quant import true_div
from repro_torch.kernels.ca_pool.ref import (ca_coefficients,
                                            ca_pool_ref_generic)

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
def _coefficients(pool: int, channels: int, device: torch.device,
                  gray: bool = True) -> torch.Tensor:
    """The CA weights on ``device``: the preset bank (``gray``) or uniform
    ``1 / (p*p*C)``, divided in float32 (IEEE) as the reference's
    ``jnp.ones(...) / (p * p * c)``. Made on the CPU once per (pool, C,
    device, kind), copied there synchronously and never written again, so
    any stream may read them."""
    if gray:
        return ca_coefficients(pool, channels, device=device)
    return true_div(torch.ones((pool, pool, channels), dtype=torch.float32),
                    pool * pool * channels).to(device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_shape(img: torch.Tensor, pool: int, op: str) -> None:
    if img.ndim != 4:
        raise ValueError(f"{op}: img must be [B, H, W, C], got "
                         f"{tuple(img.shape)}")
    b, h, w, c = img.shape
    if h % pool or w % pool:
        raise ValueError(f"H({h}), W({w}) must be divisible by pool={pool}")
    if b * h > INT_MAX or pool * w * c > INT_MAX:
        raise ValueError(f"{op}: {b}x{h} rows or {pool}x{w}x{c} floats of a "
                         f"window row pass a 32-bit index")


def _launch(x: torch.Tensor, coef: Optional[torch.Tensor], pool: int,
            gray: bool) -> torch.Tensor:
    """One launch on float32 ``x`` [B, H, W, C] (contiguous, on the card):
    the weighted sum with ``coef`` [p, p, C] (gray) or the per-channel
    mean (``coef`` None). ``coef`` is read by the kernel on the current
    stream; the caller keeps it alive until then."""
    b, h, w, c = x.shape
    shape = (b, h // pool, w // pool) if gray else \
        (b, h // pool, w // pool, c)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    cfg = ca_config(b, h, w, c, pool, gray, _sm_count(x.device),
                    x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.library("ca_pool", _SIGNATURES)
    err = lib.ca_pool_launch(
        x.data_ptr(), None if coef is None else coef.data_ptr(),
        out.data_ptr(), b, h, w, c, pool, int(gray), ROUTES[cfg.route],
        cfg.r, cfg.tx, cfg.ty, *cfg.grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ca_pool")
    LAUNCHES.inc()
    return out


def acquire(img: torch.Tensor, pool: int = 2,
            rgb_to_gray: Optional[bool] = None) -> torch.Tensor:
    """img [B, H, W, C] float32 -> [B, H/p, W/p] (fused weighted
    acquisition with the preset CA weights) or [B, H/p, W/p, C]
    (per-channel mean, ``rgb_to_gray=False``; the default for C != 3).
    ``compressive_acquire``'s contract, bitwise."""
    _check_shape(img, pool, "acquire")
    if rgb_to_gray is None:
        rgb_to_gray = img.shape[-1] == 3
    if not img.is_cuda:
        return compressive_acquire(img, pool, rgb_to_gray)
    if img.dtype != torch.float32:
        raise TypeError(f"acquire: the kernel takes float32, got {img.dtype}")
    x = img.contiguous()
    coef = _coefficients(pool, x.shape[-1], x.device) if rgb_to_gray \
        else None
    return _launch(x, coef, pool, bool(rgb_to_gray))


def ca_pool(img: torch.Tensor, pool: int = 2,
            rgb_to_gray: Optional[bool] = None,
            coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused channel mix + pool x pool weighted pooling, the reference's op:
    img [B, H, W, C] -> [B, H/p, W/p] in ``img``'s dtype.

    ``coeffs`` [p, p, C] (taken as float32, on the image's device)
    overrides the preset CA weights (the paper's configurable compression:
    any strided weighted acquisition). Without it: the preset bank when
    ``rgb_to_gray`` (the default for C == 3), else uniform ``1/(p*p*C)``
    weights, one mean over the window and the channels. Float16 and
    bfloat16 images are widened to float32 (exact); the float32 sum (an
    FMA chain over c, di, dj from +0.0f) is rounded once to the image's
    dtype, as the reference kernel's ``acc.astype(out.dtype)``."""
    _check_shape(img, pool, "ca_pool")
    if img.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"ca_pool: takes float32, bfloat16 or float16, got "
                        f"{img.dtype}")
    c = img.shape[-1]
    if coeffs is None:
        if rgb_to_gray is None:
            rgb_to_gray = c == 3
        coef = _coefficients(pool, c, img.device, bool(rgb_to_gray))
    else:
        coef = torch.as_tensor(coeffs)
        if tuple(coef.shape) != (pool, pool, c):
            raise ValueError(f"ca_pool: coeffs must be [{pool}, {pool}, {c}],"
                             f" got {tuple(coef.shape)}")
        if coef.device != img.device:
            raise ValueError(f"ca_pool: coeffs on {coef.device}, the image "
                             f"on {img.device}")
        coef = coef.to(torch.float32).contiguous()
    x = img.to(torch.float32)
    if not img.is_cuda:
        out = ca_pool_ref_generic(x, coef, pool)
    else:
        out = _launch(x.contiguous(), coef, pool, True)
        if coeffs is not None:
            # the caller's bank may be freed as soon as this returns: the
            # allocator must not hand its memory to another stream before
            # the kernel has read it
            coef.record_stream(torch.cuda.current_stream(img.device))
    return out.to(img.dtype)
