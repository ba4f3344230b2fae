"""Wrapper of the photonic MVM kernel (``csrc/photonic_mvm.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``ref.mvm_int_ref``). There is no fallback between the two.
:func:`photonic_mvm` is the float API over it (the reference's
``kernels/photonic_mvm/ops.py``): signed CRC codes in [-15, 15] and
per-channel MR levels, then ``mvm_int``.

:func:`mvm_config` picks the kernel's route and tile from the shape alone,
so it is tested on the CPU: the ``skinny`` route for N <= 8 and K <= 32
(the imaging path's resident convs), else the tensor-core ``gemm`` route
with the largest tile that, split over K where needed, fills the card's
132 SMs with at least one CTA each; where no tile and split can (tiny M, N
and K), the one that launches the most CTAs.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.quant import WASpec, quantize_weight
from repro_torch.kernels import _build
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref, signed_codes

LAUNCHES = _build.LaunchCounter("photonic_mvm")
_SIGNATURES = {"mvm_int_launch": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
    ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 8 + (
    ctypes.c_void_p,)}

SMS = 132                       # H100 SXM
BK = 32                         # int8 per K step of the gemm route
STAGES = 3                      # its cp.async ring
# gemm tiles the kernel is built for (rows, columns), largest first
GEMM_TILES = ((64, 64), (32, 64), (32, 32), (16, 64), (16, 32), (16, 16),
              (16, 8))
SKINNY_ROWS = 1024              # rows of A a skinny CTA stages
SKINNY_MAX_K, SKINNY_MAX_N = 32, 8
_ROUTES = {"skinny": 0, "gemm": 1}


@dataclass(frozen=True)
class MvmConfig:
    """One launch of the kernel: route, CTA tile (bm rows x bn columns;
    the skinny route's bn is N), K split, and what that gives."""
    route: str
    bm: int
    bn: int
    split: int = 1
    steps_per: int = 1          # K steps of BK bytes per split
    ctas: int = 0
    smem: int = 0               # static shared memory of one CTA, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def mvm_config(m: int, k: int, n: int) -> MvmConfig:
    """The route, tile and K split of ``mvm_int`` at M x K x N."""
    if n <= SKINNY_MAX_N and k <= SKINNY_MAX_K:
        return MvmConfig("skinny", SKINNY_ROWS, n, ctas=_cdiv(m, SKINNY_ROWS),
                         smem=SKINNY_ROWS * SKINNY_MAX_K + 16
                         + 4 * SKINNY_MAX_K * n)
    steps = max(1, _cdiv(k, BK))
    # a tile taller than M rounded up to 16 only adds idle rows
    tiles = [t for t in GEMM_TILES if t[0] <= max(16, _cdiv(m, 16) * 16)]
    best = None
    for bm, bn in tiles:
        n_tiles = _cdiv(m, bm) * _cdiv(n, bn)
        want = _cdiv(SMS, n_tiles)            # splits for one CTA an SM
        steps_per = max(1, steps // want) if want < steps else 1
        split = _cdiv(steps, steps_per)
        cfg = MvmConfig("gemm", bm, bn, split, steps_per, n_tiles * split,
                        STAGES * (bm * (BK + 16) + BK * (bn + 16)))
        if cfg.ctas >= SMS:
            return cfg
        if best is None or cfg.ctas > best.ctas:
            best = cfg
    return best


def mvm_int(a_codes: torch.Tensor, wq: torch.Tensor,
            ws: Optional[torch.Tensor] = None,
            act_scale: float = 1.0) -> torch.Tensor:
    """int8 codes [M, K] x int8 levels [K, N], f32 scales [N] -> f32 [M, N].

    ``(acc * act_scale) * ws[n]``, or ``acc * act_scale`` without ``ws``,
    bitwise equal to ``mvm_int_ref``. Any M, K, N: the kernel masks the
    ragged edges itself, so nothing is padded.

    One call counts one launch on ``LAUNCHES``, also where a split-K
    config runs a second pass (``mvm_reduce_kernel``) to add the splits.
    """
    if a_codes.ndim != 2 or wq.ndim != 2 or a_codes.shape[1] != wq.shape[0]:
        raise ValueError(f"mvm_int: shapes {tuple(a_codes.shape)} x "
                         f"{tuple(wq.shape)} do not chain")
    m, k = a_codes.shape
    n = wq.shape[1]
    if ws is not None and ws.numel() != n:
        raise ValueError(f"mvm_int: ws has {ws.numel()} scales for N={n}")
    if not a_codes.is_cuda:
        return mvm_int_ref(a_codes, wq, ws, act_scale)
    for t in (wq, ws):
        if t is not None and t.device != a_codes.device:
            raise ValueError(f"mvm_int: operands on {a_codes.device} and "
                             f"{t.device}")
    if a_codes.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"mvm_int: the kernel takes int8 operands, got "
                        f"{a_codes.dtype} and {wq.dtype}")
    a = a_codes.contiguous()
    w = wq.contiguous()
    s = None if ws is None else ws.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    cfg = mvm_config(m, k, n)
    part = None if cfg.split == 1 else torch.empty(
        (cfg.split, m, n), dtype=torch.int32, device=a.device)
    lib = _build.library("photonic_mvm", _SIGNATURES)
    err = lib.mvm_int_launch(
        a.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
        float(act_scale), out.data_ptr(),
        None if part is None else part.data_ptr(), m, n, k,
        _ROUTES[cfg.route], cfg.bm, cfg.bn, cfg.split, cfg.steps_per,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "photonic_mvm")
    LAUNCHES.inc()
    return out


def photonic_mvm_prequant(a_signed_codes: torch.Tensor, wq: torch.Tensor,
                          ws: torch.Tensor, act_scale: float = 1.0
                          ) -> torch.Tensor:
    """Already-quantized operands (int8 carriers) -> dequantized output.

    a_signed_codes [..., K] int8 in [-15, 15]; wq [K, N] int8; ws [N].
    """
    *lead, kdim = a_signed_codes.shape
    n = wq.shape[-1]
    out = mvm_int(a_signed_codes.reshape(-1, kdim), wq, ws.reshape(-1),
                  act_scale)
    return out.reshape(*lead, n)


def photonic_mvm(x: torch.Tensor, w: torch.Tensor, spec: WASpec,
                 act_scale: float = 1.0 / 15.0) -> torch.Tensor:
    """Float API: x [..., K] @ w [K, N] under [W:A] ``spec``.

    Quantizes both operands as the sensor and the MRs would, then runs the
    integer kernel: bitwise equal to ``ref.photonic_mvm_ref``.
    """
    *lead, kdim = x.shape
    wq, ws = quantize_weight(w, spec)
    y = photonic_mvm_prequant(signed_codes(x.reshape(-1, kdim), spec,
                                           act_scale), wq, ws, act_scale)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)
