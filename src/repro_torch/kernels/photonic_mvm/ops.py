"""Wrapper of the photonic MVM kernel (``csrc/photonic_mvm.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``ref.mvm_int_ref``). There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref

LAUNCHES = _build.LaunchCounter("photonic_mvm")
_SIGNATURES = {"mvm_int_launch": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)}


def mvm_int(a_codes: torch.Tensor, wq: torch.Tensor,
            ws: Optional[torch.Tensor] = None,
            act_scale: float = 1.0) -> torch.Tensor:
    """int8 codes [M, K] x int8 levels [K, N], f32 scales [N] -> f32 [M, N].

    ``(acc * act_scale) * ws[n]``, or ``acc * act_scale`` without ``ws``,
    bitwise equal to ``mvm_int_ref``. Any M, K, N: the kernel masks the
    ragged edges itself, so nothing is padded.
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
    lib = _build.library("photonic_mvm", _SIGNATURES)
    err = lib.mvm_int_launch(
        a.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
        float(act_scale),
        out.data_ptr(), m, n, k, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "photonic_mvm")
    LAUNCHES.inc()
    return out
