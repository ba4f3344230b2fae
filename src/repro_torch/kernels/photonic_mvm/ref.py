"""Plain PyTorch version of the photonic MVM kernel.

The integer semantics of the optical core: CRC-coded activations x MR-held
signed weight levels, an exact integer accumulate, then the dequant
``(acc * act_scale) * ws[n]`` in that association. :func:`photonic_mvm_ref`
is the float-in / float-out oracle around it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import WASpec, _clip, quantize_weight, true_div


def mvm_int_ref(a_codes: torch.Tensor, wq: torch.Tensor,
                ws: Optional[torch.Tensor] = None,
                act_scale: float = 1.0) -> torch.Tensor:
    """a_codes [M, K] x wq [K, N] integer levels, ws [N] -> f32 [M, N];
    without ``ws``, ``acc * act_scale``.

    The accumulate is a float64 product of the integer operands: exact while
    |acc| < 2^53, and PyTorch has no integer matmul on CUDA. Its cast to
    float32 rounds to nearest like the reference's int32 -> f32 cast.
    """
    acc = torch.matmul(a_codes.double(), wq.double()).float() * act_scale
    return acc if ws is None else acc * ws.reshape(1, -1).float()


def signed_codes(x: torch.Tensor, spec: WASpec, act_scale) -> torch.Tensor:
    """Float activations [M, K] -> signed CRC codes, int8 in
    [-a_qmax, a_qmax]: the magnitude is CRC-quantized and the sign carried
    on the second rail (the BPD's differential read)."""
    xf = x.float()
    codes = _clip(torch.round(true_div(xf.abs(), act_scale)), 0,
                  spec.a_qmax)
    return (torch.sign(xf) * codes).to(torch.int8)


def photonic_mvm_ref(x: torch.Tensor, w: torch.Tensor, spec: WASpec,
                     act_scale: float = 1.0 / 15.0) -> torch.Tensor:
    """Float-in/float-out oracle incl. quantization of both operands:
    x [..., K] @ w [K, N] under ``spec``, the same semantics as
    ``nn.layers.dense(mode="fake")`` at inference."""
    *lead, kdim = x.shape
    wq, ws = quantize_weight(w, spec)
    y = mvm_int_ref(signed_codes(x.reshape(-1, kdim), spec, act_scale), wq,
                    ws, act_scale)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)
