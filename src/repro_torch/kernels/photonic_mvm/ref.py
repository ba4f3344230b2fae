"""Plain PyTorch version of the photonic MVM kernel.

The integer semantics of the optical core: CRC-coded activations x MR-held
signed weight levels, an exact integer accumulate, then the dequant
``(acc * act_scale) * ws[n]`` in that association.
"""

from __future__ import annotations

from typing import Optional

import torch


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
