"""Plain version of the plan executor's fused epilogue
(``csrc/epilogue.cu``): the torch-op sequence ``core.plan._execute_steps``
ran at each requant before the kernel existed, op for op.

    y = x * (act_scale * ws)       (x * act_scale without ws; x as it is
                                    without act_scale)
    y = y + bias                   (where there is one)
    y = act(y), pool(y)            (``_activation``, ``_pool``)
    codes, scale = _crc_requant(y) (per frame, or one max over the batch
                                    through ``reduce_max``)
    codes -> the next int8 conv's operand (``strip.int_codes``: uint8, its
                                    border and zero channels), where asked

The reference backend and the CPU run it; on the card the kernel backend
runs the kernel and never this.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.accelerator import _activation, _crc_requant, _pool


def epilogue_ref(x: torch.Tensor, act_scale: Optional[torch.Tensor] = None,
                 ws: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None, act: str = "none",
                 pool: Optional[Tuple[str, int]] = None, a_qmax=None,
                 per_frame: bool = False, reduce_max=None,
                 operand=None):
    """-> ``(codes, scale)`` as ``_crc_requant`` returns them, the codes as
    the uint8 operand of a k x k conv padded by ``pads`` where ``operand``
    is ``(k, pads)``. ``ws`` broadcasts over the last axis of ``x``."""
    y = x
    if act_scale is not None:
        if ws is not None:
            act_scale = act_scale * ws.reshape((1,) * (x.ndim - 1) + (-1,))
        y = x * act_scale
    if bias is not None:
        y = y + bias
    y = _activation(y, act)
    if pool is not None:
        y = _pool(y, *pool)
    codes, scale = _crc_requant(y, a_qmax, per_frame, reduce_max)
    if operand is not None:
        from repro_torch.kernels.conv_bank.strip import int_codes
        codes = int_codes(codes, *operand)
    return codes, scale
