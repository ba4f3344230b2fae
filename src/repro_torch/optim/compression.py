"""Gradient compression for the cross-pod all-reduce: int8 block-quantized
gradients with error feedback.

The reference package's ``optim/compression.py`` on ``torch.distributed``.
Before the data-parallel all-reduce each leaf is quantized to int8 with
one float32 scale per block of 256; the quantization residual is carried
to the next step (error feedback keeps the update unbiased over time).
At 512 GPUs the pod-crossing gradient traffic drops ~4x against float32.

``compress_int8`` is bitwise the reference's: ``max|x| / 127`` and
``blocks / scales`` are IEEE divisions (``quant.true_div``; PyTorch would
multiply by the reciprocal of a host scalar) and ``torch.round`` rounds
half to even, as ``jnp.round`` does. ``compressed_allreduce_update``
replaces the reference's ``pmean`` over a named axis (inside
``shard_map``) with ``all_reduce(SUM)`` over a process group divided by
its size.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import _clip, true_div
from repro_torch.nn.module import tree_map

BLOCK = 256


def compress_int8(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (codes int8 [N], scales float32 [ceil(N/block)]). Flattens x."""
    flat = x.reshape(-1).float()
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scales = true_div(blocks.abs().amax(dim=1, keepdim=True), 127.0)
    scales = torch.maximum(scales, torch.full((), 1e-12, dtype=torch.float32,
                                              device=x.device))
    codes = _clip(torch.round(true_div(blocks, scales)), -127, 127)
    return codes.to(torch.int8).reshape(-1), scales[:, 0]


def decompress_int8(codes: torch.Tensor, scales: torch.Tensor, shape,
                    block: int = BLOCK) -> torch.Tensor:
    blocks = codes.reshape(-1, block).float() * scales[:, None]
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(tuple(shape))


def compressed_allreduce_update(grads, error_state, group=None,
                                block: int = BLOCK):
    """Error-feedback int8 all-reduce over ``group`` (default: the world).

    Each rank quantizes ``grad + error``, keeps the residual as its new
    error, and the dequantized leaves are summed over the group and
    divided by its size. Returns (averaged_grads, new_error_state)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def one(g, e):
        g_comp = g.float() + e
        codes, scales = compress_int8(g_comp, block)
        deq = decompress_int8(codes, scales, g.shape, block)
        total = deq.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return true_div(total, n), g_comp - deq

    out = tree_map(one, grads, error_state)        # (avg, error) leaves
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

