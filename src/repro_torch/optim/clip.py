"""Gradient utilities over nested dicts of tensors."""

from __future__ import annotations

import torch

from repro_torch.nn.module import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-12))``, the division IEEE (not a
    reciprocal multiply)."""
    floor = torch.full((), 1e-12, dtype=norm.dtype, device=norm.device)
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    return torch.minimum(one, torch.div(torch.full_like(one, max_norm),
                                        torch.maximum(norm, floor)))


def clip_by_global_norm(tree, max_norm: float):
    """-> (tree scaled to a global norm of at most ``max_norm``, its norm
    before)."""
    g = global_norm(tree)
    scale = clip_scale(g, max_norm)
    return tree_map(lambda x: x * scale, tree), g
