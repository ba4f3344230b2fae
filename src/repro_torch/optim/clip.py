"""Gradient utilities over nested dicts of tensors."""

from __future__ import annotations

from typing import Callable, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


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
