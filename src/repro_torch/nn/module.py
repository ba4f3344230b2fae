"""Param-tree utilities and initializers for the pure-functional substrate.

Each initializer returns ``init(generator, shape, dtype)`` and draws on the
generator's device: the reference's take a ``jax.random`` key, the port's
a ``torch.Generator``, so the same seed gives other numbers. To drive both
packages with one set of weights, make them with numpy
(``repro_torch.weights``). :class:`KeyGen` hands out generators split
deterministically from one seed, as the reference's splits keys.

Trees are nested dicts of tensors. :func:`tree_flatten_with_paths` walks
dict keys in sorted order, the order ``jax.tree_util`` flattens a dict in.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(stddev: float = 0.02):
    def init(generator: torch.Generator, shape, dtype=torch.float32):
        return stddev * torch.randn(shape, generator=generator, dtype=dtype,
                                    device=generator.device)
    return init


def scaled_init(fan_in: int):
    """1/sqrt(fan_in) — the default for projection matrices."""
    return normal_init(1.0 / math.sqrt(max(fan_in, 1)))


def zeros_init():
    def init(generator: torch.Generator, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=generator.device)
    return init


def ones_init():
    def init(generator: torch.Generator, shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=generator.device)
    return init


# ---------------------------------------------------------------------------
# Generator management
# ---------------------------------------------------------------------------

class KeyGen:
    """Deterministic generator splitter: ``kg = KeyGen(seed, device)``;
    ``g = kg()`` is a fresh ``torch.Generator`` on ``device``.

    ``seed`` is an int or a ``torch.Generator``, from which one 62-bit seed
    is drawn (a generator on the card costs one host read, here only). The
    children's seeds come from ``numpy.random.SeedSequence(seed)``, so a
    seed gives the same sequence of generators on every run and device.
    The draw is a real tensor even under ``FakeTensorMode`` (the dry run
    and ``launch.specs.params_shape`` build fake params with it).
    """

    def __init__(self, seed, device="cpu"):
        if isinstance(seed, torch.Generator):
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                seed = int(torch.randint(0, 1 << 62, (1,), generator=seed,
                                         device=seed.device).item())
        self._seq = np.random.SeedSequence(int(seed))
        self.device = torch.device(device)

    def __call__(self) -> torch.Generator:
        child, = self._seq.spawn(1)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
        return g


# ---------------------------------------------------------------------------
# Tree utilities (nested dicts of tensors)
# ---------------------------------------------------------------------------

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


def tree_size(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_flatten_with_paths(tree, prefix: str = ""
                            ) -> Iterable[Tuple[str, torch.Tensor]]:
    """``("a/b/c", leaf)`` for every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_paths(
                tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def stack_layer_params(layer_params: list):
    """Stack per-layer param trees along a new leading 'layers' axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), layer_params[0],
                    *layer_params[1:])


def cast_tree(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
