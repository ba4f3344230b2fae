"""Rematerialization (activation checkpointing): the counterpart of
``jax.checkpoint`` and its ``dots`` policy, for one layer at a time.

    y = remat(fn, *args, policy="full")

``"full"`` keeps only ``fn``'s inputs and runs ``fn`` again in the
backward pass; ``"dots"`` keeps the matmul outputs (``aten.mm``,
``aten.bmm``, ``aten.addmm``) and recomputes the rest; ``"none"``, and any
call with autograd off, is ``fn(*args)``. Both are
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
second with a selective-checkpoint policy. The recompute runs the same ops
on the same inputs, so the gradients are bitwise those without remat.

Random draws: ``checkpoint``'s ``preserve_rng_state`` restores the default
CPU and CUDA generators only. A ``torch.Generator`` of the caller's,
passed in ``generators``, has its state taken before the first call; the
recompute sets it back to that state (so it draws the same numbers as the
forward did) and afterwards returns it to the state it had before the
recompute, so the draws of later layers and steps are not disturbed.

Every recompute adds one to the ``obs`` counter ``remat.recompute``: a
full-remat train step of an L-layer model adds L.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import obs

POLICIES = ("none", "full", "dots")
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
        torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, *args, policy: str = "full",
          generators: Sequence[torch.Generator] = ()):
    """``fn(*args)`` under ``policy`` (``POLICIES``)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    saved = [g.get_state() for g in generators]
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] > 1:
            obs.counter("remat.recompute").inc()
        if calls[0] == 1 or not generators:
            return fn(*a)
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, saved):
            g.set_state(s)
        try:
            return fn(*a)
        finally:
            for g, s in zip(generators, now):
                g.set_state(s)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return checkpoint(run, *args, use_reentrant=False, **kw)
