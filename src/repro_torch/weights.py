"""Weights across the two packages.

The reference package's vision params are a ``{layer: {"w": ..., "b":
...}}`` tree of arrays, its LM params a nested, stacked tree; made with
numpy (or converted to it), the same tree drives both packages, which is
how the port is held against the reference.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# leaves the reference keeps in float32 whatever cfg.dtype (the SSM's
# electronic parameters, the MoE router, and the MR scales of
# quantize_lm_params)
FLOAT32_LEAVES = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "router",
                  "ws")


def params_from_numpy(params: Mapping[str, Mapping[str, object]],
                      device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {"w", "b"}}`` of numpy arrays -> the same tree of float32
    tensors on ``device``, in the same layouts (HWIO conv weights, [K, N]
    dense weights). The arrays are copied, never aliased."""
    return {layer: {k: torch.tensor(np.asarray(v, np.float32),
                                    device=device)
                    for k, v in p.items()}
            for layer, p in params.items()}


def params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """The reverse of :func:`params_from_numpy`: ``{layer: {"w", "b"}}``
    of tensors on any device -> float32 numpy arrays (copies, detached
    from autograd), e.g. trained weights for the reference package."""
    return {layer: {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
                    .numpy().copy()
                    for k, v in p.items()}
            for layer, p in params.items()}


def lm_params_from_numpy(tree, device, cfg):
    """A nested LM param tree of numpy arrays (the reference's, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors on
    ``device``, copied. Float leaves go to ``cfg.dtype``, except those the
    reference keeps in float32 whatever the dtype (``FLOAT32_LEAVES``:
    the SSM's conv/dt/A/D params, the MoE router and the MR scales
    ``ws``); the MoE's stacked experts keep their [L, E, d, f] layout, raw
    or as storage dicts; bfloat16
    arrays arrive exactly. Integer carriers go to int8, the reference's
    ``int4`` carriers included (the same values, a byte each)."""
    dtype = cfg.torch_dtype

    def walk(node, name):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype.kind in "iu" or a.dtype.name.startswith(("int", "uint")):
            return torch.tensor(a.astype(np.int8), device=device)
        t = torch.tensor(np.asarray(a, np.float32), device=device)
        return t if name in FLOAT32_LEAVES else t.to(dtype)

    return walk(tree, "")


def lm_params_to_numpy(tree):
    """The reverse of :func:`lm_params_from_numpy`: a nested tree of
    tensors on any device -> numpy copies, float leaves as float32 (numpy
    has no bfloat16; the values are exact), integer leaves as they are."""
    if isinstance(tree, Mapping):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    t = torch.as_tensor(tree).detach().to("cpu")
    return (t.float() if t.is_floating_point() else t).numpy().copy()
