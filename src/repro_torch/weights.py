"""Weights across the two packages.

The reference package's params are a ``{layer: {"w": ..., "b": ...}}``
tree of arrays; made with numpy (or converted to it), the same tree drives
both packages, which is how the port is held against the reference.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_numpy(params: Mapping[str, Mapping[str, object]],
                      device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {"w", "b"}}`` of numpy arrays -> the same tree of float32
    tensors on ``device``, in the same layouts (HWIO conv weights, [K, N]
    dense weights). The arrays are copied, never aliased."""
    return {layer: {k: torch.tensor(np.asarray(v, np.float32),
                                    device=device)
                    for k, v in p.items()}
            for layer, p in params.items()}
