"""Float reference execution of imaging pipelines (the quality oracle).

Runs the same layer IR as ``core.plan`` but in plain float32: no CRC
activation codes, no MR weight levels and no CRC non-negativity clamp
(every inter-stage requant is max(x, 0) on the device, which this oracle
deliberately does not apply). It is never on the device path: it is what
the served answers' PSNR is measured against.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.accelerator import (CASpec, ConvSpec, DenseSpec,
                                          FlattenSpec, UpsampleSpec,
                                          _activation, _pool)
from repro_torch.core.compressive import (compressive_acquire,
                                          upsample_reconstruct)
from repro_torch.core.plan import padtype_to_pads
from repro_torch.kernels.conv_bank.ref import float32_convs


def apply_float(layers, params: Dict[str, Dict], frames) -> torch.Tensor:
    """Run an imaging/vision layer-IR program in full float32 math.

    ``frames`` [B, H, W, C] in [0, 1] (a tensor, on any device, or a numpy
    array); ``params`` per-layer ``{"w", "b"}`` keyed by layer name. Returns
    [B, H', W', C'] for spatial programs, [B, n] after a dense head. Convs
    and matmuls run in float32 with TF32 off for the call.
    """
    x = frames if isinstance(frames, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(frames, np.float32))
    x = x.float()

    def param(p, key):
        return torch.as_tensor(p[key]).to(device=x.device,
                                          dtype=torch.float32)

    with float32_convs():
        for layer in layers:
            if isinstance(layer, CASpec):
                x = compressive_acquire(x, layer.pool, layer.rgb_to_gray)
                if x.ndim == 3:
                    x = x[..., None]
            elif isinstance(layer, ConvSpec):
                p = params[layer.name]
                (plo, phi), (qlo, qhi) = padtype_to_pads(
                    x.shape[1:3], layer.kernel, layer.stride, layer.padding)
                xp = F.pad(x, (0, 0, qlo, qhi, plo, phi)).permute(0, 3, 1, 2)
                y = F.conv2d(xp, param(p, "w").permute(3, 2, 0, 1),
                             stride=layer.stride,
                             groups=layer.c_in if layer.depthwise else 1)
                y = y.permute(0, 2, 3, 1)
                if p.get("b") is not None:
                    y = y + param(p, "b")
                y = _activation(y, layer.act)
                if layer.pool is not None:
                    y = _pool(y, *layer.pool)
                x = y
            elif isinstance(layer, UpsampleSpec):
                x = upsample_reconstruct(x, layer.factor, layer.method)
            elif isinstance(layer, FlattenSpec):
                x = x.reshape(x.shape[0], -1)
            elif isinstance(layer, DenseSpec):
                p = params[layer.name]
                y = x @ param(p, "w")
                if p.get("b") is not None:
                    y = y + param(p, "b")
                x = _activation(y, layer.act)
            else:
                raise TypeError(f"unknown layer IR {layer!r}")
    return x
