"""What a configuration file becomes in a run: the program's layer IR,
the weights and the frames, all from ``--seed``.

The weights are drawn on the run's device by one ``torch.Generator``, in
two calls (every weight, then every bias), then scaled a layer at a time
to N(0, 1/fan_in); the frames follow from the same generator. The program
under test and the plain reference get the same float tensors; each
quantizes them for itself.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def torch_seed(seed: int) -> int:
    """``--seed`` (any whole number, negative or past 64 bits) mixed into
    32 bits: the CPU generator keeps only a seed's low 32 bits, so seeds
    that differ only above them would draw alike there."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % (1 << 64)
    return (x >> 32) ^ (x & 0xFFFFFFFF)


def weight_shapes(layers: List[Dict]) -> List[Tuple[str, tuple, int, int]]:
    """(name, weight shape, fan_in, outputs) of each conv (HWIO) and dense
    ([K, N]) layer, in order."""
    out = []
    for layer in layers:
        if layer["kind"] == "conv":
            k = layer["kernel"]
            out.append((layer["name"], (k, k, layer["c_in"], layer["c_out"]),
                        k * k * layer["c_in"], layer["c_out"]))
        elif layer["kind"] == "dense":
            out.append((layer["name"], (layer["fan_in"], layer["fan_out"]),
                        layer["fan_in"], layer["fan_out"]))
    return out


def make_weights(cfg: Dict, gen: torch.Generator,
                 device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{layer: {"w", "b"}} float32 on ``device``: N(0, 1/fan_in) weights and
    N(0, bias_std^2) biases."""
    shapes = weight_shapes(cfg["layers"])
    n_w = sum(math.prod(s) for _, s, _, _ in shapes)
    n_b = sum(n for _, _, _, n in shapes)
    w_all = torch.randn(n_w, generator=gen, device=device)
    b_all = torch.randn(n_b, generator=gen, device=device)
    b_all.mul_(float(cfg["bias_std"]))
    params, ow, ob = {}, 0, 0
    for name, shape, fan_in, n_out in shapes:
        size = math.prod(shape)
        w = w_all[ow:ow + size].view(shape)
        w.mul_(1.0 / math.sqrt(fan_in))
        params[name] = {"w": w, "b": b_all[ob:ob + n_out]}
        ow, ob = ow + size, ob + n_out
    return params


def program_layers(cfg: Dict) -> tuple:
    """The configuration's layers as the program's layer IR."""
    from repro_torch.core.accelerator import (CASpec, ConvSpec, DenseSpec,
                                              FlattenSpec)
    out = []
    for layer in cfg["layers"]:
        kind = layer["kind"]
        if kind == "ca":
            out.append(CASpec(pool=layer["pool"],
                              rgb_to_gray=layer["rgb_to_gray"]))
        elif kind == "conv":
            pool = layer.get("pool")
            out.append(ConvSpec(layer["name"], layer["c_in"], layer["c_out"],
                                kernel=layer["kernel"],
                                stride=layer["stride"],
                                padding=layer["padding"], act=layer["act"],
                                pool=tuple(pool) if pool else None))
        elif kind == "flatten":
            out.append(FlattenSpec())
        elif kind == "dense":
            out.append(DenseSpec(layer["name"], layer["fan_in"],
                                 layer["fan_out"], act=layer["act"]))
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return tuple(out)


def make_program(cfg: Dict, params: Dict):
    from repro_torch import Program
    return Program(program_layers(cfg), params, tuple(cfg["input_hwc"]),
                   name=cfg["model"])


def make_frames(cfg: Dict, n: int, gen: torch.Generator,
                device: torch.device) -> np.ndarray:
    """``n`` request inputs in host memory, float32 in [0, 1): for
    ``"uniform"`` frames [n, H, W, C]; for ``"tiles"`` [n, T, h, w, C], the
    16 x 16 (or whatever fits) tiling of ``frame_hw`` frames into the
    configuration's input. Every ``dim_every``-th frame is scaled by
    ``dim``."""
    spec = cfg["frames"]
    h, w, c = cfg["input_hwc"]
    if spec["kind"] == "uniform":
        x = torch.rand((n, h, w, c), generator=gen, device=device)
        x[::spec["dim_every"]] *= spec["dim"]
        return x.cpu().numpy()
    if spec["kind"] == "tiles":
        fh, fw = spec["frame_hw"]
        if fh % h or fw % w:
            raise ValueError(f"{fh}x{fw} frames do not tile by {h}x{w}")
        x = torch.rand((n, fh, fw, c), generator=gen, device=device)
        x[::spec["dim_every"]] *= spec["dim"]
        x = x.reshape(n, fh // h, h, fw // w, w, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, (fh // h) * (fw // w), h, w, c).contiguous() \
            .cpu().numpy()
    raise ValueError(f"unknown frames kind {spec['kind']!r}")
