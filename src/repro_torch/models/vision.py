"""The paper's own CNNs as Lightator layer IR, with seeded random weights
and their trainable QAT forward.

LeNet (MNIST) and VGG9 (CIFAR10/100) are the paper's evaluation models;
VGG16 and AlexNet appear in its execution-time comparison. The IRs are the
reference package's, layer for layer; ``init_vision`` draws weights with
the same shapes and fan-in scaling as the reference's initializers, from a
``torch.Generator`` (the numbers differ from ``jax.random``'s: to drive
both packages with one set of weights, make them with numpy and pass them
through ``repro_torch.weights.params_from_numpy``). ``apply_vision`` is the
quantization-aware forward over the same IR (``nn.layers`` fake-quant
convs and denses, STE), differentiable with autograd.
``vision_schedules`` maps an IR onto the optical core's schedules, what
the power model's reports (the paper's FPS/W figures) are made of.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from repro_torch.core import optical_core as ocore
from repro_torch.core.accelerator import (CASpec, ConvSpec, DenseSpec,
                                          FlattenSpec, LayerIR)
from repro_torch.core.compressive import compressive_acquire
from repro_torch.core.quant import (MixedPrecisionScheme, WASpec,
                                    resolve_layer_specs)
from repro_torch.core.plan import conv_out_hw
from repro_torch.kernels.conv_bank.ref import float32_convs
from repro_torch.nn import layers as L


def lenet_ir(in_hw: int = 28, n_classes: int = 10,
             use_ca: bool = False) -> List[LayerIR]:
    """LeNet-5 flavored for 28x28 grayscale (paper: MNIST on LeNET)."""
    layers: List[LayerIR] = []
    hw = in_hw
    if use_ca:
        layers.append(CASpec(pool=2, rgb_to_gray=False))
        hw //= 2
    layers += [
        ConvSpec("conv1", 1, 6, kernel=5, padding="SAME", pool=("avg", 2)),
        ConvSpec("conv2", 6, 16, kernel=5, padding="VALID", pool=("avg", 2)),
        FlattenSpec(),
    ]
    hw = hw // 2                    # conv1 pool
    hw = (hw - 4) // 2              # conv2 VALID + pool
    layers += [
        DenseSpec("fc1", 16 * hw * hw, 120),
        DenseSpec("fc2", 120, 84),
        DenseSpec("fc3", 84, n_classes, act="none"),
    ]
    return layers


def vgg9_ir(in_hw: int = 32, n_classes: int = 100,
            use_ca: bool = True) -> List[LayerIR]:
    """VGG9: 6 conv (3x3) + 3 FC — the paper's CIFAR10/100 model. With
    use_ca (the Table-1 operating point) the CA fuses RGB->gray with 2x2
    mean pooling before conv1."""
    layers: List[LayerIR] = []
    hw = in_hw
    c_in = 3
    if use_ca:
        layers.append(CASpec(pool=2, rgb_to_gray=True))
        hw //= 2
        c_in = 1
    chans = [(c_in, 64), (64, 64), (64, 128), (128, 128),
             (128, 256), (256, 256)]
    for i, (ci, co) in enumerate(chans):
        pool = ("max", 2) if i % 2 == 1 else None
        layers.append(ConvSpec(f"conv{i+1}", ci, co, kernel=3, pool=pool))
        if pool:
            hw //= 2
    layers.append(FlattenSpec())
    layers += [
        DenseSpec("fc1", 256 * hw * hw, 512),
        DenseSpec("fc2", 512, 512),
        DenseSpec("fc3", 512, n_classes, act="none"),
    ]
    return layers


def vgg16_ir(in_hw: int = 224, n_classes: int = 1000) -> List[LayerIR]:
    cfg = [(3, 64), (64, 64), "P", (64, 128), (128, 128), "P",
           (128, 256), (256, 256), (256, 256), "P",
           (256, 512), (512, 512), (512, 512), "P",
           (512, 512), (512, 512), (512, 512), "P"]
    layers: List[LayerIR] = []
    hw = in_hw
    idx = 0
    for item in cfg:
        if item == "P":
            prev = layers[-1]
            layers[-1] = ConvSpec(prev.name, prev.c_in, prev.c_out,
                                  prev.kernel, prev.stride, prev.padding,
                                  prev.act, ("max", 2))
            hw //= 2
            continue
        idx += 1
        layers.append(ConvSpec(f"conv{idx}", item[0], item[1], kernel=3))
    layers.append(FlattenSpec())
    layers += [
        DenseSpec("fc1", 512 * hw * hw, 4096),
        DenseSpec("fc2", 4096, 4096),
        DenseSpec("fc3", 4096, n_classes, act="none"),
    ]
    return layers


def alexnet_ir(in_hw: int = 227, n_classes: int = 1000) -> List[LayerIR]:
    """AlexNet (schedule-only: its 11x11/s4 conv yields odd pool inputs)."""
    return [
        ConvSpec("conv1", 3, 96, kernel=11, stride=4, padding="VALID",
                 pool=("max", 2)),
        ConvSpec("conv2", 96, 256, kernel=5, pool=("max", 2)),
        ConvSpec("conv3", 256, 384, kernel=3),
        ConvSpec("conv4", 384, 384, kernel=3),
        ConvSpec("conv5", 384, 256, kernel=3, pool=("max", 2)),
        FlattenSpec(),
        DenseSpec("fc1", 256 * 6 * 6, 4096),
        DenseSpec("fc2", 4096, 4096),
        DenseSpec("fc3", 4096, n_classes, act="none"),
    ]


VISION_MODELS = {
    "lenet": lenet_ir,
    "vgg9": vgg9_ir,
    "vgg16": vgg16_ir,
    "alexnet": alexnet_ir,
}

# Per-frame [H, W, C] each executable IR's defaults expect.
MODEL_INPUT_HWC = {
    "lenet": (28, 28, 1),
    "vgg9": (32, 32, 3),
    "vgg16": (224, 224, 3),
}


def init_vision(generator: torch.Generator,
                layers: List[LayerIR]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random params on the CPU: N(0, 1/fan_in) weights (fan_in = k*k*c_in
    for a conv, the input width for a dense layer), zero biases."""
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer in layers:
        if isinstance(layer, ConvSpec):
            k, ci = layer.kernel, (1 if layer.depthwise else layer.c_in)
            shape, fan_in = (k, k, ci, layer.c_out), k * k * layer.c_in
            n_out = layer.c_out
        elif isinstance(layer, DenseSpec):
            shape, fan_in = (layer.fan_in, layer.fan_out), layer.fan_in
            n_out = layer.fan_out
        else:
            continue
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        params[layer.name] = {
            "w": w * (1.0 / math.sqrt(max(fan_in, 1))),
            "b": torch.zeros((n_out,), dtype=torch.float32)}
    return params


def apply_vision(params, layers: List[LayerIR], x: torch.Tensor,
                 scheme: WASpec | MixedPrecisionScheme | None = None
                 ) -> torch.Tensor:
    """QAT forward: fake-quantized convs and denses (STE), float pooling,
    on NHWC frames ``x`` -> logits. TF32 is off for the call; run the
    backward inside ``float32_convs()`` too."""
    compute = [l for l in layers if isinstance(l, (ConvSpec, DenseSpec))]
    specs = (resolve_layer_specs(len(compute), scheme)
             if scheme is not None else [None] * len(compute))
    it = iter(specs)
    with float32_convs():
        for layer in layers:
            if isinstance(layer, CASpec):
                x = compressive_acquire(x, layer.pool, layer.rgb_to_gray)
                if x.ndim == 3:
                    x = x[..., None]
            elif isinstance(layer, ConvSpec):
                x = L.conv2d(params[layer.name], x, layer.stride,
                             layer.padding, quant=next(it))
                x = torch.relu(x) if layer.act == "relu" else x
                if layer.pool:
                    kind, size = layer.pool
                    x = (L.max_pool2d(x, size) if kind == "max"
                         else L.avg_pool2d(x, size))
            elif isinstance(layer, FlattenSpec):
                x = x.reshape(x.shape[0], -1)
            elif isinstance(layer, DenseSpec):
                x = L.dense(params[layer.name], x, quant=next(it))
                if layer.act == "relu":
                    x = torch.relu(x)
    return x


def vision_program(name: str, generator: Optional[torch.Generator] = None,
                   params: Optional[Dict] = None):
    """A paper CNN as a ``Program``. ``params`` reuses given weights;
    otherwise they are drawn from ``generator`` (default: seed 0)."""
    from repro_torch.core.program import Program
    if name not in MODEL_INPUT_HWC:
        raise ValueError(
            f"unknown or schedule-only model {name!r}; executable models: "
            f"{sorted(MODEL_INPUT_HWC)}")
    layers = tuple(VISION_MODELS[name]())
    if params is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = init_vision(generator, layers)
    return Program(layers, params, MODEL_INPUT_HWC[name], name=name)


def vision_schedules(layers: List[LayerIR], in_hw: int
                     ) -> List[ocore.OCSchedule]:
    """Layer IR -> OCSchedules (what the power model's reports take), in
    the reference's order: the CA, each conv with its ``.pool`` avg CA
    after it (an avg pool runs in a CA bank), each FC."""
    scheds = []
    hw = in_hw
    for layer in layers:
        if isinstance(layer, CASpec):
            hw //= layer.pool
            scheds.append(ocore.schedule_ca("CA", hw, hw, layer.pool, 3))
        elif isinstance(layer, ConvSpec):
            hw = conv_out_hw(hw, layer.kernel, layer.stride, layer.padding)
            scheds.append(ocore.schedule_conv(layer.name, hw, hw, layer.c_in,
                                              layer.c_out, layer.kernel))
            if layer.pool:
                hw //= layer.pool[1]
                if layer.pool[0] == "avg":
                    scheds.append(ocore.schedule_ca(
                        f"{layer.name}.pool", hw, hw, layer.pool[1], 1))
        elif isinstance(layer, DenseSpec):
            scheds.append(ocore.schedule_fc(layer.name, layer.fan_in,
                                            layer.fan_out))
    return scheds
