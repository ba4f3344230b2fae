"""Fixed-function optical image-processing pipelines (the paper's
"versatile image processing" claim, as executable programs).

Each pipeline is a small program in the layer IR the CNNs use
(``CASpec``/``ConvSpec``/``UpsampleSpec``), so it compiles through the plan
runtime, runs batch-first through the kernel dispatch under any [W:A]
scheme and gets a power/latency report from the same architecture model.
The filter weights are fixed classical kernels (``imaging.filters``); the
CA gives fused RGB->gray acquisition and compressive downsampling;
``UpsampleSpec`` plus an optional learned head gives reconstruction.

    prog = PIPELINES["edge_detect"].program(256, 256, 3)
    exe = prog.compile(Options(scheme=W4A4))            # on the card
    edges = exe.run_per_frame(frames)
    ref = apply_float(prog.layers, prog.params, frames)  # float oracle
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.accelerator import CASpec, ConvSpec, UpsampleSpec
from repro_torch.imaging import filters as F


@dataclasses.dataclass(frozen=True)
class ImagingPipeline:
    """A named fixed-function program over the device layer IR.

    ``kind``: "filter" pipelines keep the input resolution; "recon"
    pipelines compressively downsample then reconstruct, so their quality
    is also measured against the original frame.
    """

    name: str
    description: str
    kind: str                     # "filter" | "recon"
    builder: Callable[[int, int, int], Tuple[tuple, Dict]]

    def build(self, h: int, w: int, c: int) -> Tuple[tuple, Dict]:
        """-> (layer IR tuple, fixed params) for [h, w, c] input frames."""
        if c not in (1, 3):
            raise ValueError(f"{self.name}: input channels must be 1 (gray) "
                             f"or 3 (RGB), got {c}")
        layers, params = self.builder(h, w, c)
        return tuple(layers), params

    def program(self, h: int, w: int, c: int = 3):
        """The pipeline as a ``repro_torch.Program`` for [h, w, c] frames."""
        from repro_torch.core.program import Program
        layers, params = self.build(h, w, c)
        return Program(layers, params, (h, w, c), name=self.name)


def _gray_front(c: int):
    """Fused RGB->gray acquisition (pool=1: conversion without downsample)."""
    return [CASpec(pool=1, rgb_to_gray=True)] if c == 3 else []


def _w(arr: np.ndarray) -> Dict[str, torch.Tensor]:
    return {"w": torch.from_numpy(np.asarray(arr, np.float32))}


# -- filter pipelines -------------------------------------------------------

def _edge_builder(kx: np.ndarray, ky: np.ndarray):
    def build(h, w, c):
        layers = _gray_front(c) + [
            # two gradient kernels on the OC banks, magnitude readout
            ConvSpec("grad", 1, 2, kernel=3, act="abs"),
            # |Gx| + |Gy| as a 1x1 combine conv (L1 gradient magnitude)
            ConvSpec("edge_mag", 2, 1, kernel=1, act="none"),
        ]
        params = {"grad": _w(F.edge_pair_weights(kx, ky)),
                  "edge_mag": _w(np.ones((1, 1, 2, 1), np.float32))}
        return layers, params
    return build


def _single_filter_builder(name: str, kernel_fn):
    def build(h, w, c):
        k = kernel_fn()
        layers = _gray_front(c) + [
            ConvSpec(name, 1, 1, kernel=k.shape[0], act="none"),
        ]
        return layers, {name: _w(F.single_filter_weights(k))}
    return build


def _depthwise_filter_builder(name: str, kernel_fn):
    def build(h, w, c):
        k = kernel_fn()
        layers = [ConvSpec(name, c, c, kernel=k.shape[0], act="none",
                           depthwise=True)]
        return layers, {name: _w(F.depthwise_weights(k, c))}
    return build


# -- compression / reconstruction pipelines ---------------------------------

def _check_compress_dims(h: int, w: int, pool: int):
    if h % pool or w % pool:
        raise ValueError(f"compressive pool={pool} does not divide "
                         f"frame {h}x{w}")


def _compress_recon_builder(pool: int = 2):
    def build(h, w, c):
        _check_compress_dims(h, w, pool)
        layers = [CASpec(pool=pool, rgb_to_gray=(c == 3)),
                  UpsampleSpec(factor=pool, method="bilinear")]
        return layers, {}
    return build


def recon_head_identity_params() -> Dict[str, Dict[str, torch.Tensor]]:
    """Identity-initialized learned head: rec2(relu(rec1(x))) == x.

    rec1 lifts to 4 channels with a centre-tap delta in channel 0; rec2
    projects channel 0 back. Upsampled intensities are non-negative, so the
    relu is transparent at init.
    """
    w1 = np.zeros((3, 3, 1, 4), np.float32)
    w1[1, 1, 0, 0] = 1.0
    w2 = np.zeros((3, 3, 4, 1), np.float32)
    w2[1, 1, 0, 0] = 1.0
    return {"rec1": _w(w1), "rec2": _w(w2)}


def _compress_recon_deconv_builder(pool: int = 2):
    def build(h, w, c):
        _check_compress_dims(h, w, pool)
        layers = [CASpec(pool=pool, rgb_to_gray=(c == 3)),
                  UpsampleSpec(factor=pool, method="bilinear"),
                  ConvSpec("rec1", 1, 4, kernel=3, act="relu"),
                  ConvSpec("rec2", 4, 1, kernel=3, act="none")]
        return layers, recon_head_identity_params()
    return build


def gray_target(frames) -> torch.Tensor:
    """The reconstruction target: the full-resolution grayscale frame."""
    from repro_torch.core.compressive import compressive_acquire
    x = frames if isinstance(frames, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(frames, np.float32))
    if x.shape[-1] == 3:
        return compressive_acquire(x, 1, True)[..., None]
    return x


def fit_recon_head(layers, params, frames, steps: int = 150,
                   lr: float = 0.3, momentum: float = 0.9,
                   device=None) -> Dict:
    """Train the deconv head (rec1/rec2) to reconstruct ``frames``.

    Minimizes the MSE against the grayscale original through the float
    oracle ``apply_float`` (CA -> bilinear -> head) with autograd and plain
    SGD with momentum. The CA and the upsample have no parameters and the
    frames carry no gradient, so the backward stops at the head.

    Args:
        layers: the ``compress_recon_deconv`` layer IR (convs named
            ``rec1`` / ``rec2``).
        params: the pipeline params; only the head entries are updated.
        frames: ``[B, H, W, C]`` training frames in [0, 1] (numpy or a
            tensor).
        steps / lr / momentum: the SGD schedule.
        device: where to train; ``None`` is the frames' device for a
            tensor and ``cuda`` for numpy frames (raises without a GPU).

    Returns:
        A new params dict with the fitted head on ``device`` (the inputs are
        not mutated).
    """
    from repro_torch.core.program import resolve_device
    from repro_torch.imaging.reference import apply_float
    if device is None:
        device = frames.device if isinstance(frames, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    x = frames.to(dev, torch.float32) if isinstance(frames, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(dev)
    target = gray_target(x)
    head = {k: {kk: torch.as_tensor(v).to(dev, torch.float32).detach()
                .clone().requires_grad_()
                for kk, v in params[k].items()}
            for k in ("rec1", "rec2")}
    frozen = {k: v for k, v in params.items() if k not in head}
    leaves = [t for p in head.values() for t in p.values()]
    vel = [torch.zeros_like(t) for t in leaves]
    for _ in range(steps):
        out = apply_float(layers, {**frozen, **head}, x)
        loss = torch.mean((out - target) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for i, (t, g) in enumerate(zip(leaves, grads)):
                vel[i] = momentum * vel[i] - lr * g
                t.add_(vel[i])
    return {**frozen, **{k: {kk: t.detach() for kk, t in p.items()}
                         for k, p in head.items()}}


# -- registry ---------------------------------------------------------------

#: Every fixed-function imaging program, keyed by name:
#: ``PIPELINES[name].program(h, w, c)`` is a ``Program`` like any model's.
PIPELINES: Dict[str, ImagingPipeline] = {
    p.name: p for p in [
        ImagingPipeline(
            "edge_detect", "Sobel gradient magnitude (|Gx| + |Gy|)",
            "filter", _edge_builder(F.SOBEL_X, F.SOBEL_Y)),
        ImagingPipeline(
            "prewitt_edge", "Prewitt gradient magnitude",
            "filter", _edge_builder(F.PREWITT_X, F.PREWITT_Y)),
        ImagingPipeline(
            "sharpen", "Laplacian sharpen (identity - laplacian)",
            "filter", _single_filter_builder(
                "sharpen", lambda: F.SHARPEN)),
        ImagingPipeline(
            "unsharp_mask", "5x5 unsharp mask (amount=0.7, sigma=1.0)",
            "filter", _single_filter_builder(
                "unsharp", lambda: F.unsharp_kernel(0.7, 5, 1.0))),
        ImagingPipeline(
            "denoise_gauss", "depthwise 5x5 Gaussian denoise (sigma=1.0)",
            "filter", _depthwise_filter_builder(
                "gauss", lambda: F.gaussian_kernel(5, 1.0))),
        ImagingPipeline(
            "denoise_box", "depthwise 3x3 box denoise",
            "filter", _depthwise_filter_builder(
                "box", lambda: F.box_kernel(3))),
        ImagingPipeline(
            "compress_recon", "2x2 CA compressive downsample + bilinear "
            "reconstruction", "recon", _compress_recon_builder(2)),
        ImagingPipeline(
            "compress_recon_deconv", "2x2 CA compression + bilinear + "
            "learned deconv head", "recon", _compress_recon_deconv_builder(2)),
    ]
}
