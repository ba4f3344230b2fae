"""Deterministic procedural images, with numpy from a seed: stand-ins for
MNIST and CIFAR, which are not downloaded.

  * ``synthetic_digits``   — 28x28 seven-segment "digit" glyphs with jitter
    and noise, 10 classes (LeNet's input);
  * ``synthetic_textures`` — k-class oriented sinusoid textures in RGB
    (VGG9's input, and the imaging pipelines' test frames).

A copy of the reference package's generators: the same seed gives the
same arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_SEGS = {  # 7-segment truth table
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcfgd",
}


def _render_digit(d: int, rng: np.random.Generator, hw: int = 28
                  ) -> np.ndarray:
    img = np.zeros((hw, hw), np.float32)
    x0, y0 = hw // 4 + rng.integers(-2, 3), hw // 6 + rng.integers(-2, 3)
    w, h = hw // 2, int(hw * 0.66)
    t = max(hw // 14, 2)
    seg = _SEGS[d]

    def bar(x, y, dx, dy):
        img[max(y, 0):min(y + dy, hw), max(x, 0):min(x + dx, hw)] = 1.0

    bars = {"a": (x0, y0, w, t),
            "b": (x0 + w - t, y0, t, h // 2),
            "c": (x0 + w - t, y0 + h // 2, t, h // 2),
            "d": (x0, y0 + h - t, w, t),
            "e": (x0, y0 + h // 2, t, h // 2),
            "f": (x0, y0, t, h // 2),
            "g": (x0, y0 + h // 2 - t // 2, w, t)}
    for name in "abcdefg":
        if name in seg:
            bar(*bars[name])
    img += 0.12 * rng.standard_normal((hw, hw)).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def synthetic_digits(n: int, seed: int = 0, hw: int = 28
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images [n, hw, hw, 1] in [0, 1], labels [n])."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    imgs = np.stack([_render_digit(int(d), rng, hw) for d in labels])
    return imgs[..., None].astype(np.float32), labels.astype(np.int32)


def synthetic_textures(n: int, n_classes: int = 10, seed: int = 0,
                       hw: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images [n, hw, hw, 3] in [0, 1], labels [n]): oriented
    sinusoid textures, one orientation and frequency per class."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    imgs = np.zeros((n, hw, hw, 3), np.float32)
    for i, c in enumerate(labels):
        theta = np.pi * c / n_classes
        freq = 3.0 + (c % 3) * 2.0
        phase = rng.uniform(0, 2 * np.pi)
        base = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta))
            + phase)
        color = 0.3 + 0.7 * rng.random(3).astype(np.float32)
        imgs[i] = base[..., None] * color[None, None, :]
    imgs += 0.08 * rng.standard_normal(imgs.shape).astype(np.float32)
    return np.clip(imgs, 0, 1), labels.astype(np.int32)
