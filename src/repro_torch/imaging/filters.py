"""Fixed-function filter banks for the optical imaging pipelines.

Every filter is expressed as conv weights in the device's HWIO layout
([k, k, c_in, c_out]) so it drops straight into a ``ConvSpec`` and runs on
the OC banks under the same MR weight quantization as any CNN layer. The
coefficients are the classical image-processing kernels; what the paper
adds is that they execute on the *acquisition* fabric, per [W:A] scheme.
"""

from __future__ import annotations

import numpy as np

SOBEL_X = np.array([[-1, 0, 1],
                    [-2, 0, 2],
                    [-1, 0, 1]], np.float32)
SOBEL_Y = SOBEL_X.T.copy()

PREWITT_X = np.array([[-1, 0, 1],
                      [-1, 0, 1],
                      [-1, 0, 1]], np.float32)
PREWITT_Y = PREWITT_X.T.copy()

# 4-neighbour Laplacian; sharpen = identity - laplacian
LAPLACIAN = np.array([[0, 1, 0],
                      [1, -4, 1],
                      [0, 1, 0]], np.float32)

SHARPEN = np.array([[0, -1, 0],
                    [-1, 5, -1],
                    [0, -1, 0]], np.float32)


def gaussian_kernel(size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """Normalized 2-D Gaussian, [size, size], sum == 1."""
    r = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(r ** 2) / (2.0 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def box_kernel(size: int = 3) -> np.ndarray:
    """Uniform mean filter, [size, size], sum == 1."""
    return np.full((size, size), 1.0 / (size * size), np.float32)


def unsharp_kernel(amount: float = 0.7, size: int = 5,
                   sigma: float = 1.0) -> np.ndarray:
    """Unsharp mask as ONE conv: (1 + a) * delta - a * gaussian."""
    k = -amount * gaussian_kernel(size, sigma)
    k[size // 2, size // 2] += 1.0 + amount
    return k.astype(np.float32)


def edge_pair_weights(kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Two gradient kernels as a 1-in 2-out conv weight [k, k, 1, 2]."""
    return np.stack([kx, ky], axis=-1)[:, :, None, :].astype(np.float32)


def single_filter_weights(k: np.ndarray) -> np.ndarray:
    """One kernel as a 1-in 1-out conv weight [k, k, 1, 1]."""
    return k[:, :, None, None].astype(np.float32)


def depthwise_weights(k: np.ndarray, channels: int) -> np.ndarray:
    """The same kernel on every channel: depthwise weight [k, k, 1, C]."""
    return np.repeat(k[:, :, None, None], channels, axis=-1).astype(np.float32)
