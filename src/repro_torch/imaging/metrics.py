"""Image quality metrics: PSNR and SSIM (quantized vs float evaluation),
as the reference package defines them."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _data_range(ref: torch.Tensor, data_range) -> torch.Tensor:
    if data_range is not None:
        return torch.tensor(float(data_range), dtype=torch.float32,
                            device=ref.device)
    return torch.clamp_min(ref.max() - ref.min(), 1e-8)


def psnr(ref, x, data_range=None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB. ``ref`` is the ground truth;
    ``data_range`` defaults to ref's dynamic range (use 1.0 for [0, 1]
    frames)."""
    ref, x = _tensor(ref), _tensor(x).to(_tensor(ref).device)
    mse = torch.mean((ref - x) ** 2)
    dr = _data_range(ref, data_range)
    return 20.0 * torch.log10(dr) - 10.0 * torch.log10(
        torch.clamp_min(mse, 1e-12))


def ssim(ref, x, data_range=None, window: int = 7) -> torch.Tensor:
    """Mean structural similarity over [B, H, W, C] (or [B, H, W]) images:
    uniform ``window`` x ``window`` local statistics (the box-filter SSIM),
    C1/C2 stabilizers at k1 = 0.01, k2 = 0.03."""
    ref, x = _tensor(ref), _tensor(x).to(_tensor(ref).device)
    if ref.ndim == 3:
        ref, x = ref[..., None], x[..., None]
    dr = _data_range(ref, data_range)
    c1 = (0.01 * dr) ** 2
    c2 = (0.03 * dr) ** 2
    c = ref.shape[-1]
    k = torch.full((c, 1, window, window), 1.0 / (window * window),
                   device=ref.device)

    def box(img):
        # depthwise box filter, VALID so every window is fully supported
        return F.conv2d(img.permute(0, 3, 1, 2), k, groups=c) \
            .permute(0, 2, 3, 1)

    mu_r, mu_x = box(ref), box(x)
    var_r = box(ref * ref) - mu_r * mu_r
    var_x = box(x * x) - mu_x * mu_x
    cov = box(ref * x) - mu_r * mu_x
    num = (2 * mu_r * mu_x + c1) * (2 * cov + c2)
    den = (mu_r ** 2 + mu_x ** 2 + c1) * (var_r + var_x + c2)
    return torch.mean(num / den)
