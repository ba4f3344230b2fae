"""LR schedules (pure functions of the step), in float32 like the
reference's."""

from __future__ import annotations

import math

import torch

from repro_torch.core.quant import true_div


def cosine_schedule(step, total_steps: int, peak: float,
                    final_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(true_div(torch.as_tensor(step).float(),
                             max(total_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return peak * (final_frac + (1 - final_frac) * cos)


def linear_warmup_cosine(step, warmup: int, total_steps: int, peak: float,
                         final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = peak * torch.clamp(true_div(step.float(), max(warmup, 1)),
                              max=1.0)
    cos = cosine_schedule(torch.clamp(step - warmup, min=0),
                          max(total_steps - warmup, 1), peak, final_frac)
    return torch.where(step < warmup, warm, cos)
