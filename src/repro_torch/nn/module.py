"""Initializers for the pure-functional substrate.

Each initializer returns ``init(generator, shape, dtype)``: the reference's
take a ``jax.random`` key, the port's a ``torch.Generator`` (CPU), so the
same seed gives other numbers. To drive both packages with one set of
weights, make them with numpy (``repro_torch.weights``).
"""

from __future__ import annotations

import math

import torch


def normal_init(stddev: float = 0.02):
    def init(generator: torch.Generator, shape, dtype=torch.float32):
        return stddev * torch.randn(shape, generator=generator, dtype=dtype)
    return init


def scaled_init(fan_in: int):
    """1/sqrt(fan_in) — the default for projection matrices."""
    return normal_init(1.0 / math.sqrt(max(fan_in, 1)))


def zeros_init():
    def init(generator: torch.Generator, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)
    return init


def ones_init():
    def init(generator: torch.Generator, shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)
    return init
