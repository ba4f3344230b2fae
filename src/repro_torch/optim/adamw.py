"""AdamW with an f32 master copy of low-precision params, as a functional
update over nested dicts of tensors (``{layer: {"w", "b"}}``).

It is the reference's update, not ``torch.optim.AdamW`` (which decays the
weight before the step and places ``eps`` elsewhere):

    g     = grad * min(1, grad_clip / max(global_norm, 1e-12))
    m, v  = b1 m + (1 - b1) g,  b2 v + (1 - b2) g^2
    p     = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

with the bias corrections ``b^t`` in float32. Nothing is updated in place:
the caller gets new params and a new state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.optim.clip import (clip_scale, global_norm, tree_leaves,
                                   tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                    # peak lr (scheduled outside or const)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True            # keep f32 master for bf16 params


def adamw_init(params, cfg: AdamWConfig):
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "mu": tree_map(zeros32, params),
             "nu": tree_map(zeros32, params)}
    if cfg.master_fp32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None) -> Tuple[dict, dict, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr_t = torch.as_tensor(cfg.lr if lr is None else lr, dtype=torch.float32,
                           device=gnorm.device)
    b1c = 1.0 - torch.pow(torch.full_like(lr_t, cfg.b1), step.float())
    b2c = 1.0 - torch.pow(torch.full_like(lr_t, cfg.b2), step.float())

    def g32(g):
        return g.float() * scale

    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g32(g),
                  state["mu"], grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g32(g).square(),
                  state["nu"], grads)

    def upd(p, m, v):
        p32 = p.float()
        mhat = m / b1c
        vhat = v / b2c
        return p32 - lr_t * (mhat / (torch.sqrt(vhat) + cfg.eps)
                             + cfg.weight_decay * p32)

    new_master = tree_map(upd, state.get("master", params), mu, nu)
    new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master, params)
    new_state = {"step": step, "mu": mu, "nu": nu}
    if "master" in state:
        new_state["master"] = new_master
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr_t}
