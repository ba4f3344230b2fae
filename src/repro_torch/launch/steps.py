"""The train, prefill and serve steps as plain functions.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(new_params, new_opt, metrics)``: ``models.lm.lm_loss`` and its gradients
with respect to every float leaf of the params (``torch.autograd.grad``),
then ``optim.adamw.adamw_update``. Nothing is updated in place, and the
metrics stay on the device (``{"loss", "ce", "balance", "z", "dropped",
"grad_norm", "lr"}``), so a step reads nothing back to the host.

Under a mesh (params placed by ``launch.shardings.distribute_tree``, the
rules active through ``distributed.sharding.use_rules``) the same steps run
on DTensors: the plain tensors the model makes are taken as replicated
(``sharding.plain_operands``), ``grad_shardings`` (the params'
placements, ``shardings.tree_shardings``) redistributes the gradients to
the params' layout before the global-norm clip, as the reference's
``with_sharding_constraint`` pins them (without it the moments would
follow the gradients' partial sums), and the metrics come back whole on
every rank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (full_tensor, plain_operands,
                                              redistribute)
from repro_torch.models import lm as lm_mod
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def vocab_chunk_for(cfg: ModelConfig, seq: int) -> int:
    """Chunk the CE loss when the [B,T,V] logits tensor would be monstrous."""
    if cfg.vocab * seq >= 32768 * 4096:
        return 512
    if cfg.vocab >= 64000 and seq >= 4096:
        return 1024
    return 0


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   vocab_chunk: int = 0):
    """-> (loss, metrics, grads): ``lm_loss`` and its gradient with
    respect to every float leaf of ``params`` (a tree of the params'
    structure and dtypes; zeros where a leaf does not reach the loss),
    all detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    with torch.enable_grad():
        loss, metrics = lm_mod.lm_loss(live, batch, cfg,
                                       vocab_chunk=vocab_chunk)
        wrt = [p for p in tree_leaves(live) if p.requires_grad]
        found = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = tree_map(lambda p: (next(found) if p.requires_grad else None),
                     live)
    grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                     grads, params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, seq: int,
                    grad_shardings=None):
    """``grad_shardings``: a tree of DTensor placements mirroring the
    params; each gradient is redistributed to its param's placements
    before the global-norm reduction (a reduce-scatter where the
    gradient is a partial sum over a dim its param shards)."""
    vc = vocab_chunk_for(cfg, seq)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[dict, dict, Dict[str, torch.Tensor]]:
        with plain_operands():
            loss, metrics, grads = loss_and_grads(params, batch, cfg, vc)
            if grad_shardings is not None:
                grads = tree_map(redistribute, grads, grad_shardings)
            new_params, new_opt, om = adamw_update(params, grads,
                                                   opt_state, opt)
        metrics = {"loss": loss, **metrics, **om}
        return new_params, new_opt, {k: full_tensor(v)
                                     for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with plain_operands():
            logits, _ = lm_mod.lm_forward(params, batch, cfg)
        # serving returns the last-position logits (next-token distribution)
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, token: torch.Tensor):
        with plain_operands():
            return lm_mod.decode_step(params, cache, token, cfg)

    return serve_step
