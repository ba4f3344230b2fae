"""Mixture-of-Experts: top-k token-choice routing with sort-based dispatch,
the reference package's ``nn/moe.py`` on PyTorch.

Both MoE archs route through it: grok-1 (8 experts, top-2) and kimi-k2
(384 experts, top-8). Dispatch is sort-based (a one-hot dispatch tensor is
O(tokens * E * capacity)):

  1. router -> top-k (renormalized) per token
  2. flatten (token, k) slots, stable-sort by expert id
  3. rank within the expert from the exclusive cumsum of expert counts
  4. scatter tokens into a capacity-bounded buffer [E, C, d] (drop overflow)
  5. batched expert FFN [E, C, d] @ [E, d, ff] @ [E, ff, d] (SwiGLU)
  6. gather back per slot, weighted combine over k

``moe_ffn`` dispatches globally, ``moe_ffn_grouped`` per batch row (the
reference's group-local rewrite, with its optional low-precision
``combine_dtype``). Aux losses: load balance (Switch) and router z-loss.

Where the two libraries differ, the port takes the reference's way:
``jax.lax.top_k`` puts the lower index first among equal probabilities
(here a stable descending ``torch.sort``); softmax and logsumexp follow
``jax.nn``'s ops one by one; ``mode="drop"`` scatters and ``mode="fill"``
gathers become one extra sentinel row, sliced off, so no step reads
the device from the host. Products are plain ``torch.einsum`` calls, as
the reference's are (no kernel of either package is on this path). The
reference's ``shard_map`` branch and ``shard(...)`` constraints need a
mesh; without one they are the identity, and the port leaves them out.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.program import resolve_device
from repro_torch.core.quant import WASpec, fake_quant_weight, true_div
from repro_torch.nn.layers import silu
from repro_torch.nn.module import KeyGen, scaled_init

# |x| above which float8_e4m3fn has no rounding neighbour: ml_dtypes and
# XLA give NaN there (the format has no infinity), PyTorch saturates to 448
F8_E4M3FN_NAN_ABOVE = 464.0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                     # per-expert hidden
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    balance_coef: float = 1e-2


class MoEOutput(NamedTuple):
    y: torch.Tensor
    balance_loss: torch.Tensor
    z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def init_moe(generator: torch.Generator, cfg: MoEConfig,
             dtype=torch.float32, device="cuda"):
    """Router [d, E] (float32 whatever ``dtype``) and stacked SwiGLU
    experts [E, d, f] / [E, f, d], drawn on ``device`` from generators
    split off ``generator``."""
    kg = KeyGen(generator, resolve_device(device))
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": scaled_init(d)(kg(), (d, e), torch.float32),
        "w_gate": scaled_init(d)(kg(), (e, d, f), dtype),
        "w_up": scaled_init(d)(kg(), (e, d, f), dtype),
        "w_down": scaled_init(f)(kg(), (e, f, d), dtype),
    }


def _w(p, dtype):
    """Expert weight, possibly in photonic serving storage ({wq, ws}): the
    levels and the scales each cast to ``dtype`` before the product."""
    if isinstance(p, dict):
        return p["wq"].to(dtype) * p["ws"].to(dtype)
    return p


def _expert_weights(params, dtype, quant: Optional[WASpec]):
    """(w_gate, w_up, w_down) in ``dtype``'s storage form; under ``quant``
    fake-quantized in float32 with one scale per output feature over every
    other axis (E and d together, as the reference's)."""
    ws = [_w(params[k], dtype) for k in ("w_gate", "w_up", "w_down")]
    if quant is not None:
        ws = [fake_quant_weight(w.float(), quant).to(dtype) for w in ws]
    return ws


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands: two dtypes promote."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _expert_ffn(params, xb: torch.Tensor,
                quant: Optional[WASpec]) -> torch.Tensor:
    """xb: [E, C, d] -> [E, C, d] (SwiGLU per expert)."""
    wg, wu, wd = _expert_weights(params, xb.dtype, quant)
    gate = _einsum("ecd,edf->ecf", xb, wg)
    up = _einsum("ecd,edf->ecf", xb, wu)
    h = silu(gate) * up
    return _einsum("ecf,efd->ecd", h, wd)


def _expert_ffn_grouped(params, xb: torch.Tensor,
                        quant: Optional[WASpec]) -> torch.Tensor:
    """xb: [G, E, C, d] -> [G, E, C, d]; the weights cast to xb's dtype."""
    wg, wu, wd = (w.to(xb.dtype)
                  for w in _expert_weights(params, xb.dtype, quant))
    gate = torch.einsum("gecd,edf->gecf", xb, wg)
    up = torch.einsum("gecd,edf->gecf", xb, wu)
    h = silu(gate) * up
    return torch.einsum("gecf,efd->gecd", h, wd)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) over its sum."""
    unnormalized = torch.exp(x - x.amax(-1, keepdim=True))
    return unnormalized / unnormalized.sum(-1, keepdim=True)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis, op by op: a non-finite max
    taken as 0, log(|sum exp(x - max)|) + max."""
    amax = x.amax(-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.exp(x - amax).sum(-1).abs()) + amax[..., 0]


def _route(logits: torch.Tensor, k: int):
    """Router logits [..., E] (float32) -> (probs, top_w renormalized,
    top_i), the top k of the probabilities in ``jax.lax.top_k``'s order
    (the lower expert id first among equals)."""
    probs = _softmax(logits)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = vals[..., :k], idx[..., :k]
    floor = torch.full((), 1e-9, dtype=top_w.dtype, device=top_w.device)
    top_w = top_w / torch.maximum(top_w.sum(-1, keepdim=True), floor)
    return probs, top_w, top_i


def _aux_losses(cfg: MoEConfig, logits, probs, top_i, n_slot: int):
    """(balance, z): Switch's load balance over every routed slot (each
    adds 1/n_slot to its expert's share; all addends equal, so any order of
    the scatter-add gives the same bits) and the router z-loss."""
    e = cfg.n_experts
    me = probs.reshape(-1, e).mean(dim=0)
    flat = top_i.reshape(-1)
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    ce = ce.index_add(0, flat, torch.full(flat.shape, 1.0 / n_slot,
                                          dtype=torch.float32,
                                          device=probs.device))
    balance = cfg.balance_coef * e * torch.sum(me * ce)
    z = cfg.router_z_coef * torch.mean(torch.square(_logsumexp(logits)))
    return balance, z


def _slots(top_i: torch.Tensor, e: int, capacity: int) -> torch.Tensor:
    """Expert ids [G, n] of each row's (token, k) slots -> the buffer row
    of each slot, ``expert * capacity + rank`` in [0, E*C), or the drop
    sentinel E*C past the expert's capacity: the stable sort by expert id
    ranks a row's slots in their order within each expert."""
    g, n = top_i.shape
    order = torch.argsort(top_i, dim=-1, stable=True)
    sorted_e = top_i.gather(1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=top_i.device)
    counts = counts.scatter_add(1, top_i, torch.ones_like(top_i))
    seg_start = counts.cumsum(1) - counts                     # exclusive
    rank = torch.arange(n, device=top_i.device)[None] \
        - seg_start.gather(1, sorted_e)
    slot_sorted = torch.where(rank < capacity, sorted_e * capacity + rank,
                              torch.full_like(rank, e * capacity))
    return torch.empty_like(slot_sorted).scatter(1, order, slot_sorted)


def _dispatch(x: torch.Tensor, slots: torch.Tensor, k: int, e: int,
              capacity: int) -> torch.Tensor:
    """x [G, S, d], slots [G, S*k] -> buffers [G, E, C, d]: each kept
    slot's token in its row, empty rows zero; the dropped slots land on a
    sentinel row past the end, sliced off (``mode="drop"``)."""
    g, _, d = x.shape
    src_tok = torch.arange(slots.shape[1], device=x.device) // k
    rows = torch.arange(g, device=x.device)[:, None]
    buf = x.new_zeros((g, e * capacity + 1, d))
    buf = buf.index_put((rows, slots), x[:, src_tok])
    return buf[:, :-1].reshape(g, e, capacity, d)


def _combine_fallback(yb: torch.Tensor, slots: torch.Tensor,
                      top_w: torch.Tensor, seq: int, k: int) -> torch.Tensor:
    """yb [G, E, C, d] -> [G, S, d] float32: each slot's expert output (0
    for a dropped slot, ``mode="fill"``) weighted by its gate, summed over
    the token's k slots."""
    bsz, e, capacity, d = yb.shape
    yb_flat = torch.cat([yb.reshape(bsz, e * capacity, d),
                         yb.new_zeros((bsz, 1, d))], dim=1)
    rows = torch.arange(bsz, device=yb.device)[:, None]
    g = yb_flat[rows, slots]                                  # [G, S*k, d]
    return (g.float() * top_w.reshape(bsz, -1)[..., None]
            ).reshape(bsz, seq, k, d).sum(dim=2)


def _dropped(slots: torch.Tensor, sentinel: int) -> torch.Tensor:
    """The fraction of slots dropped: an exact count over the IEEE
    quotient by the slots (``jnp.mean`` compiled without XLA's algebraic
    simplifier, which would multiply by 1/n)."""
    return true_div((slots == sentinel).float().sum(), slots.numel())


def to_combine_dtype(yb: torch.Tensor, dtype) -> torch.Tensor:
    """``yb.astype(dtype)`` as ml_dtypes and XLA cast: float8_e4m3fn gives
    NaN past its last rounding neighbour (|x| > 464, infinities too) where
    PyTorch saturates to +-448; other dtypes cast as PyTorch does."""
    if dtype == torch.float8_e4m3fn:
        nan = torch.full((), float("nan"), dtype=yb.dtype, device=yb.device)
        yb = torch.where(yb.abs() > F8_E4M3FN_NAN_ABOVE, nan, yb)
    return yb.to(dtype)


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig,
            quant: Optional[WASpec] = None,
            capacity: Optional[int] = None) -> MoEOutput:
    """Global sorted dispatch. x: [B, S, d] -> MoEOutput, y: [B, S, d]."""
    bsz, seq, d = x.shape
    n_tok = bsz * seq
    e, k = cfg.n_experts, cfg.top_k
    n_slot = n_tok * k
    if capacity is None:
        capacity = max(int(n_tok * k / e * cfg.capacity_factor), 1)

    flat = x.reshape(n_tok, d)
    logits = flat.float() @ params["router"]                  # [N, E]
    probs, top_w, top_i = _route(logits, k)                   # [N, k]
    balance, z = _aux_losses(cfg, logits, probs, top_i, n_slot)

    slot = _slots(top_i.reshape(1, n_slot), e, capacity)      # [1, N*k]
    buffer = _dispatch(flat[None], slot, k, e, capacity)[0]   # [E, C, d]
    yb = _expert_ffn(params, buffer, quant)
    combined = _combine_fallback(yb[None], slot, top_w, n_tok, k)[0]
    dropped = _dropped(slot, e * capacity)
    return MoEOutput(combined.reshape(bsz, seq, d).to(x.dtype), balance, z,
                     dropped)


def moe_ffn_grouped(params, x: torch.Tensor, cfg: MoEConfig,
                    quant: Optional[WASpec] = None,
                    capacity: Optional[int] = None,
                    combine_dtype=None) -> MoEOutput:
    """Group-local dispatch: every batch row has its own buffer [E, C_g, d]
    with C_g = S*k/E * capacity_factor, so the expected drop rate is the
    global formulation's (balance is per row instead of per batch). The
    expert outputs pass through ``combine_dtype`` (float8_e4m3fn or
    bfloat16; None keeps them) before the combine, the reference's
    quantized combine traffic."""
    bsz, seq, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if capacity is None:
        capacity = max(int(seq * k / e * cfg.capacity_factor), 1)
    n_slot = seq * k

    logits = x.float() @ params["router"]                     # [G, S, E]
    probs, top_w, top_i = _route(logits, k)                   # [G, S, k]
    balance, z = _aux_losses(cfg, logits, probs, top_i, bsz * n_slot)

    slots = _slots(top_i.reshape(bsz, n_slot), e, capacity)   # [G, S*k]
    buffers = _dispatch(x, slots, k, e, capacity)
    yb = _expert_ffn_grouped(params, buffers, quant)
    if combine_dtype is not None:
        yb = to_combine_dtype(yb, combine_dtype)
    y = _combine_fallback(yb, slots, top_w, seq, k)
    dropped = _dropped(slots, e * capacity)
    return MoEOutput(y.to(x.dtype), balance, z, dropped)


def moe_ffn_dense_oracle(params, x: torch.Tensor,
                         cfg: MoEConfig) -> torch.Tensor:
    """All-experts reference (tests only): y = sum_e gate_e * FFN_e(x)."""
    bsz, seq, d = x.shape
    flat = x.reshape(-1, d)
    _, top_w, top_i = _route(flat.float() @ params["router"], cfg.top_k)
    gates = torch.zeros((flat.shape[0], cfg.n_experts), dtype=torch.float32,
                        device=x.device).scatter(1, top_i, top_w)
    per_expert = _expert_ffn(
        params, flat[None].expand(cfg.n_experts, *flat.shape), None)
    y = torch.einsum("ne,end->nd", gates, per_expert.float())
    return y.reshape(bsz, seq, d).to(x.dtype)
