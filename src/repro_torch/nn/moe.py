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
the reference's are (no kernel of either package is on this path).

Under a mesh (``distributed.sharding.use_rules`` with DTensor inputs)
the grouped dispatch keeps the reference's constraints (the tokens
batch-sharded, the router logits whole over "model") as the layout of a
row-local routing region, and when the rules shard "experts" it takes
the expert-parallel branch, the reference's ``shard_map`` region as local
tensors and explicit collectives: each rank holds its E/m experts
(all-gathered over "data" first under FSDP), scatters the slots that
land on them, runs the three expert einsums, gathers, weights and sums
over k, and one all-reduce over the "model" group sums the ranks' parts.
Storage-quantized experts (a dict leaf) take the fallback, as in the
reference (``_moe_grouped_sharded``). The sorted dispatch, whose capacity
is global, runs whole on every rank. Op by op, DTensor has no strategy
(or, on some versions, a faulty one) for the routing's sorts, scatters
and gathers; the regions keep them on local tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.program import resolve_device
from repro_torch.core.quant import WASpec, fake_quant_weight, true_div
from repro_torch.distributed import sharding
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
    """Global sorted dispatch. x: [B, S, d] -> MoEOutput, y: [B, S, d].
    On DTensors it runs whole on every rank (``sharding.local_region``
    with nothing split): its capacity is global, so no rank can route its
    own rows alone."""
    if sharding.is_dtensor(x):
        leaves = list(_flat_params(params))
        n = len(leaves)

        def whole(*t):
            out = moe_ffn(_unflat_params(leaves, t[:n]), t[n], cfg, quant,
                          capacity)
            return tuple(out)
        specs = [(v, (None,) * v.ndim) for _, v in leaves] + \
            [(x, (None,) * x.ndim)]
        return MoEOutput(*sharding.local_region(
            whole, specs, [(None,) * 3, (), (), ()]))
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
    if sharding.is_dtensor(x):
        return _moe_grouped_sharded(params, x, cfg, quant, capacity,
                                    combine_dtype)

    logits = x.float() @ params["router"]                     # [G, S, E]
    probs, top_w, top_i = _route(logits, k)                   # [G, S, k]
    balance, z = _aux_losses(cfg, logits, probs, top_i, bsz * n_slot)

    slots = _slots(top_i.reshape(bsz, n_slot), e, capacity)   # [G, S*k]
    y = _moe_block(params, x, slots, top_w, e, k, capacity, quant,
                   combine_dtype)
    dropped = _dropped(slots, e * capacity)
    return MoEOutput(y.to(x.dtype), balance, z, dropped)


def _moe_block(params, x, slots, top_w, e, k, capacity, quant,
               combine_dtype) -> torch.Tensor:
    """Dispatch -> expert FFN -> combine: [G, S, d] -> [G, S, d] float32,
    the whole buffer [G, E, C, d] (the reference's fallback)."""
    seq = x.shape[1]
    buffers = _dispatch(x, slots, k, e, capacity)
    yb = _expert_ffn_grouped(params, buffers, quant)
    if combine_dtype is not None:
        yb = to_combine_dtype(yb, combine_dtype)
    return _combine_fallback(yb, slots, top_w, seq, k)


def route_rows(router, x, e: int, k: int, capacity: int):
    """The grouped dispatch's routing of DTensor rows ``x`` [G, S, d], one
    local region a rank: each rank routes its batch rows ("batch"; the
    router whole, the rows' logits whole over "model", the reference's
    constraint). -> (gates [G, S*k], expert ids [G, S*k], slots [G, S*k],
    then the aux losses' sums over the rows: the router probabilities [E],
    the expert counts [E], the squared logsumexps, the dropped slots),
    the sums partial over the batch's mesh dims."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    b0 = sharding.batch_entry(mesh, x.shape[0])
    rows2 = (b0, None)
    summed = [Partial() if p.is_shard() else Replicate()
              for p in sharding.placements((b0,), mesh)]
    n_slot = x.shape[1] * k

    def route(x_l, router_l):
        logits = x_l.float() @ router_l                        # [G, S, E]
        probs, top_w, top_i = _route(logits, k)
        top_i = top_i.reshape(x_l.shape[0], n_slot)
        slots = _slots(top_i, e, capacity)
        flat = top_i.reshape(-1)
        counts = torch.zeros((e,), dtype=torch.float32, device=x_l.device)
        counts = counts.index_add(0, flat, torch.ones(
            flat.shape, dtype=torch.float32, device=x_l.device))
        return (top_w.reshape(x_l.shape[0], n_slot), top_i, slots,
                probs.reshape(-1, e).sum(dim=0), counts,
                torch.square(_logsumexp(logits)).sum(),
                (slots == e * capacity).float().sum())

    return sharding.local_region(
        route, [(x, (b0, None, None)), (router, (None, None))],
        [rows2, rows2, rows2, summed, summed, summed, summed])


def _flat_params(params):
    """(name, tensor) of an expert param dict, a storage leaf's wq and ws
    as ``name/wq``, ``name/ws``."""
    for name in sorted(params):
        v = params[name]
        if isinstance(v, dict):
            for sub in sorted(v):
                yield f"{name}/{sub}", v[sub]
        else:
            yield name, v


def _unflat_params(leaves, tensors):
    out = {}
    for (name, _), t in zip(leaves, tensors):
        head, _, sub = name.partition("/")
        if sub:
            out.setdefault(head, {})[sub] = t
        else:
            out[head] = t
    return out


def _moe_grouped_sharded(params, x, cfg: MoEConfig, quant, capacity,
                         combine_dtype) -> MoEOutput:
    """``moe_ffn_grouped`` on DTensors: the reference's routing under GSPMD
    and its ``_moe_block`` (``shard_map`` or fallback) as local regions
    (``sharding.local_region``) and explicit reductions.

    Routing is row-local (``route_rows``); its sums for the aux losses are
    completed by one all-reduce each over the batch's mesh dims (balance
    and z then sum in another order than the unsharded means: within
    float32 rounding; the dropped count is exact). Then the expert block:
    the expert-parallel branch where the rules shard "experts" (raw
    float experts), else the fallback on each rank's rows, its FFN dim
    split over "model" where the rules shard "moe_ffn" and the experts
    are float and not fake-quantized (the partial outputs all-reduced over
    "model" before the combine cast), else the experts whole."""
    from torch.distributed.tensor import Partial, Replicate
    bsz, seq, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_slot = seq * k
    rules = sharding.current_rules() or {}
    mesh = x.device_mesh
    x = sharding.shard(x, "batch", None, None)
    b0 = sharding.batch_entry(mesh, bsz)
    rows3, rows2 = (b0, None, None), (b0, None)
    top_w, _, slots, p_sum, counts, z_sum, n_drop = route_rows(
        params["router"], x, e, k, capacity)
    p_sum, counts, z_sum, n_drop = (
        t.redistribute(mesh, [Replicate()] * mesh.ndim)
        for t in (p_sum, counts, z_sum, n_drop))
    n_rows = bsz * seq
    me = true_div(p_sum, n_rows)
    ce = counts * true_div(torch.ones((), device=counts.device),
                           bsz * n_slot)
    balance = cfg.balance_coef * e * torch.sum(me * ce)
    z = cfg.router_z_coef * true_div(z_sum, n_rows)
    dropped = true_div(n_drop, bsz * n_slot)

    storage = isinstance(params["w_gate"], dict)
    if rules.get("experts") and not storage:
        y = _moe_block_ep(params, x, slots, top_w, e, k, capacity, quant,
                          combine_dtype, rules)
        return MoEOutput(y.to(x.dtype), balance, z, dropped)
    f_ax = sharding.spec_for("moe_ffn", rules=rules)[0] \
        if rules.get("moe_ffn") and not storage and quant is None else None
    if f_ax is not None and cfg.d_ff % sharding.spec_shards(f_ax, mesh):
        f_ax = None
    specs = {"w_gate": (None, None, f_ax), "w_up": (None, None, f_ax),
             "w_down": (None, f_ax, None)}
    leaves = [(n, v) for n, v in _flat_params(params) if n != "router"]

    def experts(x_l, slots_l, *ws):
        buffers = _dispatch(x_l, slots_l, k, e, capacity)
        return _expert_ffn_grouped(_unflat_params(leaves, ws), buffers,
                                   quant)

    yb_place = [Partial() if dim == f_ax else p for dim, p in zip(
        sharding.mesh_axis_names(mesh),
        sharding.placements((b0, None, None, None), mesh))]
    yb = sharding.local_region(
        experts, [(x, rows3), (slots, rows2)] + [
            (v, specs.get(n, (None,) * v.ndim)) for n, v in leaves],
        [yb_place])
    yb = sharding.redistribute(yb, sharding.placements(
        (b0, None, None, None), mesh))             # the partial sums met

    def combine(yb_l, slots_l, w_l):
        if combine_dtype is not None:
            yb_l = to_combine_dtype(yb_l, combine_dtype)
        return _combine_fallback(yb_l, slots_l, w_l.reshape(
            *w_l.shape[:1], seq, k), seq, k)

    y = sharding.local_region(combine, [(yb, (b0, None, None, None)),
                                        (slots, rows2), (top_w, rows2)],
                              [rows3])
    return MoEOutput(y.to(x.dtype), balance, z, dropped)


def _moe_block_ep(params, x, slots, top_w, e, k, capacity, quant,
                  combine_dtype, rules) -> torch.Tensor:
    """The expert-parallel branch (the reference's ``shard_map`` body), one
    local region a rank (``sharding.local_region``).

    Tokens, slots and gates are taken batch-sharded and replicated over
    "model"; the experts sharded over "model" on E and whole on d (under
    FSDP an all-gather over "data" first, whose backward is the gradients'
    reduce-scatter). Each rank scatters the slots that land on its
    experts, runs the three expert einsums on them, gathers, weights and
    sums over k: its part of the output, a ``Partial`` DTensor over
    "model", which redistributing to ``Replicate`` completes with the one
    all-reduce over the "model" group. As in the reference's branch the
    experts are taken raw in x's dtype (no fake-quant: its per-feature
    scale would span the other ranks' experts)."""
    from torch.distributed.tensor import Partial
    mesh = params["w_gate"].device_mesh
    names = sharding.mesh_axis_names(mesh)
    m_ax = sharding.entry_axes(sharding.spec_for("experts", rules=rules))[0]
    b0 = sharding.batch_entry(mesh, x.shape[0])
    seq = x.shape[1]
    base = mesh.get_local_rank(names.index(m_ax))

    def body(x_l, slot_l, w_l, wg, wu, wd):
        g_l, _, d = x_l.shape
        wg, wu, wd = (w.to(x_l.dtype) for w in (wg, wu, wd))
        n_slot = slot_l.shape[1]
        e_l = wg.shape[0]
        local_size = e_l * capacity
        loc = slot_l - base * local_size
        valid = (loc >= 0) & (loc < local_size)
        loc_in = torch.where(valid, loc, torch.full_like(loc, local_size))
        src_tok = torch.arange(n_slot, device=x_l.device) // k
        rows = torch.arange(g_l, device=x_l.device)[:, None]
        buf = x_l.new_zeros((g_l, local_size + 1, d))         # + drop row
        buf = buf.index_put((rows, loc_in), x_l[:, src_tok])
        xb = buf[:, :-1].reshape(g_l, e_l, capacity, d)
        gate = torch.einsum("gecd,edf->gecf", xb, wg)
        up = torch.einsum("gecd,edf->gecf", xb, wu)
        yb = torch.einsum("gecf,efd->gecd", silu(gate) * up, wd)
        if combine_dtype is not None:
            yb = to_combine_dtype(yb, combine_dtype)
        g = yb.reshape(g_l, local_size, d)[rows, loc.clamp(0, local_size - 1)]
        g = torch.where(valid[..., None], g, torch.zeros_like(g)).float()
        part = (g * w_l[..., None]).reshape(g_l, seq, k, d).sum(dim=2)
        return part.to(x_l.dtype)

    tok_place = sharding.placements((b0, None, None), mesh)
    out_place = [Partial() if dim == m_ax else p
                 for dim, p in zip(names, tok_place)]
    w_spec = (m_ax, None, None)
    part = sharding.local_region(
        body, [(x, (b0, None, None)), (slots, (b0, None)),
               (top_w.reshape(top_w.shape[0], -1), (b0, None)),
               (params["w_gate"], w_spec), (params["w_up"], w_spec),
               (params["w_down"], w_spec)], [out_place])
    return part.redistribute(mesh, tok_place).float()


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
