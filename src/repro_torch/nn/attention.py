"""Attention: GQA + RoPE, blockwise online softmax, KV cache, SWA.

The reference package's ``nn/attention.py`` on PyTorch, with its algorithm
and its casts: shapes follow [B, T, H, D] (batch, time, heads, head_dim);
KV uses [B, S, K, D] with K (kv heads) <= H and H % K == 0.

Three execution paths:
  * ``attention``        — blockwise (flash-style) online softmax over KV
                           blocks of ``kv_block`` (a Python loop where the
                           reference scans), in the grouped [B, T, K, G, D]
                           layout, f32 running max, sum and accumulator.
                           Training / prefill.
  * ``attention_naive``  — materialized scores; the oracle.
  * ``decode_attention`` — one query token against a cache; O(S) a step.

Sliding-window attention (``window``) masks keys older than the window; in
decode the cache itself is a ring buffer of window size. The cache's
position is a 0-d int32 tensor on the cache's device: the decode path
reads nothing back to the host (masks come from ``arange(S) < pos``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.program import resolve_device
from repro_torch.core.quant import true_div
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (is_dtensor,
                                              unshard_dim)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """1 / theta^(2i/D), float32. The power is taken in float64 and rounded
    once: XLA's float32 pow is correctly rounded where PyTorch's is an ulp
    off for some exponents (theta 5e6, D 128), and RoPE multiplies that
    ulp by the position."""
    exponents = true_div(torch.arange(0, head_dim, 2, dtype=torch.float32,
                                      device=device), head_dim)
    return 1.0 / (theta ** exponents.double()).float()     # [D/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] (or [T]) absolute positions.
    The angles are float32 and the result is cast back to ``x.dtype``."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs           # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]                  # [B, T, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Reference (naive) attention
# ---------------------------------------------------------------------------

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,K,D] -> [B,S,H,D] by repeating each kv head H//K times."""
    reps = n_heads // k.shape[2]
    return torch.repeat_interleave(k, reps, dim=2) if reps > 1 else k


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Oracle. q: [B,T,H,D], k/v: [B,S,K,D] -> [B,T,H,D]."""
    b, t, h, d = q.shape
    s = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = d ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    qpos = torch.arange(t, device=q.device) + q_offset
    kpos = torch.arange(s, device=q.device)
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Blockwise online-softmax attention
# ---------------------------------------------------------------------------

def _attention_local(q, k, v, causal, window, kv_block, q_offset):
    """``attention`` of DTensors as one local region a rank
    (``sharding.local_region``), the way the reference's GSPMD partitions
    it: every row and (kv) head is independent, so each rank runs the
    plain function on its batch rows ("batch") and, where the rules shard
    "kv" and the mesh dim divides the kv heads, on its heads; elsewhere
    the heads are whole on every rank. (Op by op, DTensor picks layouts
    for the block loop's einsums that its own views then cannot take.)"""
    rules = sharding.current_rules() or {}
    b0 = sharding.batch_entry(q.device_mesh, q.shape[0])
    heads = sharding.spec_for("kv", rules=rules)[0] if rules else None
    if heads is not None and k.shape[2] % sharding.spec_shards(
            heads, q.device_mesh):
        heads = None
    spec = (b0, None, heads, None)
    return sharding.local_region(
        lambda q_, k_, v_: attention(q_, k_, v_, causal, window, kv_block,
                                     q_offset),
        [(q, spec), (k, spec), (v, spec)], [spec])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              kv_block: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV blocks. Memory O(T * kv_block).

    GQA-aware: computes in grouped layout [B, T, K, G, D] so kv heads are
    never materialized H/K times. S is zero-padded to a multiple of
    ``kv_block`` and the padding masked, as in the reference.

    On DTensors (under ``sharding.use_rules``) it runs as one local region
    a rank (``_attention_local``).
    """
    if is_dtensor(q):
        return _attention_local(q, k, v, causal, window, kv_block, q_offset)
    b, t, h, d = q.shape
    s = k.shape[1]
    kv_heads = k.shape[2]
    g = h // kv_heads
    scale = d ** -0.5

    if s % kv_block:
        pad = kv_block - s % kv_block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n_blocks = k.shape[1] // kv_block

    qg = q.reshape(b, t, kv_heads, g, d)
    kb = k.reshape(b, n_blocks, kv_block, kv_heads, d)
    vb = v.reshape(b, n_blocks, kv_block, kv_heads, d)
    qpos = (torch.arange(t, device=q.device) + q_offset)[:, None]   # [T, 1]
    blk = torch.arange(kv_block, device=q.device)[None, :]

    m = torch.full((b, t, kv_heads, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, t, kv_heads, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t, kv_heads, g, d), dtype=torch.float32,
                      device=q.device)
    for i in range(n_blocks):
        k_blk, v_blk = kb[:, i], vb[:, i]                   # [B,kvb,K,D]
        kpos = i * kv_block + blk                           # [1, kvb]
        sc = torch.einsum("btkgd,bskd->btkgs", qg, k_blk).float()
        sc = sc * scale
        mask = kpos < s                                     # padding
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
        m_blk = sc.amax(dim=-1)                             # [B,T,K,G]
        m_new = torch.maximum(m, m_blk)
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("btkgs,bskd->btkgd", p.to(v_blk.dtype), v_blk)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    floor = torch.full((), 1e-30, dtype=torch.float32, device=q.device)
    out = acc / torch.maximum(l[..., None], floor)
    return out.reshape(b, t, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor         # [B, S_cache, K, D]
    v: torch.Tensor
    pos: torch.Tensor       # [] int32 — number of tokens already written

    @classmethod
    def init(cls, batch: int, max_len: int, kv_heads: int, head_dim: int,
             dtype=torch.bfloat16, device="cuda"):
        device = resolve_device(device)
        z = torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                        device=device)
        return cls(z, torch.zeros_like(z),
                   torch.zeros((), dtype=torch.int32, device=device))


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 ring: bool = False) -> KVCache:
    """Insert [B, 1, K, D] at cache.pos (ring buffer if ``ring``); returns
    a new cache, the old one untouched.

    Past the end of a non-ring cache the write lands on the last slot, as
    ``dynamic_update_slice`` clamps its start index; a ring cache wraps.
    """
    s_cache = cache.k.shape[1]
    idx = (torch.remainder(cache.pos, s_cache) if ring
           else torch.clamp(cache.pos, 0, s_cache - 1)).reshape(1).long()
    if is_dtensor(cache.k):
        # a sequence-sharded cache: the same values by a select over the
        # sequence, each rank writing only its own slots (index_copy along
        # a sharded dim would gather the whole cache)
        sel = (torch.arange(s_cache, device=idx.device) == idx)[
            None, :, None, None]
        k = torch.where(sel, unshard_dim(k_new, 2).to(cache.k.dtype),
                        cache.k)
        v = torch.where(sel, unshard_dim(v_new, 2).to(cache.v.dtype),
                        cache.v)
        return KVCache(k, v, cache.pos + 1)
    k = cache.k.index_copy(1, idx, k_new.to(cache.k.dtype))
    v = cache.v.index_copy(1, idx, v_new.to(cache.v.dtype))
    return KVCache(k, v, cache.pos + 1)


def decode_attention(q: torch.Tensor, cache: KVCache,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-step decode: q [B,1,H,D] vs the cache. O(S_cache) a token.

    With a ring-buffer cache (sliding window) every resident entry is valid
    once pos >= S_cache; before that, entries >= pos are masked.
    """
    b, one, h, d = q.shape
    s_cache = cache.k.shape[1]
    kv_heads = cache.k.shape[2]
    g = h // kv_heads
    scale = d ** -0.5
    # under a mesh the query's heads are gathered first (one token: cheap):
    # the cache is sharded on its sequence, and DTensor cannot contract a
    # heads-sharded query against it (the grouped reshape makes a strided
    # shard its bmm strategy rejects)
    qg = unshard_dim(q, 2).reshape(b, kv_heads, g, d)
    # a cache may live in a narrower dtype; upcast at use
    k_cache = cache.k.to(q.dtype)
    v_cache = cache.v.to(q.dtype)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    kpos = torch.arange(s_cache, device=q.device)
    # cache.pos counts tokens already written (cache_update increments it),
    # so entries 0..pos-1 are valid; the query sits at position pos-1.
    valid = kpos < cache.pos
    if window is not None and window < s_cache:
        valid &= kpos >= cache.pos - window
    sc = torch.where(valid[None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype), v_cache)
    return out.reshape(b, 1, h, d).to(q.dtype)
