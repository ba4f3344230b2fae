"""The unified LM of the reference package on PyTorch, every family.

families:
  dense    — llama-style GQA decoder (yi-34b, smollm, tinyllama, stablelm)
  ssm      — mamba2 SSD blocks, attention-free (mamba2-1.3b)
  hybrid   — parallel attention + SSM heads per layer (hymba-1.5b)
  encoder  — bidirectional encoder (hubert-xlarge; no decode path)
  vlm      — decoder with a patch-embedding prefix (internvl2-26b)
  moe      — GQA decoder with an MoE FFN (grok-1, kimi-k2; ``nn/moe.py``,
             sorted or grouped dispatch by ``cfg.moe_dispatch``)

Layer params are stacked on a leading [L] axis, as in the reference's tree;
a Python loop over the layers takes the place of ``lax.scan``, each layer
under ``cfg.remat`` (``nn/remat.py``: ``"full"`` recomputes the layer in
the backward pass, ``"dots"`` keeps its matmul outputs; the reference's
``jax.checkpoint``). The reference's ``shard(...)`` sharding constraints
stand at its call sites (``distributed/sharding.py``): the identity on one
device, a DTensor redistribution under ``use_rules`` when the params are
DTensors (``launch/shardings.distribute_tree``). Under a mesh the plain
tensors the code makes (positions, masks, zeros) are taken as replicated
(``sharding.plain_operands``), and the CE's gather runs on logits whose
vocab dim is gathered first (DTensor's masked gather over a sharded vocab
fails on a 2-D mesh; GSPMD gathers there too).

The Lightator photonic quantization threads through every projection via
``nn.layers.dense(quant=...)``: [W{2,3,4}:A4] fake-quant under
``cfg.quant_scheme``, or int-carrier weights after ``quantize_lm_params``.
No product here goes through a custom kernel, as none does in the
reference: they are ``torch.matmul`` and ``torch.einsum``.

Decoding keeps the cache's position a 0-d int32 tensor on the device, so a
step reads nothing back to the host. Entry points run on ``cuda`` unless
the caller asks for the CPU.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compressive import sequence_ca
from repro_torch.core.program import resolve_device
from repro_torch.core.quant import WASpec, _clip, true_div
from repro_torch.distributed.sharding import (batch_entry, is_dtensor,
                                              local_region, shard, splittable,
                                              unshard_dim)
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import layers as L
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import ssm as ssm_mod
from repro_torch.nn.module import (KeyGen, normal_init, scaled_init,
                                   stack_layer_params, tree_map)
from repro_torch.nn.remat import remat

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "in_proj", "out_proj")
ATTN_FAMILIES = ("dense", "moe", "encoder", "vlm", "hybrid")
MOE_EXPERTS = ("w_gate", "w_up", "w_down")   # raw stacked tensors in "moe"


def _layer_slice(tree, i: int):
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn(kg: KeyGen, cfg: ModelConfig, dtype):
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": {"w": scaled_init(d)(kg(), (d, cfg.n_heads * hd), dtype)},
        "wk": {"w": scaled_init(d)(kg(), (d, cfg.n_kv_heads * hd), dtype)},
        "wv": {"w": scaled_init(d)(kg(), (d, cfg.n_kv_heads * hd), dtype)},
        "wo": {"w": scaled_init(cfg.n_heads * hd)(
            kg(), (cfg.n_heads * hd, d), dtype)},
    }


def _init_mlp(kg: KeyGen, cfg: ModelConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": {"w": scaled_init(d)(kg(), (d, f), dtype)},
         "w_down": {"w": scaled_init(f)(kg(), (f, d), dtype)}}
    if cfg.ffn == "swiglu":
        p["w_gate"] = {"w": scaled_init(d)(kg(), (d, f), dtype)}
    return p


def _init_ssm(kg: KeyGen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    di, h = cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    in_dim = 2 * di + 2 * gn + h
    f32, dev = torch.float32, kg.device
    return {
        "in_proj": {"w": scaled_init(d)(kg(), (d, in_dim), dtype)},
        "conv_w": normal_init(0.1)(kg(), (cfg.conv_kernel, cfg.conv_dim),
                                   f32),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=f32, device=dev),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=f32, device=dev)),
        "d_skip": torch.ones((h,), dtype=f32, device=dev),
        "norm": {"scale": torch.ones((di,), dtype=dtype, device=dev)},
        "out_proj": {"w": scaled_init(di)(kg(), (di, d), dtype)},
    }


def _init_norm(kg: KeyGen, cfg: ModelConfig, dtype):
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=kg.device)
    if cfg.norm == "layer":
        return {"scale": ones, "bias": torch.zeros_like(ones)}
    return {"scale": ones}


def _moe_config(cfg: ModelConfig) -> moe_mod.MoEConfig:
    return moe_mod.MoEConfig(cfg.n_experts, cfg.top_k, cfg.d_model,
                             cfg.d_ff, cfg.capacity_factor)


def _apply_norm(p, x, cfg: ModelConfig):
    return L.layernorm(p, x) if cfg.norm == "layer" else L.rmsnorm(p, x)


def _layer_init(kg: KeyGen, cfg: ModelConfig, dtype) -> Dict:
    p: Dict[str, Any] = {"norm1": _init_norm(kg, cfg, dtype)}
    if cfg.family in ATTN_FAMILIES:
        p["attn"] = _init_attn(kg, cfg, dtype)
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = _init_ssm(kg, cfg, dtype)
        if cfg.family == "hybrid":
            p["mix_norm_a"] = {"scale": torch.ones(
                (cfg.d_model,), dtype=dtype, device=kg.device)}
            p["mix_norm_s"] = {"scale": torch.ones(
                (cfg.d_model,), dtype=dtype, device=kg.device)}
    if cfg.family != "ssm":
        p["norm2"] = _init_norm(kg, cfg, dtype)
        if cfg.family == "moe":
            p["moe"] = moe_mod.init_moe(kg(), _moe_config(cfg), dtype,
                                        kg.device)
        else:
            p["mlp"] = _init_mlp(kg, cfg, dtype)
    return p


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            device="cuda") -> Dict:
    """Random params in the reference's tree, drawn on ``device`` from
    generators split off ``generator`` (``KeyGen``): the same generator
    state gives the same weights. Layer params are stacked [L, ...]."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    kg = KeyGen(generator, dev)
    params: Dict[str, Any] = {
        "embed": {"table": normal_init(0.02)(kg(), (cfg.vocab, cfg.d_model),
                                             dtype)},
    }
    if cfg.frontend != "none":
        params["frontend"] = L.init_dense(kg(), cfg.frontend_dim, cfg.d_model,
                                          bias=True, dtype=dtype)
    layer_kg = KeyGen(kg(), dev)
    params["layers"] = stack_layer_params(
        [_layer_init(KeyGen(layer_kg(), dev), cfg, dtype)
         for _ in range(cfg.n_layers)])
    params["final_norm"] = _init_norm(kg, cfg, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(kg(), cfg.d_model, cfg.vocab,
                                         dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, n*hd] -> [B, T, n, hd]. On a DTensor whose last dim a mesh
    dim shards that does not divide ``n``, that dim is gathered first:
    DTensor cannot split an unevenly sharded dim (GSPMD pads it)."""
    x = splittable(x, -1, n)
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


class _MergeHeads(torch.autograd.Function):
    """[B, T, n, hd] -> [B, T, n*hd], whose gradient splits the heads
    through ``split_heads`` (a plain view's backward cannot take a
    gradient DTensor shards unevenly over the merged dim)."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-2]
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.n)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, n, hd] -> [B, T, n*hd]; on a DTensor the head dim is made
    whole first (a split head dim merges into a strided shard)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _MergeHeads.apply(unshard_dim(x, -1))


def _attn_block(p, x, cfg: ModelConfig, positions, quant,
                cache: Optional[Dict] = None, pos_scalar=None):
    """x: [B,T,D] -> [B,T,D]; with a cache, T == 1 (a decode step)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = split_heads(L.dense(p["wq"], x, quant), cfg.n_heads)
    k = split_heads(L.dense(p["wk"], x, quant), cfg.n_kv_heads)
    v = split_heads(L.dense(p["wv"], x, quant), cfg.n_kv_heads)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv", None)
    if cache is None:
        q = attn_mod.apply_rope(q, positions, cfg.rope_theta)
        k = attn_mod.apply_rope(k, positions, cfg.rope_theta)
        out = attn_mod.attention(q, k, v, causal=cfg.causal,
                                 window=cfg.sliding_window)
        new_cache = None
    else:
        pos_b = pos_scalar.reshape(1, 1).expand(b, 1)
        q = attn_mod.apply_rope(q, pos_b, cfg.rope_theta)
        k = attn_mod.apply_rope(k, pos_b, cfg.rope_theta)
        ring = cfg.sliding_window is not None
        kv = attn_mod.KVCache(cache["k"], cache["v"], pos_scalar)
        kv = attn_mod.cache_update(kv, k, v, ring=ring)
        out = attn_mod.decode_attention(q, kv, window=cfg.sliding_window)
        new_cache = {"k": kv.k, "v": kv.v}
    y = L.dense(p["wo"], merge_heads(out), quant)
    return shard(y, "batch", None, "act_embed"), new_cache


def _mlp_block(p, x, cfg: ModelConfig, quant):
    up = L.dense(p["w_up"], x, quant)
    if cfg.ffn == "swiglu":
        gate = L.dense(p["w_gate"], x, quant)
        h = L.silu(gate) * up
    else:
        h = L.gelu(up)
    h = shard(h, "batch", None, "ffn")
    return L.dense(p["w_down"], h, quant)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_block(p, x, cfg: ModelConfig, quant,
               cache: Optional[Dict] = None):
    """Mamba2 block. x: [B,T,D]. Returns (y, new_cache)."""
    b, t, _ = x.shape
    di, h, pdim = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    gn = g * n
    proj = L.dense(p["in_proj"], x, quant)       # [B,T,2di+2gn+h]
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * gn, h], dim=-1)
    a = -torch.exp(p["a_log"])                   # [H]
    dt = _softplus(dt_raw.float() + p["dt_bias"][None, None, :])  # [B,T,H]
    if cache is None:
        xbc = ssm_mod.causal_conv1d(xbc, p["conv_w"], p["conv_b"])
        xbc = L.silu(xbc)
        xs, bmat, cmat = torch.split(xbc, [di, gn, gn], dim=-1)
        xs = shard(xs.reshape(b, t, h, pdim), "batch", None, "ssm_heads",
                   None)
        y, _ = ssm_mod.ssd_chunked(xs, dt, a, bmat.reshape(b, t, g, n),
                                   cmat.reshape(b, t, g, n),
                                   chunk=min(cfg.ssd_chunk, t))
        new_cache = None
    else:
        xbc_new, conv_state = ssm_mod.causal_conv1d_step(
            cache["conv"], xbc[:, 0], p["conv_w"], p["conv_b"])
        xbc_new = L.silu(xbc_new)
        xs, bvec, cvec = torch.split(xbc_new, [di, gn, gn], dim=-1)
        xs = xs.reshape(b, h, pdim)
        y1, ssm_state = ssm_mod.ssd_decode_step(
            cache["ssm"], xs, dt[:, 0], a, bvec.reshape(b, g, n),
            cvec.reshape(b, g, n))
        y = y1[:, None]                          # [B,1,H,P]
        xs = xs[:, None]
        new_cache = {"conv": conv_state, "ssm": ssm_state}
    y = y + xs.reshape(y.shape) * p["d_skip"][None, None, :, None]
    # under a mesh the head dim is whole before the heads merge (DTensor
    # may have split it, which the merge cannot take)
    y = unshard_dim(y, 3).reshape(b, t, di).to(x.dtype)
    y = L.rmsnorm(p["norm"], y * L.silu(z).to(x.dtype))
    return L.dense(p["out_proj"], y, quant).to(x.dtype), new_cache


def _layer(p, x, cfg: ModelConfig, positions, quant,
           cache: Optional[Dict] = None, pos_scalar=None):
    """One block. Returns (x_out, aux, new_cache)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"balance": zero, "z": zero, "dropped": zero}
    new_cache: Dict[str, Any] = {}
    h = _apply_norm(p["norm1"], x, cfg)
    if cfg.family in ("dense", "moe", "encoder", "vlm"):
        y, kvc = _attn_block(p["attn"], h, cfg, positions, quant,
                             cache.get("kv") if cache else None, pos_scalar)
        if kvc is not None:
            new_cache["kv"] = kvc
        x = x + y
    elif cfg.family == "ssm":
        y, sc = _ssm_block(p["ssm"], h, cfg, quant,
                           cache.get("ssm_block") if cache else None)
        if sc is not None:
            new_cache["ssm_block"] = sc
        return x + y, aux, new_cache            # mamba block = mixer only
    elif cfg.family == "hybrid":
        ya, kvc = _attn_block(p["attn"], h, cfg, positions, quant,
                              cache.get("kv") if cache else None, pos_scalar)
        ys, sc = _ssm_block(p["ssm"], h, cfg, quant,
                            cache.get("ssm_block") if cache else None)
        if kvc is not None:
            new_cache["kv"] = kvc
        if sc is not None:
            new_cache["ssm_block"] = sc
        y = 0.5 * (L.rmsnorm(p["mix_norm_a"], ya)
                   + L.rmsnorm(p["mix_norm_s"], ys))
        x = x + y
    h2 = _apply_norm(p["norm2"], x, cfg)
    if cfg.family != "moe":
        return x + _mlp_block(p["mlp"], h2, cfg, quant), aux, new_cache
    if cfg.moe_dispatch == "grouped":
        cdt = (None if cfg.moe_combine_dtype == "none"
               else getattr(torch, cfg.moe_combine_dtype))
        out = moe_mod.moe_ffn_grouped(p["moe"], h2, _moe_config(cfg), quant,
                                      combine_dtype=cdt)
    else:
        out = moe_mod.moe_ffn(p["moe"], h2, _moe_config(cfg), quant)
    aux = {"balance": out.balance_loss, "z": out.z_loss,
           "dropped": out.dropped_fraction}
    return x + out.y, aux, new_cache


# ---------------------------------------------------------------------------
# Embedding / frontend
# ---------------------------------------------------------------------------

def embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token ids and/or modality embeddings -> [B, T, D] hidden states.

    batch keys: "tokens" [B,T_text] int, and for audio/vlm "frames" /
    "patches" [B,T_m,frontend_dim] (precomputed stub embeddings). Ids must
    lie in [0, vocab): the reference's ``jnp.take`` clamps an id out of
    range where indexing here raises.
    """
    parts = []
    if cfg.frontend != "none":
        m = batch["frames" if cfg.frontend == "audio" else "patches"]
        if cfg.ca_factor > 1:
            # compressive acquisition at the sensor interface (paper step 2)
            m = sequence_ca(m, cfg.ca_factor)
        parts.append(L.dense(params["frontend"], m))
    if batch.get("tokens") is not None:
        parts.append(L.embedding_lookup(params["embed"], batch["tokens"]))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return shard(x.to(cfg.torch_dtype), "batch", None, "act_embed")


# ---------------------------------------------------------------------------
# Forward (prefill / loss)
# ---------------------------------------------------------------------------

def lm_forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               return_hidden: bool = False):
    """-> (logits [B,T,V] | hidden, aux dict), a loop over stacked layers,
    each under ``cfg.remat`` when autograd records; aux: the MoE balance
    and z losses and dropped fraction, each a mean over the layers (0 for
    the other families)."""
    x = embed_inputs(params, batch, cfg)
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)[None, :]
    quant = cfg.quant_spec()

    def body(i, h):
        h, aux, _ = _layer(_layer_slice(params["layers"], i), h, cfg,
                           positions, quant)
        return h, aux["balance"], aux["z"], aux["dropped"]

    bal = z = drp = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, b_i, z_i, d_i = remat(functools.partial(body, i), x,
                                 policy=cfg.remat)
        bal, z, drp = bal + b_i, z + z_i, drp + d_i
    x = _apply_norm(params["final_norm"], x, cfg)
    aux = {"balance": bal / cfg.n_layers, "z": z / cfg.n_layers,
           "dropped": drp / cfg.n_layers}
    if return_hidden:
        return x, aux
    return _lm_logits(params, x, cfg), aux


def _lm_logits(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = L.embedding_logits(params["embed"], x)
    else:
        logits = L.dense(params["lm_head"], x)
    return shard(logits, "batch", None, "vocab")


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            vocab_chunk: int = 0):
    """-> (total, metrics): the mean CE over labeled positions plus the
    MoE's balance and z losses, and {"ce", "balance", "z", "dropped"}.
    Differentiable (``launch/steps.py`` takes its gradients with
    ``torch.autograd.grad``). batch["labels"] [B,T_l], batch["loss_mask"]
    optional. ``vocab_chunk`` > 0 computes CE from hidden states in
    sequence chunks so [B,T,V] logits are never materialized at once."""
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    hidden, aux = lm_forward(params, batch, cfg, return_hidden=True)
    # align hidden to labels (vlm: labels only cover the text tail)
    t_l = labels.shape[1]
    h = hidden[:, -t_l:, :]
    if vocab_chunk and t_l > vocab_chunk:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(t_l // vocab_chunk):
            sl = slice(i * vocab_chunk, (i + 1) * vocab_chunk)
            ce = _ce(_lm_logits(params, h[:, sl], cfg).float(), labels[:, sl])
            if mask is not None:
                tot, cnt = tot + (ce * mask[:, sl]).sum(), \
                    cnt + mask[:, sl].sum()
            else:
                tot, cnt = tot + ce.sum(), cnt + ce.numel()
        loss = tot / torch.clamp(cnt, min=1.0)
    else:
        ce = _ce(_lm_logits(params, h, cfg).float(), labels)
        if mask is not None:
            loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = ce.mean()
    total = loss + aux["balance"] + aux["z"]
    return total, {"ce": loss, **aux}


def _ce(logits, labels):
    """Per-token CE. On DTensors a local region over the batch rows, the
    vocab whole: the gather's backward then zeros a rank's own rows, where
    DTensor's makes a replicated tensor of the global shape on every rank
    (kimi-k2 train_4k: 80 GiB a rank)."""
    def ce(lg, lb):
        logz = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, lb[..., None].long())[..., 0]
        return logz - gold

    if not is_dtensor(logits):
        return ce(logits, labels)
    b0 = batch_entry(logits.device_mesh, logits.shape[0])
    return local_region(ce, [(logits, (b0, None, None)),
                             (labels, (b0, None))], [(b0, None)])


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    """Stacked per-layer caches [L, ...] + a shared 0-d int32 position.
    The KV and conv caches are ``dtype`` (bf16, as the reference's default,
    whatever ``cfg.dtype``); the SSM state is float32."""
    dev = resolve_device(device)
    cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32,
                                                device=dev)}
    lcache: Dict[str, Any] = {}
    if cfg.family in ATTN_FAMILIES:
        s = max_len if cfg.sliding_window is None else min(
            max_len, cfg.sliding_window)
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        lcache["kv"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                        "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        lcache["ssm_block"] = {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                                 cfg.conv_dim), dtype=dtype, device=dev),
            "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                                cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=dev),
        }
    cache["layers"] = lcache
    return cache


def decode_step(params, cache: Dict, token: torch.Tensor, cfg: ModelConfig):
    """One serving step: token [B,1] int -> (logits [B,V], new cache). The
    cache passed in is left as it was."""
    x = L.embedding_lookup(params["embed"], token).to(cfg.torch_dtype)
    x = shard(x, "batch", None, "act_embed")
    pos = cache["pos"]
    quant = cfg.quant_spec()
    new_layers = []
    for i in range(cfg.n_layers):
        x, _, new_lc = _layer(_layer_slice(params["layers"], i), x, cfg,
                              None, quant,
                              cache=_layer_slice(cache["layers"], i),
                              pos_scalar=pos)
        new_layers.append(new_lc)
    x = _apply_norm(params["final_norm"], x, cfg)
    logits = _lm_logits(params, x, cfg)[:, 0]
    return logits, {"pos": pos + 1, "layers": stack_layer_params(new_layers)}


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """Greedy decode. prompt: [B, T0] -> int32 tokens [B, T0+steps], on the
    prompt's device. The prompt is prefilled by stepping, as the
    reference's; ties in the argmax go to the lowest id in both."""
    b, t0 = prompt.shape
    cache = init_cache(cfg, b, t0 + steps + 1, device=prompt.device)
    toks = prompt.to(torch.int32)
    logits = None
    for i in range(t0):
        logits, cache = decode_step(params, cache, toks[:, i:i + 1], cfg)
    for _ in range(steps):
        nxt = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        toks = torch.cat([toks, nxt], dim=1)
        logits, cache = decode_step(params, cache, nxt, cfg)
    return toks


# ---------------------------------------------------------------------------
# Photonic serving storage (the Lightator deployment mode)
# ---------------------------------------------------------------------------

def quantize_lm_params(params, cfg: ModelConfig, spec: WASpec) -> Dict:
    """Float params -> MR storage: every projection becomes {wq, ws}.

    Per-(layer, out-channel) symmetric quantization over the contraction
    axis (-2), so the stacked [L, ...] structure is kept; the divisions are
    IEEE (``quant.true_div``), as the reference's eager ones. The carrier
    is int8: torch has no int4 arithmetic, so where the reference packs
    [4:*] weights in ``jnp.int4`` the port holds the same values in int8.
    Norms, embeddings and the SSM's conv/dt params stay float (they live in
    the electronic part of the architecture); the MoE router too. The MoE's
    stacked experts (raw [L, E, d, f] tensors named ``w_gate`` / ``w_up``
    / ``w_down``) become {wq, ws} as well, one scale per (layer, expert,
    out-channel). Each [d, f] matrix is quantized on its own (bitwise the
    same, as the scale reduces axis -2 only), so the float32 and float64
    temporaries stay one matrix large: kimi-k2's expert stack is 5.6 G
    weights a layer.
    """
    def mr_quantize(w):
        if w.ndim > 2:
            q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
            s = torch.empty(w.shape[:-2] + (1, w.shape[-1]),
                            dtype=torch.float32, device=w.device)
            for i in range(w.shape[0]):
                q[i], s[i] = mr_quantize(w[i])
            return q, s
        w32 = w.float()
        amax = w32.abs().amax(dim=-2, keepdim=True)
        floor = torch.full((), 1e-8, dtype=torch.float32, device=w.device)
        s = true_div(torch.maximum(amax, floor), spec.w_qmax)
        q = _clip(torch.round(true_div(w32, s)), -spec.w_qmax, spec.w_qmax)
        return q.to(torch.int8), s

    def transform(node, path=()):
        if not isinstance(node, dict):
            if path and path[-1] in MOE_EXPERTS and node.ndim >= 3:
                q, s = mr_quantize(node)
                return {"wq": q, "ws": s}
            return node
        out = {}
        for k, v in node.items():
            if k == "w" and path and path[-1] in PROJECTIONS:
                out["wq"], out["ws"] = mr_quantize(v)
            else:
                out[k] = transform(v, path + (k,))
        return out

    return transform(params)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (no allocation)."""
    d, v = cfg.d_model, cfg.vocab
    n = v * d                                   # embedding
    if cfg.frontend != "none":
        n += cfg.frontend_dim * d + d
    per = d                                     # norm1
    if cfg.family in ATTN_FAMILIES:
        per += d * cfg.attn_dim + 2 * d * cfg.kv_dim + cfg.attn_dim * d
    if cfg.family in ("ssm", "hybrid"):
        di, h = cfg.d_inner, cfg.ssm_heads
        gn = cfg.ssm_groups * cfg.ssm_state
        per += d * (2 * di + 2 * gn + h)        # in_proj
        per += cfg.conv_kernel * cfg.conv_dim + cfg.conv_dim
        per += 3 * h + di + di * d              # dt/a/D, norm, out_proj
        if cfg.family == "hybrid":
            per += 2 * d
    if cfg.family != "ssm":
        per += d                                # norm2
        if cfg.family == "moe":
            per += d * cfg.n_experts
            per += cfg.n_experts * (3 * d * cfg.d_ff)
        else:
            n_mats = 3 if cfg.ffn == "swiglu" else 2
            per += n_mats * d * cfg.d_ff
    n += cfg.n_layers * per + d                 # final norm
    if not cfg.tie_embeddings:
        n += d * v
    return n


def active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: only top_k experts)."""
    if cfg.family != "moe":
        return count_params(cfg)
    expert = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert
    return count_params(cfg) - inactive


def model_flops(cfg: ModelConfig, seq: int, batch: int,
                train: bool = True, decode: bool = False) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N_active*D (inference) + attention."""
    tokens = batch * (1 if decode else seq)
    flops = (6 if train else 2) * active_params(cfg) * tokens
    # attention scores/values: 2 * 2 * T * S * H * dh per token pair set
    if cfg.family in ATTN_FAMILIES:
        s_ctx = seq
        if cfg.sliding_window is not None:
            s_ctx = min(seq, cfg.sliding_window)
        att = 4 * cfg.n_heads * cfg.head_dim * s_ctx * tokens * cfg.n_layers
        flops += att * (3 if train else 1)
    return float(flops)
