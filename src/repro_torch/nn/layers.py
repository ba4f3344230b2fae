"""Core layers: dense (photonic-quantizable), embedding, norms, conv.

``dense`` is the projection primitive the models route through; its
``quant`` argument turns on the Lightator path:

  quant=None                    plain float matmul — the non-photonic
                                baseline
  quant=WASpec, mode="fake"     QAT fake-quant (STE) — training the paper's
                                way
  quant=WASpec, mode="qweights" weight-only quantized storage (int carriers
                                dequantized on the fly)
  quant=WASpec, mode="kernel"   the photonic_mvm kernel (integer MAC on
                                signed CRC codes)

Params are dicts of tensors in the reference's layouts: dense ->
``{"w": [in, out](, "b": [out])}``, quantized storage ``{"wq": int8
[in, out], "ws": [1, out]}``; conv -> ``{"w": HWIO, "b": [out]}`` on NHWC
activations. The float products are ``torch.matmul`` and ``F.conv2d``;
the caller runs them with TF32 off (``conv_bank.ref.float32_convs``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.accelerator import window_mean
from repro_torch.core.plan import padtype_to_pads
from repro_torch.distributed import sharding
from repro_torch.core.quant import (WASpec, fake_quant_act, fake_quant_weight,
                                    quantize_weight)
from repro_torch.kernels.photonic_mvm.ops import photonic_mvm
from repro_torch.nn.module import normal_init, scaled_init

CONV_ACT_SCALE = 1.0 / 15.0     # conv2d's fixed CRC step, as the reference's


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, dtype=torch.float32,
               stddev: Optional[float] = None):
    init = normal_init(stddev) if stddev is not None else scaled_init(d_in)
    p = {"w": init(generator, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def _signed_fake_act(x: torch.Tensor, scale, a_bits: int) -> torch.Tensor:
    """The BPD trick for signed activations (two VCSEL rails): quantize
    |x| and reapply the sign."""
    return torch.sign(x) * fake_quant_act(x.float().abs(), scale=scale,
                                          a_bits=a_bits)


def dense(params, x: torch.Tensor, quant: Optional[WASpec] = None,
          mode: str = "fake", act_scale: float = 1.0 / 15.0) -> torch.Tensor:
    """x: [..., d_in] -> [..., d_out]."""
    if "wq" in params or (quant is not None and mode == "qweights"):
        # photonic serving storage: int-carrier weights + per-channel scales
        w = params["wq"].to(x.dtype) * params["ws"].to(x.dtype)
        y = x @ w
    elif quant is None:
        # operands of two dtypes promote, as jnp.matmul's do
        dt = torch.promote_types(x.dtype, params["w"].dtype)
        y = x.to(dt) @ params["w"].to(dt)
    elif mode == "fake":
        w = fake_quant_weight(params["w"].float(), quant)
        y = (_signed_fake_act(x, act_scale, quant.a_bits) @ w).to(x.dtype)
    elif mode == "kernel":
        y = photonic_mvm(x, params["w"], quant, act_scale=act_scale)
    else:
        raise ValueError(f"unknown quant mode {mode}")
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def quantize_dense_params(params, spec: WASpec):
    """Convert float dense params to photonic serving storage (wq int8 +
    ws)."""
    wq, ws = quantize_weight(params["w"], spec)
    out = {"wq": wq, "ws": ws.float()}
    if "b" in params:
        out["b"] = params["b"]
    return out


# ---------------------------------------------------------------------------
# Activations (JAX's, op by op)
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: x * (1 / (1 + exp(-x))), each
    op rounded to ``x``'s dtype (``F.silu`` rounds once, which in bf16
    differs on a quarter of the values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default) op by op in ``x``'s
    dtype, its constants rounded to that dtype first, as JAX rounds a
    Python scalar to the array's dtype (``F.gelu`` rounds once)."""
    c0 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype,
                      device=x.device)
    c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x * (x * x)))))
    return x * cdf


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32):
    return {"table": normal_init(1.0)(generator, (vocab, d_model), dtype)}


def embedding_lookup(params, ids: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if sharding.is_dtensor(table):
        return _embedding_lookup_sharded(table, ids)
    return table[ids]


def _embedding_lookup_sharded(table, ids):
    """``table[ids]`` of a DTensor table as GSPMD partitions a gather from
    a vocab-sharded table: each rank looks its batch rows' ids up in its
    own vocab rows (the table whole on its other dims first, an all-gather
    over "data" under FSDP), zero where an id lies outside them, and one
    all-reduce over the vocab's mesh dims sums the parts (a value plus
    zeros: exact). Each rank's backward scatters into its own rows only
    (DTensor's own strategy for the indexing backward fails on some
    versions, and this keeps the single-device op on the local
    tensors)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    t_place = [Shard(0) if p.is_shard(0) else Replicate()
               for p in table.placements]
    b0 = sharding.batch_entry(mesh, ids.shape[0])
    ids_place = sharding.placements((b0,) + (None,) * (ids.ndim - 1), mesh)
    splitting = {i for i, p in enumerate(ids_place) if p.is_shard()}
    grad = [Partial() if p.is_replicate() and i in splitting else p
            for i, p in enumerate(t_place)]
    local_t = sharding.redistribute(table, t_place).to_local(
        grad_placements=grad)
    if sharding.is_dtensor(ids):
        local_ids = sharding.redistribute(ids, ids_place).to_local()
    else:
        local_ids = ids[sharding.local_slices(ids.shape, mesh, ids_place)]
    lo = sharding.local_slices(table.shape, mesh, t_place)[0].start
    n = local_t.shape[0]
    rows = local_t[(local_ids - lo).clamp(0, n - 1)]
    mine = ((local_ids >= lo) & (local_ids < lo + n))[..., None]
    part = torch.where(mine, rows, torch.zeros_like(rows))
    out_place = [Partial() if t.is_shard() else q
                 for t, q in zip(t_place, ids_place)]
    shape = tuple(ids.shape) + (table.shape[1],)
    out = DTensor.from_local(part, mesh, out_place, run_check=False,
                             shape=shape,
                             stride=sharding.contiguous_stride(shape))
    return out.redistribute(mesh, [Replicate() if t.is_shard() else q
                                   for t, q in zip(t_place, ids_place)])


def embedding_logits(params, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: x [..., d] @ table.T -> [..., vocab]."""
    return x @ params["table"].T


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(generator: torch.Generator, dim: int, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(generator: torch.Generator, dim: int, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype),
            "bias": torch.zeros((dim,), dtype=dtype)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Conv2D (vision models; NHWC activations, HWIO weights)
# ---------------------------------------------------------------------------

def init_conv2d(generator: torch.Generator, k: int, c_in: int, c_out: int,
                bias: bool = True, dtype=torch.float32):
    p = {"w": scaled_init(k * k * c_in)(generator, (k, k, c_in, c_out),
                                        dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype)
    return p


def conv2d(params, x: torch.Tensor, stride: int = 1, padding: str = "SAME",
           quant: Optional[WASpec] = None) -> torch.Tensor:
    """XLA's ``conv_general_dilated`` (NHWC x HWIO, ``padding`` SAME or
    VALID) as ``F.conv2d``; with ``quant``, fake-quantized weights and
    sign * |x| CRC activations at the fixed 1/15 step."""
    w = params["w"]
    if quant is not None:
        w = fake_quant_weight(w.float(), quant).to(x.dtype)
        x = _signed_fake_act(x, CONV_ACT_SCALE, quant.a_bits).to(x.dtype)
    (plo, phi), (qlo, qhi) = padtype_to_pads(x.shape[1:3], w.shape[0],
                                             stride, padding)
    xp = F.pad(x, (0, 0, qlo, qhi, plo, phi)).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def max_pool2d(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """Max over each window, ties sharing the gradient evenly (``amax``, as
    the reference's ``max``; ``F.max_pool2d`` gives it to one)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // size, size, w // size, size, c).amax(dim=(2, 4))


def avg_pool2d(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """Mean over each window, summed in the reference's order
    (``accelerator.window_mean``)."""
    b, h, w, c = x.shape
    return window_mean(x.reshape(b, h // size, size, w // size, size, c))
