"""Wrapper of the fused conv-chain kernel (``csrc/conv_chain.cu``).

A CUDA tensor launches the kernel: one block per frame runs every stage of
the segment with the frame held in shared memory. A CPU tensor takes the
plain version (``ref.conv_chain_ref``). There is no fallback between the
two: a segment whose frames do not fit a block's shared memory, or whose
accumulate could leave float32's exact integers, raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv_bank.ref import conv_chain_ref

LAUNCHES = _build.LaunchCounter("conv_chain")
MAX_STAGES = 16                 # csrc/conv_chain.cu: kMaxStages
SMEM_PER_BLOCK = 232448         # H100: 227 KB a block can opt into
REDUCE_SCRATCH = 32 * 4         # block-max scratch after the two buffers
ACTS = {"none": 0, "relu": 1, "abs": 2, "sign": 3}
POOLS = {None: 0, "max": 1, "avg": 2}
EXACT_F32 = 1 << 24             # float32 holds every integer below this


class _Stage(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("ws", ctypes.c_void_p),
                ("bias", ctypes.c_void_p)] + [
        (f, ctypes.c_int) for f in (
            "h_in", "w_in", "c_in", "c_out", "k", "stride", "pad_top",
            "pad_left", "h_conv", "w_conv", "h_out", "w_out", "pool_kind",
            "pool_size", "depthwise", "act", "has_bias", "pad_")]


class _Chain(ctypes.Structure):
    _fields_ = [("n_stages", ctypes.c_int), ("buf1_offset", ctypes.c_int),
                ("red_offset", ctypes.c_int), ("pad_", ctypes.c_int),
                ("stages", _Stage * MAX_STAGES)]


_SIGNATURES = {"conv_chain_launch": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p)}


def smem_layout(geoms: Sequence) -> tuple:
    """(buffer-1 offset, scratch offset, total bytes) of the kernel's shared
    memory; offsets in floats.

    Stage i reads the frame in buffer i % 2 and writes its pooled output
    into the other buffer, so buffer 0 holds the even inter-stage frames
    and buffer 1 the odd ones; a block-max scratch follows them.
    """
    sizes = [geoms[0].h_in * geoms[0].w_in * geoms[0].c_in]
    for g in geoms:
        h, w = g.out_hw()
        sizes.append(h * w * g.c_out)
    buf0 = max(sizes[0::2])
    buf1 = max(sizes[1::2])
    return buf0, buf0 + buf1, (buf0 + buf1) * 4 + REDUCE_SCRATCH


def check_exact(stages: Sequence, a_qmax) -> None:
    """Raise ``ValueError`` unless every stage's accumulate stays an exact
    float32 integer: ``a_qmax * max|level| * k*k*c_in/groups < 2^24``.

    The kernel sums codes (0..a_qmax) times levels in float32 with
    ``fmaf``; the plain version sums in float64. They agree bit for bit
    only while no partial sum can reach 2^24. An int8 weight tensor is
    bounded by its dtype (|level| <= 128) without reading it; only where
    that bound is too loose, or the levels are not int8, is the largest
    level read from the tensor.
    """
    for g, wq, _, _ in stages:
        fan_in = g.kernel * g.kernel * (g.c_in // g.groups)
        if wq.dtype == torch.int8 and a_qmax * 128 * fan_in < EXACT_F32:
            continue
        w_max = float(wq.abs().max()) if wq.numel() else 0.0
        if a_qmax * w_max * fan_in >= EXACT_F32:
            raise ValueError(
                f"conv_chain: stage {g.name} can accumulate up to "
                f"{a_qmax:g} * {w_max:g} * {fan_in} = "
                f"{a_qmax * w_max * fan_in:g}, not below 2^24: the kernel's "
                f"float32 sum would round where the plain version's does not")


def conv_chain(codes: torch.Tensor, act_scale, stages: Sequence, a_qmax):
    """One fused segment: codes [B, H, W, Cin] -> (codes [B, H', W', Cout],
    scale [B, 1, 1, 1]), bitwise equal to ``conv_chain_ref``.

    ``stages``: ``(geom: dispatch.ChainGeom, wq, ws, bias)``; ``act_scale``
    is the incoming CRC scale, 0-d or [B, 1, 1, 1]; ``a_qmax`` the CRC
    divisor, which also bounds the incoming codes (0..a_qmax).
    """
    if not codes.is_cuda:
        return conv_chain_ref(codes, act_scale, stages, a_qmax)
    if codes.ndim != 4:
        raise ValueError(f"conv_chain: codes must be [B, H, W, C], got "
                         f"{tuple(codes.shape)}")
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"conv_chain: {len(stages)} stages; the kernel "
                         f"takes 1..{MAX_STAGES}")
    dev = codes.device
    b, h, w, c = codes.shape
    geoms = [g for g, _, _, _ in stages]
    if (h, w, c) != (geoms[0].h_in, geoms[0].w_in, geoms[0].c_in):
        raise ValueError(f"conv_chain: frame {(h, w, c)} does not match the "
                         f"first stage's input {geoms[0]}")
    buf1_offset, red_offset, smem = smem_layout(geoms)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"conv_chain: segment {[g.name for g in geoms]} needs {smem} "
            f"bytes of shared memory per frame; a block has {SMEM_PER_BLOCK}")
    check_exact(stages, a_qmax)
    x = codes.to(torch.float32).contiguous()
    scale_in = torch.as_tensor(act_scale, dtype=torch.float32, device=dev)
    scale_in = scale_in.reshape(-1).expand(b).contiguous()
    chain = _Chain(n_stages=len(stages), buf1_offset=buf1_offset,
                   red_offset=red_offset)
    keep = []                   # operands stay alive until the launch
    for i, (g, wq, ws, bias) in enumerate(stages):
        if g.groups != 1 and not g.depthwise:
            raise ValueError(f"conv_chain: {g.name} is a grouped conv, "
                             f"which the chain does not take")
        wf = wq.to(device=dev, dtype=torch.float32).contiguous()
        wsf = ws.to(device=dev, dtype=torch.float32).reshape(-1) \
            .expand(g.c_out).contiguous()
        bf = (None if bias is None else
              bias.to(device=dev, dtype=torch.float32).reshape(-1)
              .contiguous())
        keep += [wf, wsf, bf]
        (plo, _), (qlo, _) = g.pads
        h_conv, w_conv = g.conv_hw()
        h_out, w_out = g.out_hw()
        st = chain.stages[i]
        st.w, st.ws = wf.data_ptr(), wsf.data_ptr()
        st.bias = None if bf is None else bf.data_ptr()
        st.h_in, st.w_in, st.c_in, st.c_out = g.h_in, g.w_in, g.c_in, g.c_out
        st.k, st.stride, st.pad_top, st.pad_left = g.kernel, g.stride, plo, qlo
        st.h_conv, st.w_conv, st.h_out, st.w_out = h_conv, w_conv, h_out, w_out
        st.pool_kind = POOLS[g.pool[0] if g.pool is not None else None]
        st.pool_size = g.pool[1] if g.pool is not None else 1
        st.depthwise, st.act = int(g.depthwise), ACTS[g.act]
        st.has_bias = int(bf is not None)
    h_out, w_out = geoms[-1].out_hw()
    out = torch.empty((b, h_out, w_out, geoms[-1].c_out),
                      dtype=torch.float32, device=dev)
    scale_out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b > 0:
        lib = _build.library("conv_chain", _SIGNATURES)
        err = lib.conv_chain_launch(
            x.data_ptr(), scale_in.data_ptr(), float(a_qmax), out.data_ptr(),
            scale_out.data_ptr(), ctypes.addressof(chain), b, h * w * c,
            smem, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "conv_chain")
        LAUNCHES.inc()
    return out, scale_out.reshape(b, 1, 1, 1)
