"""Wrapper of the plan executor's fused epilogue (``csrc/epilogue.cu``).

One call is one step's dequant -> bias -> activation -> pool -> CRC
requant (``ref.epilogue_ref`` says what), as two kernels: pass 1 stores
the pooled output y and reduces its max into per-block partials, pass 2
turns them into the scale and writes y's codes, as float32 or straight
into the next int8 conv's uint8 operand. A call counts one launch on
``LAUNCHES`` (the pair).

A CUDA tensor launches the kernels; a CPU tensor takes the plain version.
There is no fallback between the two: an activation the kernel does not
take (tanh) raises on the card (the plan keeps such steps on the torch
ops, ``CompiledPlan.torch_epilogues``). A NaN or an inf in the inputs
comes out as the plain version's does (a NaN scale and NaN codes,
``edge_shapes.EPILOGUE_NAN_EDGES``); in the uint8 operand the kernel
writes a NaN code as the byte 0.

:func:`epilogue_config` picks the launch from the shape alone (tested on
the CPU): 4 channels a thread where they are 16-byte aligned, and the
blocks a frame that give a batch about ``TARGET_BLOCKS`` blocks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import ACT_BITS
from repro_torch.kernels import _build
from repro_torch.kernels.conv_bank.fused import ACTS
from repro_torch.kernels.epilogue.ref import epilogue_ref

LAUNCHES = _build.LaunchCounter("epilogue")
_SIGNATURES = {
    "epilogue_reduce_launch": (ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p),
    "epilogue_quant_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p)}
POOLS = {"max": 1, "avg": 2}
THREADS = 256                   # a block (kThreads)
TARGET_BLOCKS = 132 * 8         # a batch's blocks a pass: 8 a SM
UNITS_PER_THREAD = 4            # fewest units a thread before a block more
CODE_MAX = (1 << ACT_BITS) - 1


class _Epi(ctypes.Structure):
    """``struct Epi`` of ``csrc/epilogue.cu``, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("ws", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("partials", ctypes.c_void_p),
                ("xs", ctypes.c_longlong), ("n", ctypes.c_longlong)] + [
        (f, ctypes.c_int) for f in ("batch", "scale_n", "ws_n", "bias_n",
                                    "act", "pool_kind", "p", "w_in", "c",
                                    "w_out", "nblk1")]


class _Quant(ctypes.Structure):
    """``struct Quant`` of ``csrc/epilogue.cu``, field for field."""
    _fields_ = [("amax", ctypes.c_void_p), ("scale_out", ctypes.c_void_p),
                ("codes", ctypes.c_void_p), ("operand", ctypes.c_void_p),
                ("aq", ctypes.c_float)] + [
        (f, ctypes.c_int) for f in ("per_frame", "code_max", "hp", "wp",
                                    "cp", "top", "left", "h", "nblk2")]


@dataclass(frozen=True)
class EpilogueConfig:
    """One call's launch: ``vec`` channels a unit (4 or 1), and pass 1's
    and pass 2's blocks a frame."""
    vec: int
    nblk1: int
    nblk2: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocks(units: int, batch: int) -> int:
    return max(1, min(_cdiv(TARGET_BLOCKS, batch),
                      _cdiv(units, THREADS * UNITS_PER_THREAD)))


@functools.lru_cache(maxsize=1024)
def epilogue_config(batch: int, n: int, c: int, aligned: bool,
                    operand_words: int = 0) -> EpilogueConfig:
    """The launch for ``batch`` frames of ``n`` pooled elements of ``c``
    channels: 4 channels a unit where ``c`` is a multiple of 4 and the
    frames are 16-byte ``aligned``; the pass-2 units are the operand's
    4-byte words where it writes ``operand_words`` of them a frame."""
    vec = 4 if c % 4 == 0 and aligned else 1
    units2 = operand_words or n // vec
    return EpilogueConfig(vec, _blocks(n // vec, batch),
                          _blocks(units2, batch))


def _frames(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each frame contiguous (a frame stride of its own is
    kept: the strip route's row slice comes as it is)."""
    want, acc = [], 1
    for d in reversed(x.shape[1:]):
        want.append(acc)
        acc *= d
    if list(x.stride()[1:]) == want[::-1]:
        return x
    return x.contiguous()


def _flat(t: Optional[torch.Tensor], counts, what: str, dev):
    if t is None:
        return None
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"epilogue: {what} must be a tensor on {dev}")
    if t.numel() not in counts:
        raise ValueError(f"epilogue: {what} has {t.numel()} values, not "
                         f"one of {sorted(set(counts))}")
    return t.reshape(-1).to(torch.float32).contiguous()


@dataclass(frozen=True)
class Geometry:
    """One call's shapes: ``b`` frames of x, ``xs`` floats apart, pooled
    by ``p`` into ``y_shape`` (``n`` elements a frame of ``c`` channels,
    ``w_out`` columns); the operand's [b, hp, wp, cp] with the border
    ``top`` / ``left`` and ``op_words`` 4-byte words a frame, or 0s."""
    b: int
    c: int
    p: int
    pool_kind: int
    w_in: int
    w_out: int
    y_shape: tuple
    n: int
    xs: int
    aligned: bool
    hp: int = 0
    wp: int = 0
    cp: int = 0
    top: int = 0
    left: int = 0
    op_words: int = 0


def geometry(x: torch.Tensor, pool: Optional[Tuple[str, int]] = None,
             operand=None) -> Geometry:
    """The shapes of one call on ``x`` (each frame contiguous; see
    :func:`launch`); raises on a pool or an operand ``x`` cannot take."""
    from repro_torch.kernels.conv_bank.strip import igemm_c_in
    b, c = x.shape[0], x.shape[-1]
    kind, p = pool if pool is not None else (None, 1)
    if pool is not None and (kind not in POOLS or x.ndim != 4 or
                             x.shape[1] % p or x.shape[2] % p):
        raise ValueError(f"epilogue: {pool} pooling of {tuple(x.shape)}")
    if operand is not None and x.ndim != 4:
        raise ValueError(f"epilogue: an operand from {tuple(x.shape)}")
    spatial = x.ndim == 4
    h_out, w_out = (x.shape[1] // p, x.shape[2] // p) if spatial else (1, 1)
    y_shape = (b, h_out, w_out, c) if spatial else tuple(x.shape)
    n = 1
    for d in y_shape[1:]:
        n *= d
    if n == 0 or b == 0:
        raise ValueError(f"epilogue: nothing to requantize in "
                         f"{tuple(x.shape)}")
    xs = x.stride(0) if b > 1 else n * p * p
    g = Geometry(b, c, p, POOLS.get(kind, 0), x.shape[2] if spatial else 1,
                 w_out, y_shape, n, xs, x.data_ptr() % 16 == 0 and
                 xs % 4 == 0)
    if operand is None:
        return g
    k, ((top, bottom), (left, right)) = operand
    cp = igemm_c_in(c, k)
    hp, wp = h_out + top + bottom, w_out + left + right
    return dataclasses.replace(g, hp=hp, wp=wp, cp=cp, top=top, left=left,
                               op_words=hp * wp * cp // 4)


def launch(x: torch.Tensor, act_scale, ws, bias, act: str,
           pool: Optional[Tuple[str, int]], a_qmax, per_frame: bool,
           reduce_max, operand):
    """Launch the pair on CUDA tensors and count it on ``LAUNCHES``."""
    if act not in ACTS:
        raise ValueError(f"epilogue: the kernel takes act in {tuple(ACTS)}, "
                         f"not {act!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"epilogue: x is {x.dtype}, not float32")
    dev = x.device
    x = _frames(x)
    g = geometry(x, pool, operand)
    b, c, n = g.b, g.c, g.n
    s = _flat(act_scale, (1, b), "act_scale", dev)
    w = _flat(ws, (1, c), "ws", dev)
    bi = _flat(bias, (1, c), "bias", dev)
    cfg = epilogue_config(b, n, c, g.aligned, g.op_words)
    f32 = dict(dtype=torch.float32, device=dev)
    partials = torch.empty((b, cfg.nblk1), **f32)
    ybuf = torch.empty((b, n), **f32)
    scale = torch.empty((b if per_frame else 1,), **f32)
    if operand is not None:
        out = torch.empty((b, g.hp, g.wp, g.cp), dtype=torch.uint8,
                          device=dev)
    else:
        out = torch.empty(g.y_shape, **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    epi = _Epi(x.data_ptr(), ptr(s), ptr(w), ptr(bi), ybuf.data_ptr(),
               partials.data_ptr(), g.xs, n, b, 0 if s is None else s.numel(),
               0 if w is None else w.numel(), 0 if bi is None else bi.numel(),
               ACTS[act], g.pool_kind, g.p, g.w_in, c, g.w_out, cfg.nblk1)
    lib = _build.library("epilogue", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.epilogue_reduce_launch(ctypes.byref(epi), cfg.vec,
                                            stream), "epilogue pass 1")
    amax = None
    if reduce_max is not None and not per_frame:
        # one max over every shard of the batch (``Options.shard_batch``)
        amax = reduce_max(partials.amax()).to(**f32).reshape(1).contiguous()
    aq = a_qmax if a_qmax is not None else float(CODE_MAX)
    if isinstance(aq, torch.Tensor):
        raise TypeError("epilogue: a_qmax is the plan's constant, a float")
    quant = _Quant(ptr(amax), scale.data_ptr(),
                   None if operand is not None else out.data_ptr(),
                   out.data_ptr() if operand is not None else None,
                   float(aq), int(per_frame), CODE_MAX, g.hp, g.wp, g.cp,
                   g.top, g.left, g.y_shape[1] if len(g.y_shape) == 4 else 1,
                   cfg.nblk2)
    _build.check(lib.epilogue_quant_launch(ctypes.byref(epi),
                                           ctypes.byref(quant), cfg.vec,
                                           stream), "epilogue pass 2")
    LAUNCHES.inc()
    scale = scale.reshape((b,) + (1,) * (len(g.y_shape) - 1)) if per_frame \
        else scale.reshape(())
    return out, scale


def epilogue(x: torch.Tensor, act_scale: Optional[torch.Tensor] = None,
             ws: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, act: str = "none",
             pool: Optional[Tuple[str, int]] = None, a_qmax=None,
             per_frame: bool = False, reduce_max=None, operand=None):
    """One step's epilogue: ``x`` float32 [B, ...] (a conv's [B, H, W, C]
    or a dense layer's [B, N] accumulate with its ``act_scale`` (0-d or
    one a frame), ``ws`` (one or one a channel), ``bias``, ``act`` and
    ``pool``; or, without ``act_scale``, a tensor to requantize as it is)
    -> ``(codes, scale)`` bitwise equal to :func:`ref.epilogue_ref`: float32
    codes in the pooled shape, or with ``operand=(k, pads)`` the uint8
    operand of the next k x k conv on the int8 strip route
    (``strip.int_codes``' form)."""
    if not x.is_cuda:
        return epilogue_ref(x, act_scale, ws, bias, act, pool, a_qmax,
                            per_frame, reduce_max, operand)
    return launch(x, act_scale, ws, bias, act, pool, a_qmax, per_frame,
                  reduce_max, operand)
