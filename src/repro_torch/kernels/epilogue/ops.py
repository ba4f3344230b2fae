"""Wrapper of the plan executor's fused epilogue (``csrc/epilogue.cu``).

One call is one step's dequant -> bias -> activation -> pool -> CRC
requant (``ref.epilogue_ref`` says what), written as float32 codes or
straight into the next int8 conv's uint8 operand, in one of three forms
(:func:`epilogue_config` picks from the shape alone, tested on the CPU):

* one launch, a thread-block cluster a frame (``epi_cluster_kernel``),
  where the calibration is per frame (or the batch one frame) and the
  pooled frame is of ``CLUSTER_MIN``..``CLUSTER_MAX`` elements;
* the pair: pass 1 writes y and each block's max of it, pass 2 turns the
  maxima into the scale and writes the codes of the stored y;
* the fold (:func:`epilogue_fold`): a dense conv on the int8 strip route
  whose store does pass 1 (``strip.launch_int(fold=)``), then pass 2
  alone (:func:`quant_folded`).

A call counts one launch on ``LAUNCHES`` (the pair's two kernels, the
cluster kernel, the fold's pass 2), and one on ``FORMS[form]`` where it
launches outside a graph capture (a replay credits no form).

A CUDA tensor launches the kernels; a CPU tensor takes the plain version.
There is no fallback between the two: an activation the kernel does not
take (tanh) raises on the card (the plan keeps such steps on the torch
ops, ``CompiledPlan.torch_epilogues``). A NaN or an inf in the inputs
comes out as the plain version's does (a NaN scale and NaN codes,
``edge_shapes.EPILOGUE_NAN_EDGES``); in the uint8 operand the kernel
writes a NaN code as the byte 0.
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
FORMS = {f: _build.LaunchCounter(f"epilogue.{f}")
         for f in ("pair", "cluster", "fold")}
_SIGNATURES = {
    "epilogue_reduce_launch": (ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p),
    "epilogue_quant_launch": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p),
    "epilogue_cluster_launch": (ctypes.c_void_p, ctypes.c_void_p) + (
        ctypes.c_int,) * 3 + (ctypes.c_void_p,)}
POOLS = {"max": 1, "avg": 2}
THREADS = 256                   # a block (kThreads)
TARGET_BLOCKS = 132 * 8         # a batch's blocks a pass: 8 a SM
UNITS_PER_THREAD = 4            # fewest units a thread before a block more
CODE_MAX = (1 << ACT_BITS) - 1
# the cluster form's sizes and range, from the card's times of every form
# at the path's calls (PERF.md, the epilogue's forms): pooled frames of
# CLUSTER_MIN to CLUSTER_MAX elements, about CLUSTER_SLICE a CTA in a
# cluster of CLUSTERS (fewer than 4 CTAs a frame were slower; 16 is one of
# the H100's non-portable sizes); the pair was faster below (two short
# launches beat one cluster launch) and above (more CTAs in flight than 16
# a frame)
CLUSTERS = (4, 8, 16)
CLUSTER_MIN, CLUSTER_MAX = 1025, 65536
CLUSTER_SLICE = 2048
CLUSTER_SCRATCH = 32            # floats after a cluster CTA's slice
SMEM_MAX = 232448               # bytes of shared memory a CTA can opt into
FRAME_MAX = 1 << 31             # floats of x a frame: 32-bit offsets


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
    """One call's launch: ``vec`` elements a unit (4 or 1); ``cluster``
    CTAs a frame with ``smem`` bytes of shared memory each for the
    one-launch form, or 0 for the pair (or the fold's pass 2), with pass
    1's and pass 2's blocks a frame."""
    vec: int
    nblk1: int = 0
    nblk2: int = 0
    cluster: int = 0
    smem: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocks(units: int, batch: int) -> int:
    return max(1, min(_cdiv(TARGET_BLOCKS, batch),
                      _cdiv(units, THREADS * UNITS_PER_THREAD)))


def pixel_group(c: int, vec: int) -> int:
    """Pixels of ``c`` channels whose elements fill whole ``vec``-units: a
    cluster CTA's slice of an operand-writing frame is a run of them."""
    return 1 if vec == 1 or c % 4 == 0 else (4 if c % 2 else 2)


def cluster_slice(n: int, c: int, vec: int, cluster: int,
                  operand: bool) -> int:
    """The most elements of y one CTA of a ``cluster`` holds: whole units
    of ``vec``, and for an operand whole groups of pixels
    (:func:`pixel_group`), the frame's ``n`` split evenly."""
    if operand:
        gp = pixel_group(c, vec)
        return _cdiv(_cdiv(n // c, gp), cluster) * gp * c
    return _cdiv(n // vec, cluster) * vec


def cluster_smem(n: int, c: int, vec: int, cluster: int,
                 operand: bool) -> int:
    """Dynamic shared memory of a cluster CTA: its slice (16-byte aligned)
    and ``CLUSTER_SCRATCH`` floats (its max, the warp maxima, the
    frame's)."""
    return (_cdiv(cluster_slice(n, c, vec, cluster, operand), 4) * 4 +
            CLUSTER_SCRATCH) * 4


@functools.lru_cache(maxsize=1024)
def epilogue_config(batch: int, n: int, c: int, aligned: bool,
                    operand_words: int = 0, p: int = 1,
                    per_frame: bool = False, host_max: bool = False,
                    fold: bool = False) -> EpilogueConfig:
    """The launch for ``batch`` frames of ``n`` pooled elements of ``c``
    channels, pooled by ``p``: 4 elements a unit where the frames are
    16-byte ``aligned`` and either ``c`` is a multiple of 4 or there is
    no pool (``n`` a multiple of 4); ``operand_words`` 4-byte words a
    frame where it writes the next int8 conv's operand.

    The cluster form where each frame's max is its own (``per_frame``, or
    one frame), none comes from the host (``host_max``: a per-tensor max
    across ``shard_batch``'s shards) and the frame is of
    ``CLUSTER_MIN``..``CLUSTER_MAX`` elements: the power of two of
    ``CLUSTERS`` nearest above ``n / CLUSTER_SLICE`` (the least, at
    least). Otherwise the pair, with about ``TARGET_BLOCKS`` blocks a
    batch, pass 1 storing y and pass 2 reading it. ``fold``: pass 2
    alone after a conv whose store did pass 1 (it pools the conv's y as
    it writes the codes)."""
    vec = 4 if aligned and (c % 4 == 0 or (p == 1 and n % 4 == 0)) else 1
    if (per_frame or batch == 1) and not host_max and not fold and \
            CLUSTER_MIN <= n <= CLUSTER_MAX:
        want = _cdiv(n, CLUSTER_SLICE)
        cluster = next((cl for cl in CLUSTERS if cl >= want), CLUSTERS[-1])
        smem = cluster_smem(n, c, vec, cluster, operand_words > 0)
        if smem <= SMEM_MAX:
            return EpilogueConfig(vec, cluster=cluster, smem=smem)
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(form: str) -> None:
    LAUNCHES.inc()
    if getattr(_build._capturing, "tally", None) is None:
        FORMS[form].inc()


def _outputs(g: Geometry, per_frame: bool, operand, dev):
    """The call's codes (float32 in y's shape, or the uint8 operand) and
    scale buffers."""
    scale = torch.empty((g.b if per_frame else 1,), dtype=torch.float32,
                        device=dev)
    if operand is not None:
        out = torch.empty((g.b, g.hp, g.wp, g.cp), dtype=torch.uint8,
                          device=dev)
    else:
        out = torch.empty(g.y_shape, dtype=torch.float32, device=dev)
    return out, scale


def _quant(g: Geometry, out, scale, amax, a_qmax, per_frame: bool,
           operand, nblk2: int) -> _Quant:
    aq = a_qmax if a_qmax is not None else float(CODE_MAX)
    if isinstance(aq, torch.Tensor):
        raise TypeError("epilogue: a_qmax is the plan's constant, a float")
    return _Quant(_ptr(amax), scale.data_ptr(),
                  None if operand is not None else out.data_ptr(),
                  out.data_ptr() if operand is not None else None,
                  float(aq), int(per_frame), CODE_MAX, g.hp, g.wp, g.cp,
                  g.top, g.left, g.y_shape[1] if len(g.y_shape) == 4 else 1,
                  nblk2)


def _shaped(out, scale, g: Geometry, per_frame: bool):
    scale = scale.reshape((g.b,) + (1,) * (len(g.y_shape) - 1)) \
        if per_frame else scale.reshape(())
    return out, scale


def _check_frame(g: Geometry) -> None:
    if g.n * g.p * g.p >= FRAME_MAX:
        raise ValueError(f"epilogue: a frame of {g.n * g.p * g.p} floats; "
                         f"the kernels take fewer than {FRAME_MAX}")


def launch(x: torch.Tensor, act_scale, ws, bias, act: str,
           pool: Optional[Tuple[str, int]], a_qmax, per_frame: bool,
           reduce_max, operand, config: Optional[EpilogueConfig] = None):
    """Launch the call on CUDA tensors and count it on ``LAUNCHES``: in
    :func:`epilogue_config`'s form, or ``config``'s (the card's timing of
    the alternatives)."""
    if act not in ACTS:
        raise ValueError(f"epilogue: the kernel takes act in {tuple(ACTS)}, "
                         f"not {act!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"epilogue: x is {x.dtype}, not float32")
    dev = x.device
    x = _frames(x)
    g = geometry(x, pool, operand)
    _check_frame(g)
    b, c, n = g.b, g.c, g.n
    s = _flat(act_scale, (1, b), "act_scale", dev)
    w = _flat(ws, (1, c), "ws", dev)
    bi = _flat(bias, (1, c), "bias", dev)
    host_max = reduce_max is not None and not per_frame
    cfg = config or epilogue_config(b, n, c, g.aligned, g.op_words, g.p,
                                    per_frame, host_max)
    out, scale = _outputs(g, per_frame, operand, dev)
    lib = _build.library("epilogue", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = (g.xs, n, b, 0 if s is None else s.numel(),
             0 if w is None else w.numel(), 0 if bi is None else bi.numel(),
             ACTS[act], g.pool_kind, g.p, g.w_in, c, g.w_out)
    if cfg.cluster:
        epi = _Epi(x.data_ptr(), _ptr(s), _ptr(w), _ptr(bi), None, None,
                   *sizes, 1)
        quant = _quant(g, out, scale, None, a_qmax, per_frame, operand, 1)
        _build.check(lib.epilogue_cluster_launch(
            ctypes.byref(epi), ctypes.byref(quant), cfg.vec, cfg.cluster,
            cfg.smem, stream), "epilogue (cluster)")
        _count("cluster")
        return _shaped(out, scale, g, per_frame)
    f32 = dict(dtype=torch.float32, device=dev)
    partials = torch.empty((b, cfg.nblk1), **f32)
    ybuf = torch.empty((b, n), **f32)
    epi = _Epi(x.data_ptr(), _ptr(s), _ptr(w), _ptr(bi), _ptr(ybuf),
               partials.data_ptr(), *sizes, cfg.nblk1)
    _build.check(lib.epilogue_reduce_launch(ctypes.byref(epi), cfg.vec,
                                            stream), "epilogue pass 1")
    amax = None
    if host_max:
        # one max over every shard of the batch (``Options.shard_batch``)
        amax = reduce_max(partials.amax()).to(**f32).reshape(1).contiguous()
    quant = _quant(g, out, scale, amax, a_qmax, per_frame, operand,
                   cfg.nblk2)
    _build.check(lib.epilogue_quant_launch(ctypes.byref(epi),
                                           ctypes.byref(quant), cfg.vec,
                                           stream), "epilogue pass 2")
    _count("pair")
    return _shaped(out, scale, g, per_frame)


def quant_folded(y: torch.Tensor, partials: torch.Tensor,
                 pool: Optional[Tuple[str, int]], a_qmax, per_frame: bool,
                 reduce_max=None, operand=None):
    """Pass 2 alone after a conv whose store did pass 1
    (``strip.launch_int(fold=)``): ``y`` its unpooled, activated, clamped
    output [B, H, W, C] and ``partials`` [B, n] each of its CTAs' max of
    it -> ``(codes, scale)`` of ``y`` max-pooled by ``pool`` (or not
    pooled), as :func:`epilogue` returns them. A CUDA tensor launches
    (:func:`launch_folded`); a CPU tensor takes the plain version,
    ``epilogue_ref(y, pool=pool, ...)``: the max the partials hold is the
    pooled y's."""
    if not y.is_cuda:
        return epilogue_ref(y, None, None, None, "none", pool, a_qmax,
                            per_frame, reduce_max, operand)
    return launch_folded(y, partials, pool, a_qmax, per_frame, reduce_max,
                         operand)


def launch_folded(y: torch.Tensor, partials: torch.Tensor,
                  pool: Optional[Tuple[str, int]], a_qmax, per_frame: bool,
                  reduce_max=None, operand=None):
    """Launch :func:`quant_folded`'s pass 2 and count it on ``LAUNCHES``."""
    if pool is not None and pool[0] != "max":
        raise ValueError(f"epilogue: a folded epilogue pools by max or not "
                         f"at all, not {pool}")
    if y.dtype != torch.float32 or y.ndim != 4 or \
            partials.shape[0] != y.shape[0]:
        raise ValueError(f"epilogue: a folded y {tuple(y.shape)} "
                         f"{y.dtype} with partials "
                         f"{tuple(partials.shape)}")
    dev = y.device
    y = y.contiguous()
    partials = partials.contiguous()
    g = geometry(y, pool, operand)
    _check_frame(g)
    host_max = reduce_max is not None and not per_frame
    # pass 2's blocks for the shape; it pools the conv's y as it codes
    cfg = epilogue_config(g.b, g.n, g.c, g.aligned, g.op_words, g.p,
                          per_frame, host_max, fold=True)
    out, scale = _outputs(g, per_frame, operand, dev)
    epi = _Epi(y.data_ptr(), None, None, None, None, partials.data_ptr(),
               g.xs, g.n, g.b, 0, 0, 0, ACTS["none"], g.pool_kind, g.p,
               g.w_in, g.c, g.w_out, partials.shape[1])
    amax = None
    if host_max:
        amax = reduce_max(partials.amax()).to(
            dtype=torch.float32, device=dev).reshape(1).contiguous()
    quant = _quant(g, out, scale, amax, a_qmax, per_frame, operand,
                   cfg.nblk2)
    lib = _build.library("epilogue", _SIGNATURES)
    _build.check(lib.epilogue_quant_launch(
        ctypes.byref(epi), ctypes.byref(quant), cfg.vec,
        torch.cuda.current_stream(dev).cuda_stream),
        "epilogue pass 2 (folded)")
    _count("fold")
    return _shaped(out, scale, g, per_frame)


def epilogue_fold_ref(x8: torch.Tensor, act_scale, ws, bias, act: str,
                      pool, a_qmax, per_frame: bool, reduce_max, operand,
                      levels, stride: int):
    """Plain version of :func:`epilogue_fold`: the int8 conv's plain raw
    accumulate (``strip.conv_strip_int_ref``), then :func:`ref.epilogue_ref`
    -- the sequence the executor runs unfolded."""
    from repro_torch.kernels.conv_bank.strip import conv_strip_int_ref
    acc = conv_strip_int_ref(x8, levels.w8, stride=stride)
    return epilogue_ref(acc, act_scale, ws, bias, act, pool, a_qmax,
                        per_frame, reduce_max, operand)


def epilogue_fold(x8: torch.Tensor, act_scale: torch.Tensor,
                  ws: torch.Tensor, bias: Optional[torch.Tensor], act: str,
                  pool: Optional[Tuple[str, int]], a_qmax, per_frame: bool,
                  reduce_max, operand, levels, stride: int):
    """A dense conv on the int8 strip route and its requant, the epilogue's
    first pass folded into the conv's store: ``x8`` the conv's operand
    (``strip.int_codes``' form), ``levels`` its ``strip.IntWeights``,
    the rest :func:`epilogue`'s for the conv's accumulate -> ``(codes,
    scale)`` bitwise equal to :func:`epilogue_fold_ref`. A CUDA tensor
    launches the conv (counted on ``strip.INT_LAUNCHES``) and pass 2
    (:func:`quant_folded`); a CPU tensor takes the plain version."""
    from repro_torch.kernels.conv_bank import strip
    if not x8.is_cuda:
        return epilogue_fold_ref(x8, act_scale, ws, bias, act, pool, a_qmax,
                                 per_frame, reduce_max, operand, levels,
                                 stride)
    if act not in ACTS or (pool is not None and pool[0] != "max") or \
            act_scale is None or ws is None:
        raise ValueError(f"epilogue: the fold takes act in {tuple(ACTS)}, a "
                         f"max pool or none, act_scale and ws (got {act!r}, "
                         f"{pool})")
    y, partials = strip.conv_strip_int_laid(
        x8, levels, stride, fold=strip.Fold(act_scale, ws, bias, act))
    return launch_folded(y, partials, pool, a_qmax, per_frame, reduce_max,
                         operand)


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
