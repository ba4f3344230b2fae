"""Wrappers of the strip conv kernels (``csrc/conv_strip.cu``) and their
plain versions.

``conv_strip`` (dense, any stride) and ``conv_strip_depthwise`` (depthwise,
multiplier 1) take the reference's strip contract: the caller pads the
input's rows so ``n_strips`` strips of ``strip_h`` output rows tile exactly,
``Hp == (n_strips*strip_h - 1)*stride + k`` (:func:`pad_rows_for_strips`),
and gets every output row back; rows past the conv's true height are its
padding to slice off. The CUDA kernel tiles the output for shared memory
on its own, so the strips fix only that contract: :func:`strip_config`
picks the dense kernel's tile, output-channel block and input-channel
chunk, and :func:`dw_config` the depthwise kernel's tile, run and channel
block, from the shape alone (tested on the CPU).

With ``ws`` the per-layer epilogue follows the accumulate, in the
reference kernel's association: ``acc * act_scale * ws``, then ``+ bias``,
then the activation. Without ``ws`` the raw accumulate comes back.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``conv_strip_ref`` / ``conv_strip_depthwise_ref``: the float64 tap loop of
``ref.conv_taps_int`` and the same epilogue). There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.accelerator import _activation
from repro_torch.kernels import _build
from repro_torch.kernels.conv_bank.fused import ACTS
from repro_torch.kernels.conv_bank.ref import conv_taps_int

LAUNCHES = _build.LaunchCounter("conv_strip")
DW_LAUNCHES = _build.LaunchCounter("conv_strip_depthwise")
INT_LAUNCHES = _build.LaunchCounter("conv_strip_int")
_DW_ENTRY = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (
    ctypes.c_float,) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_DENSE_ENTRY = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (
    ctypes.c_float,) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_SIGNATURES = {
    "conv_strip_launch": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (
        ctypes.c_float,) + (ctypes.c_int,) * 6 + (ctypes.c_void_p,),
    "conv_strip_dw_launch": _DW_ENTRY,
    "conv_strip_int_launch": _DENSE_ENTRY}

SMS = 132                       # H100 SXM
SMEM_MAX = 232448               # bytes a CTA can opt into
STAGE_BUDGET = 24 * 1024        # bytes of one C_in stage (two fit 48 KB)
FAST_K = (3, 5, 7)              # k instantiated at stride 1
# (co_b, run, threads) in order of preference: most work per thread first,
# then the smaller CTA (more CTAs an SM)
DENSE_SHAPES = ((8, 4, 128), (4, 8, 128), (4, 4, 128), (4, 4, 64),
                (1, 8, 128), (1, 4, 64))
DW_THREADS = (128, 64, 32)      # depthwise CTA sizes in order of preference
DW_FAST_RUN, DW_RUN = 8, 4      # depthwise rows a thread: k 3/5/7 at
                                # stride 1, and any other k or stride
# the int8 tensor-core kernel (conv_igemm_kernel): output pixel slots a CTA,
# input channels (bytes) a stage, bytes a staged pixel or weight row takes,
# the output-channel blocks it is built for, the channel multiple its
# operands carry
IGEMM_BM = 128
IGEMM_CH = 32
IGEMM_LD = IGEMM_CH + 16
IGEMM_BN = (16, 32, 64)
IGEMM_C_ALIGN = 16
IGEMM_FOLD_C, IGEMM_FOLD_K = 4, 128          # taps folded into K: channels a
                                             # tap carries, most K bytes
IGEMM_TW = (1, 2, 4, 8, 16, 32, 64, 128)    # tile widths besides w_out
INT_CODE_MAX, INT_LEVEL_MAX = 255, 127       # u8 codes, s8 levels
# the route rule (PERF.md gives the card's times of both kernels at every
# path shape): dense shapes from this many input channels, and folded
# shapes (C_in <= 4, k*k*4 <= 128) from this many output channels, take
# the int8 kernel; the rest the float64 one
IGEMM_MIN_C_IN = 16
IGEMM_MIN_C_OUT = 64


@dataclass(frozen=True)
class StripConfig:
    """One launch of the dense strip kernel: a tile of ``tx`` columns x
    ``tyt * run`` rows (``tx * tyt`` threads, each ``run`` rows of one
    column for ``co_b`` output channels), ``cc`` input channels a stage."""
    k_inst: int                 # the kernel's K: 3, 5, 7, or 0 (any k, stride)
    tx: int
    tyt: int
    run: int
    co_b: int
    cc: int
    stages: int
    smem: int                   # dynamic shared memory, bytes
    ctas: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stage_bytes(tx: int, tyt: int, run: int, co_b: int, cc: int, k: int,
                stride: int) -> int:
    """Bytes of one C_in stage: ``cc`` float32 input planes (rows padded to
    a multiple of 4 floats), then the chunk's weights as float32 and as
    float64, as the kernel's launcher lays them out."""
    rows_in = (tyt * run - 1) * stride + k
    cols_ld = _cdiv((tx - 1) * stride + k, 4) * 4
    n_w = k * k * cc * co_b
    return _cdiv(cc * rows_in * cols_ld * 4, 16) * 16 + \
        _cdiv(n_w * 4, 16) * 16 + n_w * 8


def _shape_config(batch: int, n_rows: int, w_out: int, c_in: int,
                 c_out: int, k: int, stride: int, co_b: int, run: int,
                 threads: int) -> StripConfig:
    """The launch of one of ``DENSE_SHAPES`` at this conv: the tile is 32
    columns wide for outputs up to 32 wide, else 64; the C_in chunk the
    largest whose stage fits ``STAGE_BUDGET`` (one channel at least), two
    stages when C_in takes more than one chunk."""
    tx = 32 if w_out <= 32 else 64
    tyt = max(1, threads // tx)
    ctas = batch * _cdiv(n_rows, tyt * run) * _cdiv(w_out, tx) * \
        _cdiv(c_out, co_b)
    one = stage_bytes(tx, tyt, run, co_b, 1, k, stride)
    cc = max(1, min(c_in, STAGE_BUDGET // one))
    stages = 2 if c_in > cc else 1
    return StripConfig(k if stride == 1 and k in FAST_K else 0, tx, tyt,
                       run, co_b, cc, stages,
                       stages * stage_bytes(tx, tyt, run, co_b, cc, k,
                                            stride), ctas)


@functools.lru_cache(maxsize=1024)
def strip_config(batch: int, n_rows: int, w_out: int, c_in: int, c_out: int,
                 k: int, stride: int) -> StripConfig:
    """The dense kernel's launch for output [batch, n_rows, w_out, c_out]
    from c_in channels at k x k, stride ``stride``: the first of
    ``DENSE_SHAPES`` that gives every SM a CTA, else the one with the most
    CTAs (:func:`_shape_config`). A shape whose CTA tile of a block of
    output channels needs more shared memory than a CTA has (a large k at a
    large stride) is passed over; :func:`launch` raises if every one
    does."""
    cap = 1 if c_out == 1 else 4 if c_out <= 4 else 8
    best = None
    for co_b, run, threads in DENSE_SHAPES:
        if co_b > cap:
            continue
        cfg = _shape_config(batch, n_rows, w_out, c_in, c_out, k, stride,
                           co_b, run, threads)
        if cfg.smem > SMEM_MAX:
            continue
        if best is None or cfg.ctas > best.ctas:
            best = cfg
        if cfg.ctas >= SMS:
            return cfg
    if best is None:                        # nothing fits: the smallest
        best = _shape_config(batch, n_rows, w_out, c_in, c_out, k, stride,
                            *DENSE_SHAPES[-1])
    return best


@dataclass(frozen=True)
class DwConfig:
    """One launch of the depthwise strip kernel: a tile of ``tx`` columns x
    ``tyt * run`` rows (``tx * tyt`` threads, each ``run`` rows of one
    column for the ``cb`` channels of its block), a CTA a tile."""
    k_inst: int                 # the kernel's K: 3, 5, 7, or 0 (any k, stride)
    tx: int
    tyt: int
    run: int
    cb: int
    smem: int                   # dynamic shared memory, bytes
    ctas: int


def dw_bytes(tx: int, tyt: int, run: int, cb: int, k: int,
             stride: int) -> int:
    """Shared memory of a depthwise CTA, as the kernel's launcher lays it
    out: the float32 input rows (``cols_in * cb`` floats rounded up to 4,
    plus 4 for the row's phase), an int phase a row, then the taps as
    float64 (8-byte aligned)."""
    rows_in = (tyt * run - 1) * stride + k
    ld = _cdiv(((tx - 1) * stride + k) * cb, 4) * 4 + 4
    return _cdiv((rows_in * ld + rows_in) * 4, 8) * 8 + k * k * cb * 8


@functools.lru_cache(maxsize=1024)
def dw_config(batch: int, n_rows: int, w_out: int, c: int, k: int,
              stride: int) -> DwConfig:
    """The depthwise kernel's launch for output [batch, n_rows, w_out, c]
    at k x k, stride ``stride``: channel blocks of all ``c`` channels for 1
    and 3 (none idles, rows copy as one run of floats), else of 4; tiles 32
    columns wide for outputs up to 32 wide, else 64 (32 where a large k and
    stride need it), of the first of ``DW_THREADS`` whose shared memory fits
    a CTA (:func:`launch` raises if none does)."""
    k_inst = k if stride == 1 and k in FAST_K else 0
    run = DW_FAST_RUN if k_inst else DW_RUN
    cb = c if c in (1, 3) else 4
    shapes = [(tx, threads // tx) for tx in ((32,) if w_out <= 32 else
                                              (64, 32))
              for threads in DW_THREADS if threads >= tx]
    for tx, tyt in shapes:
        smem = dw_bytes(tx, tyt, run, cb, k, stride)
        if smem <= SMEM_MAX:
            break
    return DwConfig(k_inst, tx, tyt, run, cb, smem,
                    batch * _cdiv(n_rows, tyt * run) * _cdiv(w_out, tx) *
                    _cdiv(c, cb))


@dataclass(frozen=True)
class IgemmConfig:
    """One launch of the int8 tensor-core kernel: a tile of ``th`` output
    rows x ``tw`` columns (at most ``IGEMM_BM`` pixels) for ``bn`` output
    channels a CTA, C_in in ``IGEMM_CH``-byte chunks through ``stages``
    shared-memory stages."""
    k_inst: int                 # the kernel's KT: 3, or 0 (any k)
    th: int
    tw: int
    bn: int
    stages: int
    smem: int                   # dynamic shared memory, bytes
    ctas: int
    kf: int = 0                 # folded taps: K bytes; 0 otherwise


def igemm_fold_k(c_in: int, k: int) -> int:
    """K bytes of the int8 kernel's folded form (the k*k taps of 4 channels
    each, rounded up to 32), where C_in <= ``IGEMM_FOLD_C`` and they fit
    ``IGEMM_FOLD_K``; 0 where the conv takes C_in chunks instead."""
    kf = _cdiv(k * k * IGEMM_FOLD_C, 32) * 32
    return kf if c_in <= IGEMM_FOLD_C and kf <= IGEMM_FOLD_K else 0


def igemm_c_in(c_in: int, k: int) -> int:
    """The channels the int8 kernel's operands carry (zeros past C_in): 4
    in the folded form, else C_in rounded up to a multiple of
    ``IGEMM_C_ALIGN``."""
    if igemm_fold_k(c_in, k):
        return IGEMM_FOLD_C
    return _cdiv(c_in, IGEMM_C_ALIGN) * IGEMM_C_ALIGN


def igemm_stage_bytes(th: int, tw: int, bn: int, k: int, stride: int,
                      kf: int = 0) -> int:
    """Bytes of one stage of the int8 kernel, as its launcher lays them
    out: the tile's input patch (halo included) and the chunk's k*k x
    ``bn`` weight rows, ``IGEMM_LD`` bytes a pixel or row; folded (``kf``
    K bytes), the patch at 4 bytes a pixel (16-byte aligned) and ``bn``
    weight rows of ``kf + 16`` bytes."""
    rows_in = (th - 1) * stride + k
    cols_in = (tw - 1) * stride + k
    if kf:
        return _cdiv(rows_in * cols_in * IGEMM_FOLD_C, 16) * 16 + \
            bn * (kf + 16)
    return (rows_in * cols_in + k * k * bn) * IGEMM_LD


def int_exact(c_in: int, k: int) -> bool:
    """Whether every accumulate of u8 codes x s8 levels over k*k*C_in taps
    stays inside int32 (the launcher refuses the rest)."""
    return INT_CODE_MAX * INT_LEVEL_MAX * k * k * igemm_c_in(c_in, k) < \
        2 ** 31


@functools.lru_cache(maxsize=1024)
def igemm_config(batch: int, n_rows: int, w_out: int, c_in: int, c_out: int,
                 k: int, stride: int) -> IgemmConfig:
    """The int8 kernel's launch for output [batch, n_rows, w_out, c_out]
    from c_in channels at k x k, stride ``stride``: the smallest of
    ``IGEMM_BN`` that holds c_out (64 past it); the tile of the fewest
    CTAs, then the smallest staged patch, among widths ``w_out`` and
    ``IGEMM_TW`` (each as tall as ``IGEMM_BM`` slots allow), then the
    widest, whose stages fit a CTA, with smaller channel blocks tried when none does. Two
    stages when C_in takes more than one chunk. A shape nothing fits (a
    very large k) gets the 1 x 1 tile of 16 channels, whose ``smem`` says
    so: :func:`launch_int` raises on it. C_in <= 4 at k*k*4 <= 128 takes
    the folded form (``kf``): one stage, the taps in K."""
    kf = igemm_fold_k(c_in, k)
    stages = 2 if _cdiv(igemm_c_in(c_in, k), IGEMM_CH) > 1 else 1
    bn_first = next((bn for bn in IGEMM_BN if bn >= c_out), IGEMM_BN[-1])
    widths = sorted({tw for tw in (w_out, *IGEMM_TW)
                     if tw <= min(w_out, IGEMM_BM)})
    for bn in reversed([bn for bn in IGEMM_BN if bn <= bn_first]):
        best = None
        for tw in widths:
            th = min(IGEMM_BM // tw, n_rows)
            smem = stages * igemm_stage_bytes(th, tw, bn, k, stride, kf)
            if smem > SMEM_MAX:
                continue
            tiles = _cdiv(n_rows, th) * _cdiv(w_out, tw)
            patch = ((th - 1) * stride + k) * ((tw - 1) * stride + k)
            key = (tiles, patch, -tw)   # then the widest: an ldmatrix's 8
                                        # rows in one tile row
            if best is None or key < best[0]:
                best = (key, th, tw, smem)
        if best is not None:
            _, th, tw, smem = best
            return IgemmConfig(3 if k == 3 else 0, th, tw, bn, stages, smem,
                               batch * best[0][0] * _cdiv(c_out, bn), kf)
    bn = IGEMM_BN[0]
    return IgemmConfig(3 if k == 3 else 0, 1, 1, bn, stages,
                       stages * igemm_stage_bytes(1, 1, bn, k, stride, kf),
                       batch * n_rows * w_out * _cdiv(c_out, bn), kf)


def dense_route(c_in: int, c_out: int, k: int, stride: int) -> str:
    """Which kernel a dense conv of integer codes takes: ``"int"`` (the
    int8 tensor-core kernel, :func:`conv_strip_int`) from
    ``IGEMM_MIN_C_IN`` input channels, or in the folded form (C_in <= 4,
    k*k*4 <= 128: VGG16's conv1) from ``IGEMM_MIN_C_OUT`` output channels,
    where its accumulate is exact in int32 and a stage of its smallest
    tile fits a CTA; ``"float"`` (the float64 kernel, :func:`conv_strip`)
    otherwise: the imaging path's 1-4 channel convs, which bytes bound and
    the int route's cast and channel padding would slow, and the 5-15
    channel shapes no path has. PERF.md gives the card's times of both at
    every path shape."""
    wide = c_in >= IGEMM_MIN_C_IN or (
        igemm_fold_k(c_in, k) and c_out >= IGEMM_MIN_C_OUT)
    if not wide or not int_exact(c_in, k):
        return "float"
    stages = 2 if _cdiv(igemm_c_in(c_in, k), IGEMM_CH) > 1 else 1
    if stages * igemm_stage_bytes(1, 1, IGEMM_BN[0], k, stride,
                                  igemm_fold_k(c_in, k)) > SMEM_MAX:
        return "float"
    return "int"


def pad_rows_for_strips(xp: torch.Tensor, kk: int, stride: int,
                        strip_rows: int, n_strips: int) -> torch.Tensor:
    """Zero-pad the bottom rows of a spatially padded input so ``n_strips``
    strips of ``strip_rows`` output rows tile exactly: the padded height is
    ``(n_strips*strip_rows - 1)*stride + kk``. An input that already has
    surplus rows (a strided VALID conv drops up to stride-1) is returned as
    it is."""
    extra = (n_strips * strip_rows - 1) * stride + kk - xp.shape[1]
    if extra <= 0:
        return xp
    return F.pad(xp, (0, 0, 0, 0, 0, extra))


def _out_rows(x_padded: torch.Tensor, kk: int, stride: int,
              strip_h: int, what: str) -> int:
    if x_padded.ndim != 4:
        raise ValueError(f"{what}: x_padded must be [B, Hp, Wp, C], got "
                         f"{tuple(x_padded.shape)}")
    if strip_h < 1:
        raise ValueError(f"{what}: strip_h={strip_h} must be >= 1")
    hp, wp = x_padded.shape[1], x_padded.shape[2]
    if hp < kk or wp < kk:
        raise ValueError(f"{what}: padded input {hp}x{wp} is smaller than "
                         f"the {kk}x{kk} kernel")
    n_rows = (hp - kk) // stride + 1
    if n_rows % strip_h:
        raise ValueError(f"{what}: padded rows {hp} give {n_rows} output "
                         f"rows, not a multiple of strip_h={strip_h}")
    return n_rows


def _check_epilogue(ws, bias, act: str, c_out: int, what: str) -> None:
    if act not in ACTS:
        raise ValueError(f"{what}: act {act!r} not in {tuple(ACTS)}")
    if ws is None and (bias is not None or act != "none"):
        raise ValueError(f"{what}: bias and act need ws (the epilogue runs "
                         f"only after a dequant)")
    for name, t in (("ws", ws), ("bias", bias)):
        if t is not None and t.numel() != c_out:
            raise ValueError(f"{what}: {name} has {t.numel()} entries for "
                             f"{c_out} output channels")


def _epilogue(acc: torch.Tensor, act_scale: float, ws, bias,
              act: str) -> torch.Tensor:
    """``acc * act_scale * ws`` -> ``+ bias`` -> activation, as the reference
    strip kernel's ``_epilogue`` associates it."""
    if ws is None:
        return acc
    out = acc * act_scale * ws.reshape(-1).float()
    if bias is not None:
        out = out + bias.reshape(-1).float()
    return _activation(out, act)


def conv_strip_ref(x_padded: torch.Tensor, w: torch.Tensor,
                   ws: Optional[torch.Tensor] = None, stride: int = 1,
                   strip_h: int = 8, act_scale: float = 1.0,
                   act: str = "none", bias: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Plain version of :func:`conv_strip`."""
    kk, c_out = w.shape[0], w.shape[-1]
    _out_rows(x_padded, kk, stride, strip_h, "conv_strip")
    _check_epilogue(ws, bias, act, c_out, "conv_strip")
    acc = conv_taps_int(x_padded, w, kk, stride, ((0, 0), (0, 0)))
    return _epilogue(acc, act_scale, ws, bias, act)


def _check_int(x_padded: torch.Tensor, w: torch.Tensor, stride: int):
    """The int8 kernel's operands: u8 codes [B, Hp, Wp, C_in], s8 levels
    [k, k, C_in, C_out], an accumulate that int32 holds."""
    if x_padded.ndim != 4 or w.ndim != 4 or w.shape[0] != w.shape[1] or \
            w.shape[2] != x_padded.shape[-1]:
        raise ValueError(f"conv_strip_int: x {tuple(x_padded.shape)} and w "
                         f"{tuple(w.shape)} are not [B, Hp, Wp, C_in] and "
                         f"[k, k, C_in, C_out]")
    if x_padded.dtype != torch.uint8 or w.dtype != torch.int8:
        raise ValueError(f"conv_strip_int: operands are {x_padded.dtype} and "
                         f"{w.dtype}, not uint8 codes and int8 levels")
    kk, c_in = w.shape[0], w.shape[2]
    if not int_exact(c_in, kk):
        raise ValueError(f"conv_strip_int: {INT_CODE_MAX} * {INT_LEVEL_MAX} "
                         f"* {kk}*{kk} * {igemm_c_in(c_in, kk)} >= 2^31: an "
                         f"accumulate could leave int32")
    _out_rows(x_padded, kk, stride, 1, "conv_strip_int")
    return kk, w.shape[-1]


def conv_strip_int_ref(x_padded: torch.Tensor, w: torch.Tensor,
                       ws: Optional[torch.Tensor] = None, stride: int = 1,
                       act_scale: float = 1.0, act: str = "none",
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`conv_strip_int`: the float64 tap loop of
    ``ref.conv_taps_int`` and the same epilogue."""
    kk, c_out = _check_int(x_padded, w, stride)
    _check_epilogue(ws, bias, act, c_out, "conv_strip_int")
    acc = conv_taps_int(x_padded, w, kk, stride, ((0, 0), (0, 0)))
    return _epilogue(acc, act_scale, ws, bias, act)


def conv_strip_depthwise_ref(x_padded: torch.Tensor, w_taps: torch.Tensor,
                             ws: Optional[torch.Tensor] = None,
                             stride: int = 1, strip_h: int = 8,
                             act_scale: float = 1.0, act: str = "none",
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of :func:`conv_strip_depthwise`."""
    kk, c = _taps_kernel(w_taps, x_padded)
    _out_rows(x_padded, kk, stride, strip_h, "conv_strip_depthwise")
    _check_epilogue(ws, bias, act, c, "conv_strip_depthwise")
    acc = conv_taps_int(x_padded, w_taps.reshape(kk, kk, 1, c), kk, stride,
                        ((0, 0), (0, 0)), depthwise=True)
    return _epilogue(acc, act_scale, ws, bias, act)


def _taps_kernel(w_taps: torch.Tensor, x_padded: torch.Tensor):
    kk = math.isqrt(w_taps.shape[0])
    c = w_taps.shape[-1]
    if w_taps.ndim != 2 or kk * kk != w_taps.shape[0] or \
            x_padded.shape[-1] != c:
        raise ValueError(f"conv_strip_depthwise: w_taps {tuple(w_taps.shape)}"
                         f" is not [k*k, C] for C={x_padded.shape[-1]}")
    return kk, c


def launch(x_padded: torch.Tensor, w: torch.Tensor, ws, bias,
           act_scale: float, act: str, stride: int, depthwise: bool,
           counter: _build.LaunchCounter) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (validated by the caller) and
    count it on ``counter``: dense ``w`` is [k, k, C_in, C_out], depthwise
    ``w`` is [k*k, C]. Returns every output row of the padded input; the
    dense launch takes :func:`strip_config`'s configuration, the depthwise
    one :func:`dw_config`'s."""
    dev = x_padded.device
    kk = w.shape[0] if not depthwise else math.isqrt(w.shape[0])
    b, hp, wp, c_in = x_padded.shape
    c_out = w.shape[-1]
    n_rows = (hp - kk) // stride + 1
    w_out = (wp - kk) // stride + 1
    for t in (w, ws, bias):
        if t is not None and t.device != dev:
            raise ValueError(f"conv_strip: operands on {dev} and {t.device}")
    # float32, contiguous; ws and bias flat (the plan's ws is [1, 1, 1, C])
    ops = [t.to(torch.float32).contiguous() for t in (x_padded, w)]
    ops += [t if t is None else t.reshape(-1).to(torch.float32).contiguous()
            for t in (ws, bias)]
    out = torch.empty((b, n_rows, w_out, c_out), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    ptr = [None if t is None else t.data_ptr() for t in ops]
    lib = _build.library("conv_strip", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if depthwise:
        cfg = dw_config(b, n_rows, w_out, c_in, kk, stride)
        if cfg.smem > SMEM_MAX:
            raise ValueError(f"conv_strip_depthwise: {cfg.smem} bytes of "
                             f"shared memory at k={kk} stride={stride}; a "
                             f"CTA has {SMEM_MAX}")
        err = lib.conv_strip_dw_launch(*ptr, out.data_ptr(), b, hp, wp, c_in,
                                       kk, stride, float(act_scale),
                                       ACTS[act], cfg.tx, cfg.tyt, cfg.run,
                                       cfg.cb, stream)
    else:
        cfg = strip_config(b, n_rows, w_out, c_in, c_out, kk, stride)
        if cfg.smem > SMEM_MAX:
            raise ValueError(f"conv_strip: {cfg.smem} bytes of shared memory "
                             f"for one input channel at k={kk} stride="
                             f"{stride}; a CTA has {SMEM_MAX}")
        err = lib.conv_strip_launch(*ptr, out.data_ptr(), b, hp, wp, c_in,
                                    c_out, kk, stride, float(act_scale),
                                    ACTS[act], cfg.tx, cfg.tyt, cfg.run,
                                    cfg.co_b, cfg.cc, stream)
    _build.check(err, "conv_strip_depthwise" if depthwise else "conv_strip")
    counter.inc()
    return out


def conv_strip(x_padded: torch.Tensor, w: torch.Tensor,
               ws: Optional[torch.Tensor] = None, stride: int = 1,
               strip_h: int = 8, act_scale: float = 1.0, act: str = "none",
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense k x k conv over strips: x_padded [B, Hp, Wp, C_in], w [k, k,
    C_in, C_out] -> [B, (Hp-k)/stride+1, W', C_out] float32, bitwise equal
    to :func:`conv_strip_ref` on integer-valued operands."""
    kk, c_out = w.shape[0], w.shape[-1]
    if w.ndim != 4 or w.shape[1] != kk or w.shape[2] != x_padded.shape[-1]:
        raise ValueError(f"conv_strip: w {tuple(w.shape)} is not [k, k, "
                         f"{x_padded.shape[-1]}, C_out]")
    if not x_padded.is_cuda:
        return conv_strip_ref(x_padded, w, ws, stride, strip_h, act_scale,
                              act, bias)
    _out_rows(x_padded, kk, stride, strip_h, "conv_strip")
    _check_epilogue(ws, bias, act, c_out, "conv_strip")
    return launch(x_padded, w, ws, bias, act_scale, act, stride, False,
                  LAUNCHES)


def conv_strip_depthwise(x_padded: torch.Tensor, w_taps: torch.Tensor,
                         ws: Optional[torch.Tensor] = None, stride: int = 1,
                         strip_h: int = 8, act_scale: float = 1.0,
                         act: str = "none",
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Depthwise k x k conv over strips: x_padded [B, Hp, Wp, C], w_taps
    [k*k, C] (tap-major) -> [B, (Hp-k)/stride+1, W', C] float32, bitwise
    equal to :func:`conv_strip_depthwise_ref`."""
    if not x_padded.is_cuda:
        return conv_strip_depthwise_ref(x_padded, w_taps, ws, stride,
                                        strip_h, act_scale, act, bias)
    kk, c = _taps_kernel(w_taps, x_padded)
    _out_rows(x_padded, kk, stride, strip_h, "conv_strip_depthwise")
    _check_epilogue(ws, bias, act, c, "conv_strip_depthwise")
    return launch(x_padded, w_taps, ws, bias, act_scale, act, stride, True,
                  DW_LAUNCHES)


def int_codes(codes: torch.Tensor, k: int, pads=((0, 0), (0, 0))
              ) -> torch.Tensor:
    """The int8 kernel's input from integer-valued codes [B, H, W, C] of a
    k x k conv: cast to uint8 and then, in one ``F.pad``, given the border
    ``pads`` ((top, bottom), (left, right)) and zero channels up to
    :func:`igemm_c_in`'s. Codes already in that form come back as they
    are. ``dispatch.epilogue`` writes this form straight from a requant."""
    (plo, phi), (qlo, qhi) = pads
    cpad = igemm_c_in(codes.shape[-1], k) - codes.shape[-1]
    x8 = codes.to(torch.uint8)
    if cpad or plo or phi or qlo or qhi:
        x8 = F.pad(x8, (0, cpad, qlo, qhi, plo, phi))
    return x8


def int_operands(codes: torch.Tensor, w: torch.Tensor,
                 pads=((0, 0), (0, 0))):
    """The int8 kernel's operands from integer-valued codes [B, H, W, C] and
    levels [k, k, C, C_out]: :func:`int_codes`, and the levels cast to
    int8 and given the same zero channels. Operands already in that form
    come back as they are."""
    kk, c_in = w.shape[0], w.shape[2]
    cpad = igemm_c_in(c_in, kk) - c_in
    w8 = w.to(torch.int8)
    if cpad:
        w8 = F.pad(w8, (0, 0, 0, cpad))
    return int_codes(codes, kk, pads), w8


@dataclass(frozen=True)
class IntWeights:
    """A conv's operands for the int8 kernel, laid out once
    (:func:`int_weights`): ``w8`` the int8 levels [k, k, C_k, C_out] with
    zero channels up to C_k = :func:`igemm_c_in` (what the plain version
    takes), ``wt`` the same levels as the kernel stages them ([k*k, C_out,
    C_k], C_k contiguous; folded, [C_out, kf] with K = tap*4 + channel),
    ``ws`` and ``bias`` flat contiguous float32 or None."""
    w8: torch.Tensor
    wt: torch.Tensor
    ws: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None


def int_weights(w: torch.Tensor, ws: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> IntWeights:
    """Lay out a conv's integer levels w [k, k, C_in, C_out] (and its
    ``ws`` / ``bias``) for the int8 kernel: the int8 cast, the channel
    pad, the transpose (or, folded, the [C_out, kf] pad) and the flat
    float32 scales. A bound view does it once a step at bind
    (``plan.quantized_weights``); an unbound call once a launch."""
    kk, c_in, c_out = w.shape[0], w.shape[2], w.shape[-1]
    c_k = igemm_c_in(c_in, kk)
    w8 = w.to(torch.int8)
    if c_k != c_in:
        w8 = F.pad(w8, (0, 0, 0, c_k - c_in))
    kf = igemm_fold_k(c_k, kk)
    wt = w8.reshape(kk * kk, c_k, c_out)
    if kf:
        wt = F.pad(wt.reshape(-1, c_out).t(),
                   (0, kf - kk * kk * IGEMM_FOLD_C)).contiguous()
    else:
        wt = wt.transpose(1, 2).contiguous()
    flat = [t if t is None else t.reshape(-1).to(torch.float32).contiguous()
            for t in (ws, bias)]
    return IntWeights(w8, wt, *flat)


def launch_int(x_padded: torch.Tensor, iw: IntWeights, act_scale: float,
               act: str, stride: int) -> torch.Tensor:
    """Launch the int8 kernel on CUDA tensors (validated by the caller) and
    count it on ``INT_LAUNCHES``: ``x_padded`` takes :func:`int_codes`'
    form (callers on the path hand it over already), the levels, ``ws``
    and ``bias`` :func:`int_weights`' layout, and :func:`igemm_config`'s
    configuration is taken."""
    dev = x_padded.device
    kk, c_out = iw.w8.shape[0], iw.w8.shape[-1]
    for t in (iw.wt, iw.ws, iw.bias):
        if t is not None and t.device != dev:
            raise ValueError(f"conv_strip_int: operands on {dev} and "
                             f"{t.device}")
    x = int_codes(x_padded, kk).contiguous()
    b, hp, wp, c_k = x.shape
    n_rows = (hp - kk) // stride + 1
    w_out = (wp - kk) // stride + 1
    out = torch.empty((b, n_rows, w_out, c_out), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    cfg = igemm_config(b, n_rows, w_out, c_k, c_out, kk, stride)
    if cfg.smem > SMEM_MAX:
        raise ValueError(f"conv_strip_int: {cfg.smem} bytes of shared memory "
                         f"at k={kk} stride={stride}; a CTA has {SMEM_MAX}")
    lib = _build.library("conv_strip", _SIGNATURES)
    err = lib.conv_strip_int_launch(
        x.data_ptr(), iw.wt.data_ptr(),
        *[None if t is None else t.data_ptr() for t in (iw.ws, iw.bias)],
        out.data_ptr(), b, hp, wp, c_k, c_out, kk, stride, float(act_scale),
        ACTS[act], cfg.th, cfg.tw, cfg.bn, cfg.stages,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "conv_strip_int")
    INT_LAUNCHES.inc()
    return out


def conv_strip_int(x_padded: torch.Tensor, w: torch.Tensor,
                   ws: Optional[torch.Tensor] = None, stride: int = 1,
                   act_scale: float = 1.0, act: str = "none",
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense k x k conv of u8 codes and s8 levels on the int8 tensor cores:
    x_padded [B, Hp, Wp, C_in] uint8, w [k, k, C_in, C_out] int8 ->
    [B, (Hp-k)/stride+1, (Wp-k)/stride+1, C_out] float32, every row the
    padded input yields (no strip contract), bitwise equal to
    :func:`conv_strip_int_ref`. Raises where an accumulate could leave
    int32 (``255 * 127 * k * k * C_in >= 2^31``). The levels are laid out
    on each call; :func:`conv_strip_int_laid` takes them laid out once."""
    kk, c_out = _check_int(x_padded, w, stride)
    _check_epilogue(ws, bias, act, c_out, "conv_strip_int")
    if not x_padded.is_cuda:
        return conv_strip_int_ref(x_padded, w, ws, stride, act_scale, act,
                                  bias)
    return launch_int(x_padded, int_weights(w, ws, bias), act_scale, act,
                      stride)


def conv_strip_int_laid(x_padded: torch.Tensor, iw: IntWeights,
                        stride: int = 1, act_scale: float = 1.0,
                        act: str = "none") -> torch.Tensor:
    """:func:`conv_strip_int` on levels laid out once (:func:`int_weights`,
    its ``ws`` and ``bias`` with them) and x_padded in :func:`int_codes`'
    form; bitwise equal to :func:`conv_strip_int_ref` on ``iw.w8``."""
    _, c_out = _check_int(x_padded, iw.w8, stride)
    _check_epilogue(iw.ws, iw.bias, act, c_out, "conv_strip_int")
    if not x_padded.is_cuda:
        return conv_strip_int_ref(x_padded, iw.w8, iw.ws, stride, act_scale,
                                  act, iw.bias)
    return launch_int(x_padded, iw, act_scale, act, stride)
