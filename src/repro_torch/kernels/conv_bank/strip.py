"""Wrappers of the strip conv kernels (``csrc/conv_strip.cu``;
``csrc/conv_strip_wgmma.cu`` for the int8 kernel's wgmma form and
``csrc/conv_strip_f64mma.cu`` for the dense float kernel's tensor-core
form) and their plain versions.

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

The dense float kernel has two forms, one a launch, which
:func:`dense_form` picks: the tensor-core form (``conv_f64mma_kernel``,
mma.sync on float64, :func:`f64mma_config`) from ``F64_MIN_C`` input and
output channels at stride 1 and k 3, 5, 7 (the conv_bank op's float
mode), counted on ``F64_LAUNCHES``; the CUDA-core form
(``conv_dense_kernel``, :func:`strip_config`) for the rest (the imaging
path's 1-4 channel convs, stride 2, any other k). Both sum exact float64
products, so both are bitwise the plain version on integer operands.

With ``ws`` the per-layer epilogue follows the accumulate, in the
reference kernel's association: ``acc * act_scale * ws``, then ``+ bias``,
then the activation. Without ``ws`` the raw accumulate comes back.

The int8 kernel (``conv_strip_int``) has three forms, one a launch, which
:func:`igemm_config` picks from the shape: the wgmma form (stride 1, C_in
a multiple of 16, from ``WG_MIN_C`` input and output channels: VGG16's
conv2-conv10; ``csrc/conv_strip_wgmma.cu``, its operands staged by TMA,
the levels' tensor map kept with :class:`IntWeights`), and the mma.sync
forms of ``csrc/conv_strip.cu`` for the rest (the folded taps for C_in <=
4: conv1). The form does not depend on the batch (:func:`int_form`), so
:func:`int_weights` lays the levels out for that form alone. Every form
is bitwise the same plain version.

The int8 kernel also takes the plan executor's epilogue folded into its
store (:class:`Fold`, :func:`launch_int`): in the plan's association,
``acc * (act_scale * ws)`` with ``act_scale`` on the device, ``+ bias``,
the activation and the clamp at 0, unpooled, and each CTA's max of it,
which ``epilogue.ops.quant_folded`` turns into the codes.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``conv_strip_ref`` / ``conv_strip_depthwise_ref``: the float64 tap loop of
``ref.conv_taps_int`` and the same epilogue). There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.accelerator import _activation
from repro_torch.kernels import _build
from repro_torch.kernels.conv_bank.fused import ACTS
from repro_torch.kernels.conv_bank.ref import conv_taps_int

LAUNCHES = _build.LaunchCounter("conv_strip")
DW_LAUNCHES = _build.LaunchCounter("conv_strip_depthwise")
INT_LAUNCHES = _build.LaunchCounter("conv_strip_int")
# the dense float kernel's tensor-core form, whichever caller's launch
F64_LAUNCHES = _build.LaunchCounter("conv_strip_f64mma")
_DW_ENTRY = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (
    ctypes.c_float,) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_SIGNATURES = {
    "conv_strip_launch": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (
        ctypes.c_float,) + (ctypes.c_int,) * 6 + (ctypes.c_void_p,),
    "conv_strip_dw_launch": _DW_ENTRY,
    "conv_strip_int_launch": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (
        ctypes.c_float,) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,),
    "conv_strip_int_fold_launch": (ctypes.c_void_p,) * 7 + (
        ctypes.c_int,) * 15 + (ctypes.c_void_p,)}
# the wgmma form's library (csrc/conv_strip_wgmma.cu)
_WG_SIGNATURES = {
    "conv_strip_int_wgmma_launch": (ctypes.c_void_p,) * 5 + (
        ctypes.c_int,) * 7 + (ctypes.c_float,) + (ctypes.c_int,) * 6 + (
        ctypes.c_void_p,),
    "conv_strip_int_wgmma_fold_launch": (ctypes.c_void_p,) * 7 + (
        ctypes.c_int,) * 16 + (ctypes.c_void_p,),
    "conv_strip_int_tensor_map": (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5}
# the dense float kernel's tensor-core form (csrc/conv_strip_f64mma.cu)
_F64_SIGNATURES = {
    "conv_strip_f64mma_launch": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
    + (ctypes.c_float,) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)}

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
IGEMM_FOLD_RED = 8 * 4          # the epilogue fold's warp maxima (8 warps
                                # at most), bytes of shared memory after
                                # the stages
IGEMM_TW = (1, 2, 4, 8, 16, 32, 64, 128)    # tile widths besides w_out
INT_CODE_MAX, INT_LEVEL_MAX = 255, 127       # u8 codes, s8 levels
# the route rule (PERF.md gives the card's times of both kernels at every
# path shape): dense shapes from this many input channels, and folded
# shapes (C_in <= 4, k*k*4 <= 128) from this many output channels, take
# the int8 kernel; the rest the float64 one
IGEMM_MIN_C_IN = 16
IGEMM_MIN_C_OUT = 64
# the int8 kernel's wgmma form (conv_igemm_wgmma_kernel): its tiles (th,
# tw) of 8 x 8 blocks of output pixels, 256 or 128 a CTA (two consumer
# warpgroups of 2 or 1 m64 blocks); its output-channel blocks; the
# channels (bytes) a stage may hold; its most stages; the alignment of
# its stages (a TMA box's) and of a patch plane's pitch
WG_TILES = ((16, 16), (8, 32), (32, 8), (16, 8), (8, 16))
WG_BN = (64, 128)
WG_CH = (64, 32)
WG_MAX_STAGES = 4
WG_ALIGN = 128
# the launch rule's relative MAC rates of a CTA of (pixels, channels), one
# CTA an SM: fitted to the card's times of every launch at VGG16's
# conv2-conv13, buckets 1 and 8 (scripts/strip_int_forms.py
# --alternatives; PERF.md)
WG_RATE = {(128, 64): 1.0, (128, 128): 1.45, (256, 64): 1.4,
           (256, 128): 1.6}
# the launch rule gives the wgmma form the convs of at least this many
# input and output channels: VGG16's conv2-conv13, where the card ran it
# faster than the mma.sync form at buckets 1 and 8. Narrower convs (the
# conv_bank op's 16 -> 32 channels among them) keep the mma.sync form;
# both forms' times there are in PERF.md (row 6)
WG_MIN_C = 64
# the dense float kernel's tensor-core form (conv_f64mma_kernel): tile
# columns (an m16 block's 8), its tiles (th rows, bn output channels; a
# warp each m16n8 block, 2 rows x 8 columns for 8 channels: th / 2 x bn / 8
# warps, 16 at most), the doubles past a staged pixel's channels and a
# weight row's, the channel multiple of a stage (an m16n8k8 step), the
# input and output channels the rule asks for, and the stage that leaves
# room for a second CTA on the SM
F64_TW = 8
F64_TILES = ((16, 16), (8, 32), (8, 16))
F64_PAD = 4
F64_K = 8
F64_MIN_C = 8
F64_HALF = SMEM_MAX // 2


@dataclass(frozen=True)
class StripConfig:
    """One launch of the dense strip kernel's CUDA-core form
    (``conv_dense_kernel``): a tile of ``tx`` columns x ``tyt * run`` rows
    (``tx * tyt`` threads, each ``run`` rows of one column for ``co_b``
    output channels), ``cc`` input channels a stage."""
    k_inst: int                 # the kernel's K: 3, 5, 7, or 0 (any k, stride)
    tx: int
    tyt: int
    run: int
    co_b: int
    cc: int
    stages: int
    smem: int                   # dynamic shared memory, bytes
    ctas: int
    form: str = "fma"


@dataclass(frozen=True)
class F64Config:
    """One launch of the dense strip kernel's tensor-core form
    (``conv_f64mma_kernel``, ``csrc/conv_strip_f64mma.cu``): a tile of
    ``th`` x ``tw`` output pixels for ``bn`` output channels a CTA (``th /
    2`` x ``bn / 8`` warps, each one m16n8 block: 2 rows x 8 columns for 8
    channels), C_in in ``cc``-channel chunks through one shared-memory
    stage the mma reads, beside the landing area of the next chunk's
    copies."""
    th: int
    tw: int
    bn: int
    cc: int
    smem: int                   # dynamic shared memory, bytes
    ctas: int
    form: str = "f64mma"


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
    """The dense kernel's CUDA-core form's launch for output [batch,
    n_rows, w_out, c_out] from c_in channels at k x k, stride ``stride``:
    the first of ``DENSE_SHAPES`` that gives every SM a CTA, else the one
    with the most CTAs (:func:`_shape_config`). A shape whose CTA tile of a
    block of output channels needs more shared memory than a CTA has (a
    large k at a large stride) is passed over; :func:`launch` raises if
    every one does.

    The rule (:func:`dense_form`): this form takes every conv below
    ``F64_MIN_C`` input or output channels, at a stride other than 1 or a
    k other than 3, 5, 7; the tensor-core form (:func:`f64mma_config`)
    the rest, where a stage of it fits a CTA. The card ran the tensor-core
    form 4.0-6.1x faster at the conv_bank op's calls (16 -> 32 channels)
    at batches 8 and 1, and this form 7.5x and 23.6x faster at the imaging
    path's 4 -> 1 and 1 -> 1 channel convs (PERF.md)."""
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


def f64mma_stage_bytes(th: int, bn: int, cc: int, k: int) -> int:
    """Bytes of the tensor-core form's shared memory, as its launcher lays
    it out: the stage the mma reads, the tile's input patch (halo
    included) [th + k - 1][``F64_TW`` + k - 1][cc + ``F64_PAD``] and the
    chunk's weights [k*k][cc][bn + ``F64_PAD``] in float64, then the
    landing area the next chunk's copies fill, the same two unpadded in
    float32."""
    patch = (th + k - 1) * (F64_TW + k - 1)
    return (patch * (cc + F64_PAD) + k * k * cc * (bn + F64_PAD)) * 8 + \
        (patch * cc + k * k * cc * bn) * 4


def _f64mma_chunk(c_in: int, th: int, bn: int, k: int, ctas: int) -> int:
    """The tensor-core form's chunk: the most channels (a multiple of
    ``F64_K``, no more than C_in rounded up to it) whose stage fits a CTA;
    where the launch has more CTAs than SMs, the most whose stage leaves
    room for a second CTA on the SM (``F64_HALF``) if any, so one stages
    while the other sums (with one CTA an SM the larger chunk, one stage
    for C_in = 16, ran 6-9% faster at k 5 and 7; with two, 16% slower at k
    7: PERF.md); 0 where not even ``F64_K`` channels fit."""
    top = _cdiv(c_in, F64_K) * F64_K
    for budget in ((F64_HALF, SMEM_MAX) if ctas > SMS else (SMEM_MAX,)):
        for cc in range(top, 0, -F64_K):
            if f64mma_stage_bytes(th, bn, cc, k) <= budget:
                return cc
    return 0


def f64mma_launches(batch: int, n_rows: int, w_out: int, c_in: int,
                    c_out: int, k: int, stride: int) -> tuple:
    """Every launch of the tensor-core form that takes the conv: one an
    entry of ``F64_TILES`` (blocks of 32 channels only past 16 output
    channels), each with :func:`_f64mma_chunk`'s chunk; none at a stride
    other than 1, a k other than 3, 5 and 7, or where no chunk fits a
    CTA."""
    if stride != 1 or k not in FAST_K:
        return ()
    out = []
    for th, bn in F64_TILES:
        if bn > 16 and c_out <= 16:
            continue
        ctas = batch * _cdiv(n_rows, th) * _cdiv(w_out, F64_TW) * \
            _cdiv(c_out, bn)
        cc = _f64mma_chunk(c_in, th, bn, k, ctas)
        if cc:
            out.append(F64Config(th, F64_TW, bn, cc,
                                 f64mma_stage_bytes(th, bn, cc, k), ctas))
    return tuple(out)


def f64mma_warps(cfg: F64Config) -> int:
    """Warps of a tensor-core form CTA."""
    return cfg.th // 2 * (cfg.bn // 8)


def f64mma_cost(cfg: F64Config) -> int:
    """The launch rule's cost of ``cfg``: the work of an SM in the last
    wave, waves of CTAs over the card's SMs times a CTA's pixels x
    channels. The card's times (PERF.md) follow it: a launch took
    as long at batch 1 (16 CTAs of 16 x 8 pixels) as at batch 8 (128), and
    at batch 1 the 8 x 8 tiles (32 CTAs) ran 11-20% faster."""
    return _cdiv(cfg.ctas, SMS) * cfg.th * cfg.tw * cfg.bn


@functools.lru_cache(maxsize=1024)
def f64mma_config(batch: int, n_rows: int, w_out: int, c_in: int,
                  c_out: int, k: int, stride: int) -> Optional[F64Config]:
    """The tensor-core form's launch for output [batch, n_rows, w_out,
    c_out] from c_in channels at k x k: among :func:`f64mma_launches`, the
    least :func:`f64mma_cost`, then the taller tile (a smaller halo a
    pixel), then the fewest CTAs (the weights staged fewer times); None
    where the form does not take the conv. At the conv_bank op's calls:
    16 x 8 tiles of 16 channels, 16 warps, at batch 8 and 8 x 8 ones, 8
    warps, at batch 1, the fastest of its launches at each on the card."""
    launches = f64mma_launches(batch, n_rows, w_out, c_in, c_out, k, stride)
    if not launches:
        return None
    return min(launches, key=lambda c: (f64mma_cost(c), -c.th, c.ctas))


def dense_form(batch: int, n_rows: int, w_out: int, c_in: int, c_out: int,
               k: int, stride: int) -> str:
    """Which form of the dense float kernel :func:`launch` gives a conv:
    ``"f64mma"`` (the FP64 tensor cores, :func:`f64mma_config`) from
    ``F64_MIN_C`` input and output channels where that form takes the conv
    (stride 1, k 3, 5 or 7, a stage that fits a CTA); ``"fma"`` (the
    float64 FMAs of the CUDA cores, :func:`strip_config`) otherwise: the
    imaging path's 1-4 channel convs, every stride-2 conv and every k
    outside 3, 5, 7. PERF.md gives the card's times of both at the
    conv_bank op's calls and the imaging path's shapes."""
    if c_in >= F64_MIN_C and c_out >= F64_MIN_C and f64mma_config(
            batch, n_rows, w_out, c_in, c_out, k, stride) is not None:
        return "f64mma"
    return "fma"


def dense_config(batch: int, n_rows: int, w_out: int, c_in: int, c_out: int,
                 k: int, stride: int, form: Optional[str] = None):
    """The dense float kernel's launch in :func:`dense_form`'s form, or in
    ``form`` forced (``"fma"``, or ``"f64mma"`` wherever it takes the
    conv, else it raises): a :class:`F64Config` or a
    :class:`StripConfig`."""
    if form not in (None, "fma", "f64mma"):
        raise ValueError(f"dense_config: form {form!r}")
    if form is None:
        form = dense_form(batch, n_rows, w_out, c_in, c_out, k, stride)
    if form == "fma":
        return strip_config(batch, n_rows, w_out, c_in, c_out, k, stride)
    cfg = f64mma_config(batch, n_rows, w_out, c_in, c_out, k, stride)
    if cfg is None:
        raise ValueError(f"dense_config: the f64mma form does not take "
                         f"{c_in} -> {c_out} channels at k={k} "
                         f"stride={stride}")
    return cfg


def _f64mma_warp(cfg: F64Config, warp: int) -> tuple:
    """The first tile row and block channel of ``conv_f64mma_kernel``'s
    warp ``warp``: warps take 2 rows each, ``bn / 8`` of them across the
    block's channels."""
    wpn = cfg.bn // 8
    return 2 * (warp // wpn), 8 * (warp % wpn)


def f64mma_fragments(cfg: F64Config, k: int, warp: int, lane: int, q: int,
                     di: int, dj: int) -> tuple:
    """Where ``conv_f64mma_kernel``'s lane ``lane`` of warp ``warp`` reads
    its mma.sync.m16n8k8 operands at the k-step of channels ``q`` .. ``q``
    + 7 of a stage and tap (di, dj): ``(a, b)``, doubles from the start of
    the staged patch (a0..a3) and of the staged weights (b0, b1). a0 =
    A[g][t] and a2 = A[g][t + 4] (the warp's first output row, column g, g
    = lane // 4, t = lane % 4), a1, a3 the row below; b0 = B[t][g], b1 =
    B[t + 4][g]."""
    g, t = divmod(lane, 4)
    wr0, wn0 = _f64mma_warp(cfg, warp)
    cols_in = cfg.tw + k - 1
    ps, wsd = cfg.cc + F64_PAD, cfg.bn + F64_PAD
    pa = ((wr0 + di) * cols_in + g + dj) * ps + q + t
    a = (pa, pa + cols_in * ps, pa + 4, pa + cols_in * ps + 4)
    pb = ((di * k + dj) * cfg.cc + q + t) * wsd + wn0 + g
    return a, (pb, pb + 4 * wsd)


def f64mma_stores(cfg: F64Config, warp: int, lane: int) -> tuple:
    """Where ``conv_f64mma_kernel``'s lane stores its accumulator d0..d3:
    ``(row, column, channel)`` in the CTA's tile and channel block of each
    (d0, d1 at the warp's first row, d2, d3 the row below; channels 2t,
    2t + 1 of the warp's 8)."""
    g, t = divmod(lane, 4)
    wr0, wn0 = _f64mma_warp(cfg, warp)
    return tuple((wr0 + e // 2, g, wn0 + 2 * t + e % 2) for e in range(4))


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
    """One launch of the int8 tensor-core kernel in one of its forms: a
    tile of ``th`` output rows x ``tw`` columns for ``bn`` output channels
    a CTA, C_in in ``ch``-byte chunks through ``stages`` shared-memory
    stages. ``form`` is ``"wgmma"`` (``conv_igemm_wgmma_kernel``: tiles of
    8 x 8 blocks, 128 or 256 pixels, chunks staged by TMA), ``"mma"``
    (``conv_igemm_kernel``: at most ``IGEMM_BM`` pixels, ``IGEMM_CH``-byte
    chunks) or ``"taps"`` (``conv_igemm_fold_kernel``: the taps folded into
    ``kf`` K bytes, one stage)."""
    k_inst: int                 # the mma kernels' KT: 3, or 0 (any k)
    th: int
    tw: int
    bn: int
    stages: int
    smem: int                   # dynamic shared memory, bytes
    ctas: int                   # work items: a CTA each of the mma.sync
                                # forms; the wgmma form's grid is at most
                                # one CTA an SM, each walking several
    kf: int = 0                 # folded taps: K bytes; 0 otherwise
    form: str = "mma"
    ch: int = IGEMM_CH


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


def wgmma_planes(th: int, tw: int, bn: int, k: int) -> tuple:
    """The wgmma form's 16-channel planes, as its launcher lays them out:
    ``(patch_box, patch_pitch, wplane)`` -- one TMA box of the tile's input
    patch (u8 [rows_in][cols_in][16], halo included), its pitch in a stage
    (rounded up to ``WG_ALIGN``), and one weight plane (s8 [k*k][bn][16])."""
    box = (th + k - 1) * (tw + k - 1) * 16
    return box, _cdiv(box, WG_ALIGN) * WG_ALIGN, k * k * bn * 16


def wgmma_smem(th: int, tw: int, bn: int, k: int, ch: int,
               stages: int) -> int:
    """Dynamic shared memory of the wgmma form (without the fold's warp
    maxima): the alignment's slack, ``stages`` stages of ``ch // 16``
    patch and weight planes, a full and an empty mbarrier a stage."""
    _, pitch, wplane = wgmma_planes(th, tw, bn, k)
    return WG_ALIGN + stages * (ch // 16 * (pitch + wplane) + 16)


def _wgmma_stages(c_in: int, th: int, tw: int, bn: int, k: int):
    """``(ch, stages, smem)`` of a wgmma tile: 32-channel chunks for blocks
    of 128 channels over 256 or more input channels (a stage of 64 would
    leave room for 2: more, smaller stages ran faster there), else 64 (or
    32 where C_in takes one 32-byte k-step); the most stages up to
    ``WG_MAX_STAGES`` (no more than its chunks; 2 at least over several)
    whose shared memory, the fold's maxima included, fits a CTA; the
    other chunk where none does; None where nothing fits."""
    want = 32 if (bn == 128 and c_in >= 256) or c_in <= 32 else 64
    for ch in (want, 96 - want):
        chunks = _cdiv(c_in, ch)
        for stages in range(min(WG_MAX_STAGES, chunks), 0, -1):
            if chunks > 1 and stages < 2:
                break
            smem = wgmma_smem(th, tw, bn, k, ch, stages)
            if smem + IGEMM_FOLD_RED <= SMEM_MAX:
                return ch, stages, smem
    return None


@functools.lru_cache(maxsize=256)
def wgmma_launches(c_in: int, c_out: int, k: int, stride: int) -> tuple:
    """The wgmma form's launches that fit a CTA for a conv of c_in
    channels (a multiple of 16) -> c_out at k x k, stride 1, whatever the
    batch and frame: ``(th, tw, bn, (ch, stages, smem))`` of each tile of
    ``WG_TILES`` and block of ``WG_BN`` (64 alone up to 64 output
    channels); none where the form does not take the conv. Blocks of 128
    channels over at most 128 input channels (one or two chunks) take
    128-pixel tiles only: the card ran them 10% faster than 256 there. The
    chunking is :func:`_wgmma_stages`'."""
    if stride != 1 or c_in < 16 or c_in % 16 or k * k > 256:
        return ()
    out = []
    for bn in WG_BN:
        if bn > 64 and c_out <= 64:
            continue
        for th, tw in WG_TILES:
            if th + k - 1 > 256 or tw + k - 1 > 256 or (
                    bn == 128 and c_in <= 128 and th * tw == 256):
                continue
            stages = _wgmma_stages(c_in, th, tw, bn, k)
            if stages is not None:
                out.append((th, tw, bn, stages))
    return tuple(out)


def wgmma_config(batch: int, n_rows: int, w_out: int, c_in: int,
                 c_out: int, k: int, stride: int) -> Optional[IgemmConfig]:
    """The wgmma form's launch for output [batch, n_rows, w_out, c_out]
    from c_in channels (a multiple of 16) at k x k, stride 1: None where
    the form does not take the conv. Among :func:`wgmma_launches`, the
    least waves of CTAs over the card's SMs times a CTA's pixels x
    channels over its rate (``WG_RATE``); then the larger tile (each
    staged weight byte serves more pixels), the larger block, the fewer
    tiles, the smaller patch."""
    best = None
    for th, tw, bn, (ch, n_stages, smem) in wgmma_launches(c_in, c_out, k,
                                                          stride):
        tiles = _cdiv(n_rows, th) * _cdiv(w_out, tw)
        ctas = batch * tiles * _cdiv(c_out, bn)
        key = (_cdiv(ctas, SMS) * th * tw * bn / WG_RATE[(th * tw, bn)],
               -th * tw, -bn, tiles, (th + k - 1) * (tw + k - 1))
        if best is None or key < best[0]:
            best = (key, IgemmConfig(0, th, tw, bn, n_stages, smem, ctas, 0,
                                     "wgmma", ch))
    return None if best is None else best[1]


def int_form(c_in: int, c_out: int, k: int, stride: int) -> str:
    """The int8 kernel's form :func:`igemm_config` gives a conv of c_in
    channels (its operands', :func:`igemm_c_in`) -> c_out at k x k,
    stride ``stride``, whatever the batch and frame: ``"wgmma"`` from
    ``WG_MIN_C`` input and output channels where the form takes the conv
    (:func:`wgmma_launches`); ``"taps"`` where the taps fold (C_in <= 4);
    ``"mma"`` otherwise. :func:`int_weights` lays out the levels for it."""
    if c_in >= WG_MIN_C and c_out >= WG_MIN_C and \
            wgmma_launches(c_in, c_out, k, stride):
        return "wgmma"
    return "taps" if igemm_fold_k(c_in, k) else "mma"


def wgmma_descriptors(cfg: IgemmConfig, k: int, q: int, tap: int,
                      block: int) -> tuple:
    """The wgmma form's operands for k-step ``q`` of a stage (channels 32q
    .. 32q + 31 of its chunk), tap ``tap`` = di * k + dj and the CTA's m64
    block ``block`` (its 8 x 8 blocks row-major): ``((a_start, a_lbo,
    a_sbo), (b_start, b_lbo, b_sbo))``, bytes from the stage's start, of
    two no-swizzle K-major tiles -- core matrices of 8 rows x 16
    contiguous bytes, the next 16 bytes of K ``lbo`` on, the next 8 rows
    ``sbo`` on -- as ``conv_igemm_wgmma_kernel`` builds them: A the 8 x 8
    output pixels' patch pixels shifted by the tap in patch plane 2q, B the
    tap's ``bn`` rows of weight plane 2q."""
    _, pitch, wplane = wgmma_planes(cfg.th, cfg.tw, cfg.bn, k)
    cols_in = cfg.tw + k - 1
    bw = cfg.tw // 8
    br, bc = divmod(block, bw)
    di, dj = divmod(tap, k)
    a = (2 * q * pitch + ((8 * br + di) * cols_in + 8 * bc + dj) * 16,
         pitch, cols_in * 16)
    b = (cfg.ch // 16 * pitch + 2 * q * wplane + tap * cfg.bn * 16,
         wplane, 128)
    return a, b


@functools.lru_cache(maxsize=1024)
def igemm_config(batch: int, n_rows: int, w_out: int, c_in: int, c_out: int,
                 k: int, stride: int, form: Optional[str] = None
                 ) -> IgemmConfig:
    """The int8 kernel's launch for output [batch, n_rows, w_out, c_out]
    from c_in channels at k x k, stride ``stride``, in :func:`int_form`'s
    form: the wgmma form's (:func:`wgmma_config`) from ``WG_MIN_C`` input
    and output channels where it takes the conv (stride 1, C_in a multiple
    of 16, a stage that fits); else the mma.sync forms'. ``form`` forces
    one (``"wgmma"``, wherever it takes the conv, else it raises; or
    ``"mma"``: the folded taps where C_in <= 4).

    The mma.sync forms: the smallest of ``IGEMM_BN`` that holds c_out (64
    past it); the tile of the fewest CTAs, then the smallest staged patch,
    among widths ``w_out`` and ``IGEMM_TW`` (each as tall as ``IGEMM_BM``
    slots allow), then the widest, whose stages fit a CTA, with smaller
    channel blocks tried when none does. Two stages when C_in takes more
    than one chunk. A shape nothing fits (a very large k) gets the 1 x 1
    tile of 16 channels, whose ``smem`` says so: :func:`launch_int` raises
    on it. C_in <= 4 at k*k*4 <= 128 takes the folded taps (``kf``): one
    stage, the taps in K."""
    if form not in (None, "wgmma", "mma"):
        raise ValueError(f"igemm_config: form {form!r}")
    if form == "wgmma" or (form is None and
                           int_form(c_in, c_out, k, stride) == "wgmma"):
        cfg = wgmma_config(batch, n_rows, w_out, c_in, c_out, k, stride)
        if cfg is None:
            raise ValueError(f"igemm_config: the wgmma form does not take "
                             f"{c_in} -> {c_out} channels at k={k} "
                             f"stride={stride}")
        return cfg
    kf = igemm_fold_k(c_in, k)
    name = "taps" if kf else "mma"
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
                               batch * best[0][0] * _cdiv(c_out, bn), kf,
                               name)
    bn = IGEMM_BN[0]
    return IgemmConfig(3 if k == 3 else 0, 1, 1, bn, stages,
                       stages * igemm_stage_bytes(1, 1, bn, k, stride, kf),
                       batch * n_rows * w_out * _cdiv(c_out, bn), kf, name)


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
           counter: _build.LaunchCounter,
           form: Optional[str] = None, cfg=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (validated by the caller) and
    count it on ``counter``: dense ``w`` is [k, k, C_in, C_out], depthwise
    ``w`` is [k*k, C]. Returns every output row of the padded input; the
    dense launch takes :func:`dense_config`'s configuration in
    :func:`dense_form`'s form (or in ``form`` forced, or ``cfg``: a
    :class:`StripConfig` or :class:`F64Config` the tests and the timings
    force), the depthwise one :func:`dw_config`'s. The dense tensor-core
    form counts on ``F64_LAUNCHES`` instead, whoever launches it."""
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    if depthwise:
        lib = _build.library("conv_strip", _SIGNATURES)
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
        if cfg is None:
            cfg = dense_config(b, n_rows, w_out, c_in, c_out, kk, stride,
                               form)
        if cfg.smem > SMEM_MAX:
            raise ValueError(f"conv_strip: {cfg.smem} bytes of shared memory "
                             f"for one input channel at k={kk} stride="
                             f"{stride}; a CTA has {SMEM_MAX}")
        if cfg.form == "f64mma":
            err = _build.library("conv_strip_f64mma", _F64_SIGNATURES) \
                .conv_strip_f64mma_launch(
                    *ptr, out.data_ptr(), b, hp, wp, c_in, c_out, kk,
                    stride, float(act_scale), ACTS[act], cfg.th, cfg.tw,
                    cfg.bn, cfg.cc, stream)
            counter = F64_LAUNCHES
        else:
            err = _build.library("conv_strip", _SIGNATURES) \
                .conv_strip_launch(
                    *ptr, out.data_ptr(), b, hp, wp, c_in, c_out, kk,
                    stride, float(act_scale), ACTS[act], cfg.tx, cfg.tyt,
                    cfg.run, cfg.co_b, cfg.cc, stream)
    _build.check(err, "conv_strip_depthwise" if depthwise else "conv_strip")
    counter.inc()
    return out


def conv_strip(x_padded: torch.Tensor, w: torch.Tensor,
               ws: Optional[torch.Tensor] = None, stride: int = 1,
               strip_h: int = 8, act_scale: float = 1.0, act: str = "none",
               bias: Optional[torch.Tensor] = None,
               form: Optional[str] = None) -> torch.Tensor:
    """Dense k x k conv over strips: x_padded [B, Hp, Wp, C_in], w [k, k,
    C_in, C_out] -> [B, (Hp-k)/stride+1, W', C_out] float32, bitwise equal
    to :func:`conv_strip_ref` on integer-valued operands. On the card in
    :func:`dense_form`'s form, or in ``form`` forced (``"fma"`` or
    ``"f64mma"``: the tests and the timings; :func:`dense_config` raises
    where the form does not take the conv, on the CPU too)."""
    kk, c_out = w.shape[0], w.shape[-1]
    if w.ndim != 4 or w.shape[1] != kk or w.shape[2] != x_padded.shape[-1]:
        raise ValueError(f"conv_strip: w {tuple(w.shape)} is not [k, k, "
                         f"{x_padded.shape[-1]}, C_out]")
    if form is not None:
        n_rows = _out_rows(x_padded, kk, stride, strip_h, "conv_strip")
        dense_config(x_padded.shape[0], n_rows,
                     (x_padded.shape[2] - kk) // stride + 1,
                     x_padded.shape[-1], c_out, kk, stride, form)
    if not x_padded.is_cuda:
        return conv_strip_ref(x_padded, w, ws, stride, strip_h, act_scale,
                              act, bias)
    _out_rows(x_padded, kk, stride, strip_h, "conv_strip")
    _check_epilogue(ws, bias, act, c_out, "conv_strip")
    return launch(x_padded, w, ws, bias, act_scale, act, stride, False,
                  LAUNCHES, form)


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
    (:func:`int_weights`) for one of its forms: ``w8`` the int8 levels
    [k, k, C_k, C_out] with zero channels up to C_k = :func:`igemm_c_in`
    (what the plain version takes); ``wt`` the levels as the mma.sync
    forms stage them ([k*k, C_out, C_k], C_k contiguous; folded, [C_out,
    kf] with K = tap*4 + channel), or ``wp`` as the wgmma form's TMA boxes
    read them (plane-major [C_k / 16, k*k, C_out, 16]: a tap's output
    channels' 16 channels of a plane contiguous, so one box of 8-byte
    elements takes a stage's planes, a row a tap's block), the other None;
    ``ws`` and ``bias`` flat contiguous float32 or None; ``maps`` the wgmma
    form's tensor maps of ``wp`` by (output-channel block, chunk) (128
    bytes each), built on the form's first launch at each and kept with
    the layout (a bound view's captures build them at bind)."""
    w8: torch.Tensor
    wt: Optional[torch.Tensor]
    ws: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    wp: Optional[torch.Tensor] = None
    maps: Dict[tuple, ctypes.Array] = field(default_factory=dict,
                                            compare=False, repr=False)

    def levels_map(self, lib, bn: int, ch: int) -> int:
        """Address of ``wp``'s tensor map for the wgmma form's ``bn``-channel
        blocks and ``ch``-channel chunks (boxes of 8-byte elements: ``bn``
        rows of 16 bytes x every tap x ``ch / 16`` planes)."""
        buf = self.maps.get((bn, ch))
        if buf is None:
            planes, taps, c_out, _ = self.wp.shape
            buf = ctypes.create_string_buffer(128)
            _build.check(lib.conv_strip_int_tensor_map(
                ctypes.addressof(buf), self.wp.data_ptr(), taps, c_out,
                16 * planes, bn, ch), "conv_strip_int tensor map")
            self.maps[(bn, ch)] = buf
        return ctypes.addressof(buf)


def int_weights(w: torch.Tensor, ws: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                form: Optional[str] = None) -> IntWeights:
    """Lay out a conv's integer levels w [k, k, C_in, C_out] (and its
    ``ws`` / ``bias``) for the int8 kernel's form at ``stride``
    (:func:`int_form`'s, or ``form`` forced as :func:`igemm_config` takes
    it): the int8 cast and the channel pad, then the transpose (the
    mma.sync forms'), the [C_out, kf] pad (the folded taps') or the
    plane-major copy (the wgmma form's), and the flat float32 scales. A
    bound view does it once a step at bind (``plan.quantized_weights``);
    an unbound call once a launch. (One layout for both forms was tried:
    the plane-major one read by the mma.sync kernel's 16-byte copies
    slowed it 10-15% at VGG16's shapes.)"""
    if form not in (None, "wgmma", "mma"):
        raise ValueError(f"int_weights: form {form!r}")
    kk, c_in, c_out = w.shape[0], w.shape[2], w.shape[-1]
    c_k = igemm_c_in(c_in, kk)
    w8 = w.to(torch.int8)
    if c_k != c_in:
        w8 = F.pad(w8, (0, 0, 0, c_k - c_in))
    if form is None:
        form = int_form(c_k, c_out, kk, stride)
    wt = wp = None
    if form == "wgmma":
        if not wgmma_launches(c_k, c_out, kk, 1):
            raise ValueError(f"int_weights: the wgmma form does not take "
                             f"{c_k} -> {c_out} channels at k={kk}")
        wp = w8.reshape(kk * kk, c_k // 16, 16, c_out).permute(
            1, 0, 3, 2).contiguous()
    elif igemm_fold_k(c_k, kk):
        wt = F.pad(w8.reshape(-1, c_out).t(),
                   (0, igemm_fold_k(c_k, kk) - kk * kk * IGEMM_FOLD_C)
                   ).contiguous()
    else:
        wt = w8.reshape(kk * kk, c_k, c_out).transpose(1, 2).contiguous()
    flat = [t if t is None else t.reshape(-1).to(torch.float32).contiguous()
            for t in (ws, bias)]
    return IntWeights(w8, wt, *flat, wp)


@dataclass(frozen=True)
class Fold:
    """The plan's epilogue up to its pool, folded into the int8 kernel's
    store: ``act_scale`` a tensor of 1 or B values (on the device: a
    CUDA graph captures the conv after the requant that wrote it), ``ws``
    and ``bias`` of 1 or C_out values (``bias`` may be None), ``act`` one
    of ``fused.ACTS``."""
    act_scale: torch.Tensor
    ws: torch.Tensor
    bias: Optional[torch.Tensor]
    act: str


def fold_partials(b: int, cfg: IgemmConfig) -> int:
    """The fold's partial maxima a frame: one a work item, a tile's
    channel block (a CTA of the mma.sync forms; the wgmma form's CTAs walk
    several), one frame's: its tiles times its channel blocks."""
    return cfg.ctas // b


def launch_int(x_padded: torch.Tensor, iw: IntWeights, act_scale: float,
               act: str, stride: int, fold: Optional[Fold] = None,
               cfg: Optional[IgemmConfig] = None):
    """Launch the int8 kernel on CUDA tensors (validated by the caller) and
    count it on ``INT_LAUNCHES``: ``x_padded`` takes :func:`int_codes`'
    form (callers on the path hand it over already), the levels, ``ws``
    and ``bias`` :func:`int_weights`' layout, and :func:`igemm_config`'s
    configuration is taken (or ``cfg``: the tests and the timings force a
    form). With ``fold`` (``iw``'s own ``ws`` and ``bias`` unused) ->
    ``(y, partials)``: y unpooled, activated and clamped at 0, and partials
    [B, :func:`fold_partials`] each work item's max of y; else the output. The
    wgmma form's codes need a 16-byte-aligned base (a tensor map's): a
    view that has none raises."""
    dev = x_padded.device
    kk, c_out = iw.w8.shape[0], iw.w8.shape[-1]
    flat = [t.reshape(-1).to(torch.float32).contiguous()
            if t is not None else None
            for t in ((fold.act_scale, fold.ws, fold.bias) if fold
                      else (None, iw.ws, iw.bias))]
    x = int_codes(x_padded, kk).contiguous()
    b, hp, wp, c_k = x.shape
    n_rows = (hp - kk) // stride + 1
    w_out = (wp - kk) // stride + 1
    if cfg is None:
        cfg = igemm_config(b, n_rows, w_out, c_k, c_out, kk, stride)
    levels = iw.wp if cfg.form == "wgmma" else iw.wt
    if levels is None:
        raise ValueError(f"conv_strip_int: the levels are not laid out for "
                         f"the {cfg.form} form (int_weights' stride or "
                         f"form)")
    for t in (levels, *flat):
        if t is not None and t.device != dev:
            raise ValueError(f"conv_strip_int: operands on {dev} and "
                             f"{t.device}")
    out = torch.empty((b, n_rows, w_out, c_out), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        if fold:
            raise ValueError("conv_strip_int: a folded epilogue of nothing")
        return out
    smem = cfg.smem + (IGEMM_FOLD_RED if fold else 0)
    if smem > SMEM_MAX:
        raise ValueError(f"conv_strip_int: {smem} bytes of shared memory "
                         f"at k={kk} stride={stride}; a CTA has {SMEM_MAX}")
    if cfg.form == "wgmma":
        if x.data_ptr() % 16:
            raise ValueError("conv_strip_int: the wgmma form's codes start "
                             "off a 16-byte boundary (a tensor map's base)")
        lib = _build.library("conv_strip_wgmma", _WG_SIGNATURES)
        weights = iw.levels_map(lib, cfg.bn, cfg.ch)
        launch = (cfg.th, cfg.tw, cfg.bn, cfg.ch, cfg.stages)
        entry, fold_entry = (lib.conv_strip_int_wgmma_launch,
                             lib.conv_strip_int_wgmma_fold_launch)
    else:
        lib = _build.library("conv_strip", _SIGNATURES)
        weights = iw.wt.data_ptr()
        launch = (cfg.th, cfg.tw, cfg.bn, cfg.stages)
        entry, fold_entry = (lib.conv_strip_int_launch,
                             lib.conv_strip_int_fold_launch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if fold is None:
        err = entry(
            x.data_ptr(), weights,
            *[None if t is None else t.data_ptr() for t in flat[1:]],
            out.data_ptr(), b, hp, wp, c_k, c_out, kk, stride,
            float(act_scale), ACTS[act], *launch, stream)
        _build.check(err, "conv_strip_int")
        INT_LAUNCHES.inc()
        return out
    s, ws, bias = flat
    if fold.act not in ACTS or s.numel() not in (1, b) or \
            ws.numel() not in (1, c_out) or \
            (bias is not None and bias.numel() not in (1, c_out)):
        raise ValueError(f"conv_strip_int: a fold of act {fold.act!r}, "
                         f"{s.numel()} scales, {ws.numel()} ws and "
                         f"{None if bias is None else bias.numel()} biases "
                         f"for {b} frames of {c_out} channels")
    partials = torch.empty((b, fold_partials(b, cfg)), dtype=torch.float32,
                           device=dev)
    err = fold_entry(
        x.data_ptr(), weights, ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        partials.data_ptr(), s.data_ptr(), s.numel(), ws.numel(),
        0 if bias is None else bias.numel(), b, hp, wp, c_k, c_out, kk,
        stride, ACTS[fold.act], *launch, stream)
    _build.check(err, "conv_strip_int (folded epilogue)")
    INT_LAUNCHES.inc()
    return out, partials


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
    return launch_int(x_padded, int_weights(w, ws, bias, stride), act_scale,
                      act, stride)


def fold_ref(acc: torch.Tensor, fold: Fold, cfg: IgemmConfig):
    """Plain version of the fold's store on the raw accumulate ``acc``
    [B, H, W, C_out]: y = act(acc * (act_scale * ws) + bias) clamped at
    0 (the plan's association), and each CTA's max of y over
    ``cfg``'s tiles (``th`` x ``tw`` pixels of ``bn`` channels, in the
    kernel's CTA order, which every form shares: row tiles, column tiles,
    channel blocks) -> ``(y, partials [B, tiles * blocks])``."""
    b, h, w, c = acc.shape
    s = fold.act_scale.reshape(-1).float()
    s = s.reshape(-1, 1, 1, 1) if s.numel() > 1 else s.reshape(())
    y = acc * (s * fold.ws.reshape(-1).float())
    if fold.bias is not None:
        y = y + fold.bias.reshape(-1).float()
    y = torch.clamp_min(_activation(y, fold.act), 0.0)
    th, tw, bn = cfg.th, cfg.tw, cfg.bn
    tiles = F.pad(y, (0, -c % bn, 0, -w % tw, 0, -h % th))
    tiles = tiles.reshape(b, -(-h // th), th, -(-w // tw), tw, -(-c // bn),
                          bn)
    partials = tiles.amax(dim=(2, 4, 6)).reshape(b, -1)
    return y, partials


def conv_strip_int_laid(x_padded: torch.Tensor, iw: IntWeights,
                        stride: int = 1, act_scale: float = 1.0,
                        act: str = "none", fold: Optional[Fold] = None,
                        cfg: Optional[IgemmConfig] = None):
    """:func:`conv_strip_int` on levels laid out once (:func:`int_weights`,
    its ``ws`` and ``bias`` with them) and x_padded in :func:`int_codes`'
    form; bitwise equal to :func:`conv_strip_int_ref` on ``iw.w8``. With
    ``fold`` (``act_scale``, ``act`` and ``iw``'s ``ws`` and ``bias``
    unused) -> ``(y, partials)`` as :func:`launch_int` gives them, bitwise
    equal to :func:`fold_ref` on the plain raw accumulate. ``cfg`` forces
    a launch (the tests and the timings; the levels laid out for its
    form), else :func:`igemm_config`'s is taken."""
    _, c_out = _check_int(x_padded, iw.w8, stride)
    if fold is None:
        _check_epilogue(iw.ws, iw.bias, act, c_out, "conv_strip_int")
    elif fold.act not in ACTS:
        raise ValueError(f"conv_strip_int: act {fold.act!r} not in "
                         f"{tuple(ACTS)}")
    if x_padded.is_cuda:
        return launch_int(x_padded, iw, act_scale, act, stride, fold, cfg)
    if fold is None:
        return conv_strip_int_ref(x_padded, iw.w8, iw.ws, stride, act_scale,
                                  act, iw.bias)
    acc = conv_strip_int_ref(x_padded, iw.w8, stride=stride)
    b, n_rows, w_out, _ = acc.shape
    if cfg is None:
        cfg = igemm_config(b, n_rows, w_out, igemm_c_in(iw.w8.shape[2],
                                                        iw.w8.shape[0]),
                           c_out, iw.w8.shape[0], stride)
    return fold_ref(acc, fold, cfg)
