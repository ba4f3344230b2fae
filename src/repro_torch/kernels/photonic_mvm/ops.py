"""Wrapper of the photonic MVM kernel (``csrc/photonic_mvm.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``ref.mvm_int_ref``). There is no fallback between the two.
:func:`photonic_mvm` is the float API over it (the reference's
``kernels/photonic_mvm/ops.py``): signed CRC codes in [-15, 15] and
per-channel MR levels, then ``mvm_int``.

Every route reads the levels laid out once (:func:`mvm_weights`): int8
[N, k_pad], K contiguous, zero up to a multiple of 128 bytes. A bound view
lays them out at bind (``plan.quantized_weights``) and calls
:func:`mvm_int_laid`; :func:`mvm_int` on [K, N] levels lays them out on
each call.

:func:`mvm_config` picks the kernel's route and tile from the shape
alone, so it is tested on the CPU; the launcher refuses any other.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.core.quant import WASpec, quantize_weight
from repro_torch.kernels import _build
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref, signed_codes

LAUNCHES = _build.LaunchCounter("photonic_mvm")
_SIGNATURES = {
    "mvm_int_launch": (ctypes.c_void_p,) * 4 + (
        ctypes.c_float, ctypes.c_void_p) + (ctypes.c_int,) * 7 + (
        ctypes.c_void_p,),
    "mvm_tensor_map": (ctypes.c_void_p, ctypes.c_void_p) + (
        ctypes.c_int,) * 3,
    "mvm_layout_launch": (ctypes.c_void_p, ctypes.c_void_p) + (
        ctypes.c_int,) * 3 + (ctypes.c_void_p,)}

SMS = 132                       # H100 SXM
KBOX = 128                      # bytes of K a TMA box; the layout's K pad
GEMM_TILE = (16, 64)            # the gemm route's CTA tile (rows, columns)
GEMM_SMEM = 3 * 48              # its 3-stage ring, 48 bytes a tile row
SKINNY_ROWS = 1024              # rows of A a skinny CTA stages
SKINNY_MAX_K, SKINNY_MAX_N = 32, 8
STREAM_MAX_M = 16               # two n8 tiles of codes
STREAM_CH = 16                  # output channels a stream CTA
# the stream CTA's dynamic shared memory: 4 stages of 8 boxes of 16 x 128
# bytes, sixteen 16 x 16 int32 tiles (the 16 warps' sums), 8 mbarriers,
# and 1 KB to align the ring to the swizzle's 1024 bytes
STREAM_SMEM = 4 * 8 * 16 * KBOX + 16 * 256 * 4 + 8 * 8 + 1024
WGMMA_TILE = 64                 # rows and columns of a wgmma CTA tile
WGMMA_STAGES = 4
_ROUTES = {"skinny": 0, "gemm": 1, "stream": 2, "wgmma": 3}


# the wgmma CTA's dynamic shared memory: 4 stages of a 64 x 128-byte box of
# codes and one of levels, 8 mbarriers, 1 KB to align
WGMMA_SMEM = WGMMA_STAGES * 2 * WGMMA_TILE * KBOX + 8 * 8 + 1024


@dataclass(frozen=True)
class MvmConfig:
    """One launch of the kernel: route, CTA tile (bm rows of the output x
    bn columns; the stream route's bm covers every row, its bn is 16
    channels; the skinny route's bn is N), and what that gives. Every CTA
    covers all of K."""
    route: str
    bm: int
    bn: int
    ctas: int = 0
    smem: int = 0               # shared memory of one CTA, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_pad(k: int) -> int:
    """K of the laid-out levels: a whole number of 128-byte boxes, one at
    least."""
    return max(1, _cdiv(k, KBOX)) * KBOX


@functools.lru_cache(maxsize=1024)
def mvm_config(m: int, k: int, n: int) -> MvmConfig:
    """The route and tile of ``mvm_int`` at M x K x N.

    * ``skinny``: N <= 8 and K <= 32 (the imaging path's resident convs).
    * ``stream``: M <= 16 (the dense layers at every bucket; VGG16's
      fc1-fc3): 16 output channels a CTA.
    * ``wgmma``: M > 16 and K a positive multiple of 16 (a tensor map's row
      stride): conv11-13's and the vision GEMMs, 64 x 64 tiles.
    * ``gemm``: the rest, M > 16 with K not a multiple of 16 (the
      1-channel im2col's K = 9), 16 x 64 tiles.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W
    (``scripts/mvm_routes.py --alternatives``, device ms a call): the
    64 x 64 wgmma tile took conv11-13 at batch 8 in 0.0141 ms against
    64 x 128's 0.0144, and the vision GEMMs in 0.0045-0.0052 against
    0.0066-0.0072; wgmma beat every gemm tile wherever both run. A K split
    over a thread-block cluster was no faster at any path shape (fc2 at
    batch 8: 0.0085 unsplit, 0.0120 over 2; fc3: 0.0053 against 0.0057;
    conv11-13 at batch 1, M = 196: 0.0102 either way; the vision GEMMs:
    0.0044-0.0065 unsplit, 0.0061-0.0075 split), so no route splits K.
    The gemm route keeps the shapes no tensor map takes: the vision
    path's (2048, 9, 64), 0.00280 ms on 16 x 64 tiles, within 4% of every
    other tile tried (16 x 32 0.00287, 16 x 16 0.00289, 32 x 32 0.00290).
    """
    if n <= SKINNY_MAX_N and k <= SKINNY_MAX_K:
        return MvmConfig("skinny", SKINNY_ROWS, n, _cdiv(m, SKINNY_ROWS),
                         SKINNY_ROWS * SKINNY_MAX_K + 16
                         + 4 * SKINNY_MAX_K * n)
    if m <= STREAM_MAX_M:
        return MvmConfig("stream", 8 if m <= 8 else 16, STREAM_CH,
                         _cdiv(n, STREAM_CH), STREAM_SMEM)
    if k > 0 and k % 16 == 0:
        return MvmConfig("wgmma", WGMMA_TILE, WGMMA_TILE,
                         _cdiv(m, WGMMA_TILE) * _cdiv(n, WGMMA_TILE),
                         WGMMA_SMEM)
    bm, bn = GEMM_TILE
    return MvmConfig("gemm", bm, bn, _cdiv(m, bm) * _cdiv(n, bn),
                     GEMM_SMEM * (bm + bn))


@dataclass(frozen=True)
class MvmWeights:
    """Levels laid out once for the kernel (:func:`mvm_weights`): ``wt``
    int8 [N, k_pad], K contiguous, zero from ``k`` up to ``k_pad``;
    ``maps`` the levels' tensor maps by box rows (128 bytes each), built
    on a route's first launch and kept with the layout."""
    wt: torch.Tensor
    k: int
    maps: Dict[int, ctypes.Array] = field(default_factory=dict,
                                          compare=False, repr=False)

    @property
    def n(self) -> int:
        return self.wt.shape[0]

    @property
    def k_pad(self) -> int:
        return self.wt.shape[1]

    def levels(self) -> torch.Tensor:
        """The levels as the plain version takes them: a [K, N] view."""
        return self.wt[:, :self.k].t()


def mvm_weights(wq: torch.Tensor) -> MvmWeights:
    """Lay out integer levels wq [K, N] for every route: the int8 cast,
    the transpose to K contiguous and the zero pad of K to whole 128-byte
    boxes. A bound view does it once a layer at bind; :func:`mvm_int`
    once a call. On the card one launch of the library's layout kernel
    (not counted on ``LAUNCHES``, which counts the products); on the CPU
    its plain version."""
    if wq.ndim != 2:
        raise ValueError(f"mvm_weights: levels must be [K, N], got "
                         f"{tuple(wq.shape)}")
    k, n = wq.shape
    kp = k_pad(k)
    w = wq.to(torch.int8)
    wt = torch.empty((n, kp), dtype=torch.int8, device=w.device)
    if not w.is_cuda:
        wt[:, :k].copy_(w.t())
        wt[:, k:].zero_()
    elif n:
        w = w.contiguous()
        lib = _build.library("photonic_mvm", _SIGNATURES)
        _build.check(lib.mvm_layout_launch(
            w.data_ptr(), wt.data_ptr(), k, n, kp,
            torch.cuda.current_stream(w.device).cuda_stream),
            "photonic_mvm layout")
    return MvmWeights(wt, k)


def _levels_map(lib, mw: MvmWeights, rows: int) -> int:
    """Address of the levels' tensor map with ``rows``-row boxes."""
    buf = mw.maps.get(rows)
    if buf is None:
        buf = ctypes.create_string_buffer(128)
        _build.check(lib.mvm_tensor_map(
            ctypes.addressof(buf), mw.wt.data_ptr(), mw.n, mw.k_pad, rows),
            "photonic_mvm tensor map")
        mw.maps[rows] = buf
    return ctypes.addressof(buf)


def mvm_int_laid(a_codes: torch.Tensor, mw: MvmWeights,
                 ws: Optional[torch.Tensor] = None,
                 act_scale: float = 1.0) -> torch.Tensor:
    """:func:`mvm_int` on levels laid out once (:func:`mvm_weights`):
    int8 codes [M, K] -> f32 [M, N], bitwise equal to ``mvm_int_ref`` on
    ``mw.levels()``. On the card, :func:`launch` at :func:`mvm_config`'s
    launch."""
    if a_codes.ndim != 2 or a_codes.shape[1] != mw.k:
        raise ValueError(f"mvm_int: codes {tuple(a_codes.shape)} do not "
                         f"chain with levels of K={mw.k}")
    if ws is not None and ws.numel() != mw.n:
        raise ValueError(f"mvm_int: ws has {ws.numel()} scales for "
                         f"N={mw.n}")
    if not a_codes.is_cuda:
        return mvm_int_ref(a_codes, mw.levels(), ws, act_scale)
    return launch(a_codes, mw, mvm_config(a_codes.shape[0], mw.k, mw.n), ws,
                  act_scale)


def launch(a_codes: torch.Tensor, mw: MvmWeights, cfg: MvmConfig,
           ws: Optional[torch.Tensor] = None,
           act_scale: float = 1.0) -> torch.Tensor:
    """The kernel at launch ``cfg`` on CUDA codes [M, K] and laid-out
    levels: one launch on ``LAUNCHES``. :func:`mvm_int_laid` takes
    :func:`mvm_config`'s launch; the tests and the route timings hold
    every route at one shape through here. The launcher refuses a launch
    it has no kernel for."""
    m, k = a_codes.shape
    n = mw.n
    for t in (mw.wt, ws):
        if t is not None and t.device != a_codes.device:
            raise ValueError(f"mvm_int: operands on {a_codes.device} and "
                             f"{t.device}")
    if a_codes.dtype != torch.int8:
        raise TypeError(f"mvm_int: the kernel takes int8 codes, got "
                        f"{a_codes.dtype}")
    a = a_codes.contiguous()
    if cfg.route == "wgmma" and a.data_ptr() % 16:
        a = a.clone()                    # a tensor map's 16-byte base
    s = None if ws is None else ws.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library("photonic_mvm", _SIGNATURES)
    wmap = None
    if cfg.route in ("stream", "wgmma"):
        wmap = _levels_map(lib, mw, cfg.bn)
    err = lib.mvm_int_launch(
        a.data_ptr(), mw.wt.data_ptr(), wmap,
        None if s is None else s.data_ptr(), float(act_scale),
        out.data_ptr(), m, n, k, mw.k_pad, _ROUTES[cfg.route],
        cfg.bm, cfg.bn, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "photonic_mvm")
    LAUNCHES.inc()
    return out


def mvm_int(a_codes: torch.Tensor, wq: torch.Tensor,
            ws: Optional[torch.Tensor] = None,
            act_scale: float = 1.0) -> torch.Tensor:
    """int8 codes [M, K] x int8 levels [K, N], f32 scales [N] -> f32 [M, N].

    ``(acc * act_scale) * ws[n]``, or ``acc * act_scale`` without ``ws``,
    bitwise equal to ``mvm_int_ref``. Any M, K, N: the kernel masks the
    ragged edges itself, so the codes are not padded. The levels are laid
    out on each call (:func:`mvm_weights`); :func:`mvm_int_laid` takes
    them laid out once. One call is one launch on ``LAUNCHES``.
    """
    if a_codes.ndim != 2 or wq.ndim != 2 or a_codes.shape[1] != wq.shape[0]:
        raise ValueError(f"mvm_int: shapes {tuple(a_codes.shape)} x "
                         f"{tuple(wq.shape)} do not chain")
    if ws is not None and ws.numel() != wq.shape[1]:
        raise ValueError(f"mvm_int: ws has {ws.numel()} scales for "
                         f"N={wq.shape[1]}")
    if not a_codes.is_cuda:
        return mvm_int_ref(a_codes, wq, ws, act_scale)
    if wq.device != a_codes.device:
        raise ValueError(f"mvm_int: operands on {a_codes.device} and "
                         f"{wq.device}")
    if a_codes.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"mvm_int: the kernel takes int8 operands, got "
                        f"{a_codes.dtype} and {wq.dtype}")
    return mvm_int_laid(a_codes, mvm_weights(wq), ws, act_scale)


def photonic_mvm_prequant(a_signed_codes: torch.Tensor, wq: torch.Tensor,
                          ws: torch.Tensor, act_scale: float = 1.0
                          ) -> torch.Tensor:
    """Already-quantized operands (int8 carriers) -> dequantized output.

    a_signed_codes [..., K] int8 in [-15, 15]; wq [K, N] int8; ws [N].
    """
    *lead, kdim = a_signed_codes.shape
    n = wq.shape[-1]
    out = mvm_int(a_signed_codes.reshape(-1, kdim), wq, ws.reshape(-1),
                  act_scale)
    return out.reshape(*lead, n)


def photonic_mvm(x: torch.Tensor, w: torch.Tensor, spec: WASpec,
                 act_scale: float = 1.0 / 15.0) -> torch.Tensor:
    """Float API: x [..., K] @ w [K, N] under [W:A] ``spec``.

    Quantizes both operands as the sensor and the MRs would, then runs the
    integer kernel: bitwise equal to ``ref.photonic_mvm_ref``.
    """
    *lead, kdim = x.shape
    wq, ws = quantize_weight(w, spec)
    y = photonic_mvm_prequant(signed_codes(x.reshape(-1, kdim), spec,
                                           act_scale), wq, ws, act_scale)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)
