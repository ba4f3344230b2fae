"""The public ``conv_bank`` op: one k x k stride-1 conv through the OC
mapping, end to end (quantize -> pad -> kernel -> epilogue), with the
reference's semantics.

Two strategies, resolved like ``dispatch.select_conv_strategy``:

  resident — the whole padded frame as one strip: the dense strip kernel
             (``csrc/conv_strip.cu``) launched by this op and counted on
             its own ``LAUNCHES``; it stands in for the reference's
             ``kernel.conv_bank_kernel``;
  strip    — ``strip.conv_strip`` over the strips the strategy resolved.

Both accumulate the same exact integers on the quantized path, so they are
bitwise equal there. Without a spec the op is a float conv: the kernel
sums float64 products in its own order, so it agrees with the reference's
float mode within a tolerance, not bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import WASpec, quantize_weight, true_div
from repro_torch.kernels import _build
from repro_torch.kernels.conv_bank import strip as SK
from repro_torch.kernels.conv_bank.fused import ACTS
from repro_torch.kernels.dispatch import select_conv_strategy

LAUNCHES = _build.LaunchCounter("conv_bank")


def conv_bank(x: torch.Tensor, w: torch.Tensor,
              spec: Optional[WASpec] = None, act_scale: float = 1.0 / 15.0,
              padding: str = "SAME", bn: int = 64,
              strategy: Optional[str] = None, act: str = "none",
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k x k conv through the OC mapping. x [B,H,W,Cin]; w [k,k,Cin,Cout]
    -> [B,H',W',Cout] float32, on x's device.

    With ``spec`` the integer photonic path runs (CRC codes of
    ``x / act_scale`` times the weight levels) and ``act``/``bias`` fuse the
    per-layer epilogue into the kernel; without it, a float conv (``act``
    and ``bias`` unused, as in the reference). SAME pads ``k // 2`` a side.
    ``strategy``: ``resident`` | ``strip`` | ``auto`` | ``None`` (auto).
    ``bn`` is the reference's output-channel block; the CUDA kernel picks
    its own, so it changes nothing.

    A CUDA tensor launches the kernels; a CPU tensor runs their plain
    versions (:func:`conv_bank_plain`).
    """
    return _conv_bank(x, w, spec, act_scale, padding, strategy, act, bias,
                      plain=not x.is_cuda)


def conv_bank_plain(x: torch.Tensor, w: torch.Tensor,
                    spec: Optional[WASpec] = None,
                    act_scale: float = 1.0 / 15.0, padding: str = "SAME",
                    bn: int = 64, strategy: Optional[str] = None,
                    act: str = "none", bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """:func:`conv_bank` through the kernels' plain versions, on any
    device."""
    return _conv_bank(x, w, spec, act_scale, padding, strategy, act, bias,
                      plain=True)


def _conv_bank(x, w, spec, act_scale, padding, strategy, act, bias,
               plain: bool) -> torch.Tensor:
    if x.ndim != 4 or w.ndim != 4 or w.shape[0] != w.shape[1] \
            or w.shape[2] != x.shape[-1]:
        raise ValueError(f"conv_bank: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [B,H,W,Cin] and "
                         f"[k,k,Cin,Cout]")
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"conv_bank: unknown padding {padding!r}")
    if act not in ACTS:
        raise ValueError(f"conv_bank: act {act!r} not in {tuple(ACTS)}")
    kk, c_out = w.shape[0], w.shape[-1]
    if bias is not None and bias.numel() != c_out:
        raise ValueError(f"conv_bank: bias has {bias.numel()} entries for "
                         f"{c_out} output channels")
    pad = kk // 2 if padding == "SAME" else 0
    h_out = x.shape[1] + 2 * pad - kk + 1
    w_out = x.shape[2] + 2 * pad - kk + 1
    strat = select_conv_strategy(h_out, w_out, x.shape[-1], c_out, kk,
                                 stride=1, mode=strategy or "auto")
    if spec is not None:
        codes = torch.clamp(torch.round(true_div(x.float(), act_scale)), 0,
                            spec.a_qmax)
        wq, ws = quantize_weight(w, spec)
        xin, wf, wsf = codes, wq.float(), ws.reshape(-1)
    else:
        xin, wf, wsf = x.float(), w.float(), None
        act_scale, act, bias = 1.0, "none", None
    xin = F.pad(xin, (0, 0, pad, pad, pad, pad))
    if strat.kind == "strip":
        xin = SK.pad_rows_for_strips(xin, kk, 1, strat.strip_rows,
                                     strat.n_strips)
        run = SK.conv_strip_ref if plain else SK.conv_strip
        return run(xin, wf, wsf, 1, strat.strip_rows, act_scale, act,
                   bias)[:, :h_out]
    if plain:
        return SK.conv_strip_ref(xin, wf, wsf, 1, h_out, act_scale, act,
                                 bias)
    return SK.launch(xin, wf, wsf, bias, act_scale, act, 1, False, LAUNCHES)
