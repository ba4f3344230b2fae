"""Plain PyTorch versions of the conv kernels.

``conv_taps_int`` is the integer-exact conv accumulate on float-carried
codes, written as the k*k tap loop the fused chain kernel runs;
``conv_int_ref`` runs it per feature group; ``conv_chain_ref`` is the
plain version of the fused chain kernel, whole frames through every stage
with the epilogue of ``core.plan._execute_steps`` term for term.

The accumulate is exact: the operands are small integers (codes 0..15,
levels |q| <= 127) and each tap's matmul runs in float64, where every
partial sum is an exact integer, so no summation order can change a bit.
It is not ``F.conv2d``: on the card cuDNN may pick Winograd or FFT
algorithms for 3x3 convs, whose transforms round, and it differs from the
exact sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.accelerator import _activation, _crc_requant, _pool


def _pad_nhwc(x: torch.Tensor, pads) -> torch.Tensor:
    (plo, phi), (qlo, qhi) = pads
    return F.pad(x, (0, 0, qlo, qhi, plo, phi))


def conv_int_ref(codes: torch.Tensor, wq: torch.Tensor, stride: int, pads,
                 groups: int = 1) -> torch.Tensor:
    """[B,H,W,Cin] codes x [k,k,Cin/g,Cout] levels -> f32 [B,H',W',Cout]."""
    k, _, cg, c_out = wq.shape
    if groups == 1:
        return conv_taps_int(codes, wq, k, stride, pads)
    if cg == 1 and c_out == groups == codes.shape[-1]:
        return conv_taps_int(codes, wq, k, stride, pads, depthwise=True)
    og = c_out // groups
    return torch.cat([
        conv_taps_int(codes[..., g * cg:(g + 1) * cg],
                      wq[..., g * og:(g + 1) * og], k, stride, pads)
        for g in range(groups)], dim=-1)


def conv_taps_int(x: torch.Tensor, wq: torch.Tensor, kernel: int,
                  stride: int, pads, depthwise: bool = False) -> torch.Tensor:
    """Integer-exact conv accumulate as a k*k tap loop of shifted windows
    (float64 inside, float32 out)."""
    k, s = kernel, stride
    xp = _pad_nhwc(x.double(), pads)
    b, hp, wp, c_in = xp.shape
    h_out = (hp - k) // s + 1
    w_out = (wp - k) // s + 1
    wf = wq.double()
    acc = torch.zeros((b, h_out, w_out, wf.shape[-1]), dtype=torch.float64,
                      device=x.device)
    for di in range(k):
        for dj in range(k):
            patch = xp[:, di:di + (h_out - 1) * s + 1:s,
                       dj:dj + (w_out - 1) * s + 1:s, :]
            if depthwise:
                acc = acc + patch * wf[di, dj, 0]
            else:
                acc = acc + torch.matmul(patch, wf[di, dj])
    return acc.float()


def conv_chain_ref(codes: torch.Tensor, act_scale, stages, a_qmax):
    """A fused conv segment, plain: quantized codes -> (codes, scale).

    ``stages``: sequence of ``(geom: dispatch.ChainGeom, wq, ws, bias)``.
    ``act_scale`` is 0-d (per-tensor, batch 1) or [B, 1, 1, 1]. Returns the
    last stage's codes and its per-frame scale [B, 1, 1, 1].
    """
    x, scale = codes, act_scale
    for geom, wq, ws, bias in stages:
        acc = conv_taps_int(x, wq, geom.kernel, geom.stride, geom.pads,
                            depthwise=geom.depthwise)
        out = acc * (scale * ws.reshape(1, 1, 1, -1))
        if bias is not None:
            out = out + bias
        y = _activation(out, geom.act)
        if geom.pool is not None:
            y = _pool(y, *geom.pool)
        x, scale = _crc_requant(y, a_qmax, per_frame=True)
    return x, scale
