"""Plain PyTorch versions of the conv kernels, and the conv_bank oracles.

``conv_taps_int`` is the integer-exact conv accumulate on float-carried
codes, written as the k*k tap loop the conv kernels run; ``conv_int_ref``
runs it per feature group; ``conv_chain_ref`` is the plain version of the
fused chain kernel, whole frames through every stage with the epilogue of
``core.plan._execute_steps`` term for term. ``conv_bank_ref`` and
``conv_bank_quant_ref`` are the reference's oracles of the ``conv_bank``
op (a float conv; the integer device semantics without the epilogue).

The accumulate is exact: the operands are small integers (codes 0..15,
levels |q| <= 127) and each tap's matmul runs in float64, where every
partial sum is an exact integer, so no summation order can change a bit.
It is not ``F.conv2d``: on the card cuDNN may pick Winograd or FFT
algorithms for 3x3 convs, whose transforms round, and it differs from the
exact sum.
"""

from __future__ import annotations

import contextlib

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


def _stride1_pads(kernel: int, padding: str):
    """XLA's stride-1 SAME/VALID padding, as the reference's oracles pass
    the padding string to ``lax.conv_general_dilated``."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"unknown padding {padding!r}")
    lo = (kernel - 1) // 2 if padding == "SAME" else 0
    hi = kernel - 1 - lo if padding == "SAME" else 0
    return ((lo, hi), (lo, hi))


@contextlib.contextmanager
def float32_convs():
    """Full float32 convolutions and matmuls for the block: on the card
    cuDNN runs float32 convolutions in TF32 unless told not to."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def conv_bank_ref(x: torch.Tensor, w: torch.Tensor,
                  padding: str = "SAME") -> torch.Tensor:
    """Float conv oracle. x [B,H,W,Cin]; w [k,k,Cin,Cout] -> [B,H',W',Cout].

    ``F.conv2d`` in float32 with TF32 off; its summation order is cuDNN's
    or the CPU's own, so it is an oracle within a tolerance.
    """
    xp = _pad_nhwc(x.float(), _stride1_pads(w.shape[0], padding))
    with float32_convs():
        y = F.conv2d(xp.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def conv_bank_quant_ref(x: torch.Tensor, w: torch.Tensor, spec,
                        act_scale: float = 1.0 / 15.0,
                        padding: str = "SAME") -> torch.Tensor:
    """Quantized conv oracle — the device's integer semantics: CRC codes of
    ``x / act_scale`` times the weight levels, exact accumulate, then
    ``acc * act_scale * ws``."""
    from repro_torch.core.quant import quantize_weight, true_div
    codes = torch.clamp(torch.round(true_div(x.float(), act_scale)), 0,
                        spec.a_qmax)
    wq, ws = quantize_weight(w, spec)
    acc = conv_taps_int(codes, wq, w.shape[0], 1,
                        _stride1_pads(w.shape[0], padding))
    return acc * act_scale * ws.reshape(1, 1, 1, -1)


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
