"""Edge shapes of the launch configurations of ``photonic_mvm``, the strip
convs, the fused conv chain and ``ca_pool``, and an operand copy that
defeats aligned loads.

The ``gpu`` tests (``tests/test_torch_gpu.py``) and ``chip_smoke.py`` both
hold each kernel bitwise against its plain version at these shapes, so the
two check the same set.
"""

from __future__ import annotations

import torch

# (m, k, n, route, split-K) of photonic_mvm.ops.mvm_config: the skinny route,
# split-K on and off, every gemm tile, K 2/9/31/33/2304, M 1/8/129, N 1/4/100
MVM_EDGES = [(129, 2, 1, "skinny", False), (8, 9, 4, "skinny", False),
             (129, 31, 4, "skinny", False), (1, 9, 100, "gemm", False),
             (1, 33, 1, "gemm", True), (129, 33, 100, "gemm", True),
             (8, 2304, 100, "gemm", True), (129, 2304, 4, "gemm", True),
             (2048, 9, 64, "gemm", False), (8, 31, 100, "gemm", False),
             (33, 100, 257, "gemm", True), (33, 300, 257, "gemm", True),
             (33, 777, 129, "gemm", True)]

# (b, h_out, w_out, c_in, c_out, k, stride) of conv_bank.strip.strip_config:
# ragged tiles and runs (a 16-byte-aligned 1-channel row among them), k 7,
# k outside 3/5/7, stride 2, C_in over several chunks, ragged output-channel
# blocks, and every (co_b, run) the kernel is built for
STRIP_EDGES = [(8, 70, 100, 3, 20, 3, 1), (8, 200, 130, 2, 3, 5, 1),
               (8, 70, 100, 3, 3, 7, 1), (8, 170, 132, 1, 1, 5, 1),
               (8, 100, 130, 1, 1, 3, 1),
               (2, 37, 67, 1, 1, 5, 1), (1, 45, 98, 1, 1, 3, 1),
               (2, 33, 40, 3, 5, 7, 1), (1, 20, 21, 2, 3, 4, 1),
               (1, 17, 19, 3, 2, 9, 2), (2, 21, 23, 4, 6, 3, 2),
               (2, 30, 70, 40, 10, 5, 1), (1, 24, 24, 64, 33, 3, 1)]


# (b, h_out, w_out, c, k, stride) of conv_bank.strip.dw_config: 1, 3, 4, 5,
# 16 and 17 channels (whole-row and 4-channel blocks, ragged ones among
# them), k 3/5/7 at stride 1, k 4 and 9 and stride 2 (the generic
# instantiation), odd widths, and more tiles than CTAs (a CTA walks several,
# across channel blocks among them)
DW_EDGES = [(2, 37, 67, 1, 5, 1), (1, 45, 99, 1, 3, 1), (2, 33, 41, 3, 7, 1),
            (1, 20, 21, 3, 3, 1), (3, 17, 19, 4, 5, 1), (2, 30, 33, 5, 3, 1),
            (1, 24, 25, 16, 7, 1), (2, 19, 23, 17, 3, 2),
            (1, 17, 19, 3, 5, 2), (2, 21, 23, 4, 4, 1), (1, 9, 11, 1, 9, 2),
            (8, 70, 100, 3, 5, 1), (8, 100, 130, 17, 3, 1),
            (4, 90, 200, 3, 5, 2)]

# fused chains as (batch, h, w, c_in, [(c_out, k, stride, padding,
# depthwise, act, pool, bias)]) for conv_bank.fused.chain_config: LeNet's
# segment at batch 1, 3, 8 and 13 (clusters of 8, up to 104 CTAs); a
# 16-stage segment; a 3 x 3 avg pool (more window positions than a thread
# sums at once); reductions split over 16 and 32 lanes (depthwise and
# dense); frames that fill a CTA's shared memory, so the second stage's
# weights stay in device memory; and weights too large for any CTA beside
# the frames
_LENET = [(6, 5, 1, "SAME", False, "relu", ("avg", 2), True),
          (16, 5, 1, "VALID", False, "relu", ("avg", 2), True)]
_ACTS = ("relu", "abs", "sign", "none")
CHAIN_EDGES = [(b, 28, 28, 1, _LENET) for b in (1, 3, 8, 13)] + [
    (3, 10, 10, 2, [(4, 3, 1, "SAME", j % 2 == 1, _ACTS[j % 4],
                     ("max", 2) if j == 5 else None, j % 3 == 0)
                    for j in range(16)]),
    (3, 18, 18, 2, [(4, 3, 1, "SAME", False, "relu", ("avg", 3), True),
                    (4, 3, 1, "SAME", True, "abs", ("max", 3), False)]),
    (3, 4, 4, 8, [(8, 5, 1, "SAME", True, "relu", None, True),
                  (16, 5, 1, "SAME", False, "none", None, False)]),
    (2, 2, 2, 3, [(16, 5, 1, "SAME", False, "relu", None, True)]),
    (2, 85, 85, 4, [(4, 3, 1, "SAME", False, "relu", None, True),
                    (4, 3, 1, "SAME", False, "abs", None, True)]),
    (2, 12, 12, 16, [(128, 5, 1, "SAME", False, "relu", None, True),
                     (8, 3, 1, "SAME", False, "relu", ("max", 2), False)]),
]

# random fused chains (h, w, c_in, specs as above), each run at batch 3 and
# in the per-tensor batch-1 form (a 0-d incoming scale)
CHAINS = [
    (12, 12, 3, [(8, 3, 1, "SAME", False, "relu", ("max", 2), True),
                 (8, 3, 1, "SAME", True, "abs", None, False)]),
    (16, 16, 4, [(4, 3, 1, "SAME", True, "sign", ("avg", 2), True),
                 (6, 5, 1, "VALID", False, "none", None, True)]),
    (15, 15, 2, [(5, 3, 2, "SAME", False, "relu", None, False),
                 (7, 3, 1, "VALID", False, "abs", ("max", 2), True)]),
    (20, 20, 1, [(6, 5, 1, "SAME", False, "relu", ("avg", 2), True),
                 (6, 3, 1, "SAME", True, "relu", ("max", 2), True),
                 (10, 3, 1, "SAME", False, "sign", None, False)]),
]


# (b, h, w, c, p, gray, odd, route) of ca_pool.ops.ca_config: the served
# path shapes (imaging p = 1 and 2 at 8x256x256x3, VGG9's 8x32x32x3); every
# instantiated (p, C) of both modes on the vector route and on the scalar
# one (W/p not a multiple of R; rows whose byte length is not a multiple of
# 16; an input one float past an allocation, ``odd``); the generic route
# (C 2 and 4, p 3, gray p 1 at C 1); batch 1 and 8; a row of more runs than
# a CTA has threads (two CTAs along it); and more rows than one wave of
# CTAs (a grid-stride loop)
CA_EDGES = [(8, 256, 256, 3, 1, True, False, "vector"),
            (8, 256, 256, 3, 2, True, False, "vector"),
            (8, 32, 32, 3, 2, True, False, "vector"),
            (1, 32, 32, 3, 4, True, False, "vector"),
            (8, 32, 32, 1, 2, True, False, "vector"),
            (1, 16, 48, 1, 4, True, False, "vector"),
            (8, 32, 32, 3, 2, False, False, "vector"),
            (2, 16, 24, 3, 2, False, False, "vector"),
            (3, 16, 16, 1, 4, False, False, "vector"),
            (1, 20, 20, 3, 4, False, False, "vector"),
            (2, 16, 16, 1, 2, False, False, "vector"),
            (2, 8, 2600, 3, 2, True, False, "vector"),
            (16, 256, 512, 3, 1, True, False, "vector"),
            (8, 28, 28, 1, 2, True, False, "scalar"),
            (5, 28, 28, 1, 4, True, False, "scalar"),
            (2, 20, 20, 1, 2, True, False, "scalar"),
            (2, 30, 30, 3, 1, True, False, "scalar"),
            (1, 30, 30, 3, 2, True, False, "scalar"),
            (1, 18, 18, 3, 2, False, False, "scalar"),
            (4, 28, 28, 1, 2, False, False, "scalar"),
            (2, 20, 20, 1, 4, False, False, "scalar"),
            (8, 256, 256, 3, 1, True, True, "scalar"),
            (2, 32, 32, 3, 2, False, True, "scalar"),
            (1, 12, 12, 3, 4, True, True, "scalar"),
            (2, 12, 12, 4, 2, True, False, "generic"),
            (2, 12, 12, 4, 2, False, False, "generic"),
            (3, 18, 18, 3, 3, True, False, "generic"),
            (1, 9, 15, 2, 3, False, True, "generic"),
            (2, 16, 16, 1, 1, True, False, "generic")]


def chain_case(batch, h, w, c, specs, gen, device, levels=7):
    """Inputs of a fused chain from an edge list's spec: (codes [batch, h,
    w, c] 0..15, scale [batch, 1, 1, 1], stages ``(geom, wq int8, ws,
    bias)``), random from ``gen``; levels in -``levels``..``levels``."""
    from repro_torch.core.plan import padtype_to_pads
    from repro_torch.kernels.dispatch import ChainGeom
    stages, hh, ww, cc = [], h, w, c
    for j, (co, k, s, pad, dw, act, pool, bias) in enumerate(specs):
        co = cc if dw else co
        geom = ChainGeom(f"s{j}", hh, ww, cc, co, k, s,
                         padtype_to_pads((hh, ww), k, s, pad),
                         groups=cc if dw else 1, act=act, pool=pool)
        wq = torch.randint(-levels, levels + 1, (k, k, 1 if dw else cc, co),
                           generator=gen).to(torch.int8)
        ws = torch.rand((co,), generator=gen) * 0.1 + 0.01
        b = torch.randn((co,), generator=gen) * 0.1 if bias else None
        stages.append((geom, wq.to(device), ws.to(device),
                       None if b is None else b.to(device)))
        (hh, ww), cc = geom.out_hw(), co
    codes = torch.randint(0, 16, (batch, h, w, c), generator=gen).float()
    scale = torch.rand((batch, 1, 1, 1), generator=gen) + 0.01
    return codes.to(device), scale.to(device), stages


def odd_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past an
    allocation, so no 16-byte (or 8-, 4-byte) copy of it is aligned."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = base[1:].view(t.shape)
    out.copy_(t)
    return out
