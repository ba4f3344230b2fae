"""Edge shapes of the launch configurations of ``photonic_mvm`` and the dense
strip conv, and an operand copy that defeats aligned loads.

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


def odd_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past an
    allocation, so no 16-byte (or 8-, 4-byte) copy of it is aligned."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = base[1:].view(t.shape)
    out.copy_(t)
    return out
