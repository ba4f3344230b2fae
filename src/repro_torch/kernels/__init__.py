"""The port's device kernels, their wrappers and plain versions.

``launch_counts()`` reads, and ``reset_launch_counts()`` zeroes, the count
of kernel launches each wrapper has made (a wrapper counts only where it
launches its CUDA kernel, never for a plain run on the CPU).
"""

from __future__ import annotations

from typing import Dict


def _counters():
    from repro_torch.kernels.ca_pool.ops import LAUNCHES as ca
    from repro_torch.kernels.conv_bank.fused import LAUNCHES as chain
    from repro_torch.kernels.conv_bank.ops import LAUNCHES as bank
    from repro_torch.kernels.conv_bank.strip import DW_LAUNCHES as strip_dw
    from repro_torch.kernels.conv_bank.strip import LAUNCHES as strip
    from repro_torch.kernels.photonic_mvm.ops import LAUNCHES as mvm
    return (mvm, chain, ca, strip, strip_dw, bank)


def launch_counts() -> Dict[str, int]:
    return {c.name: c.value for c in _counters()}


def reset_launch_counts() -> None:
    for c in _counters():
        c.reset()
