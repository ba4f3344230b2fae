"""The port's device kernels, their wrappers and plain versions.

``launch_counts()`` reads, and ``reset_launch_counts()`` zeroes, the count
of kernel launches each wrapper has made (a wrapper counts only where it
launches its CUDA kernel, never for a plain run on the CPU).

A CUDA graph launches its kernels without calling the wrappers, so a graph
is captured inside ``recording_launches()``, which collects what the
wrappers recorded into it (they count nothing then), and every replay
hands that tally to ``credit_launches``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from repro_torch.kernels import _build


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


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Within the block, the calling thread's wrappers record launches into
    the yielded dict instead of counting them (a graph capture: the kernels
    are recorded, not launched)."""
    if getattr(_build._capturing, "tally", None) is not None:
        raise RuntimeError("recording_launches() does not nest")
    tally: Dict[str, int] = {}
    _build._capturing.tally = tally
    try:
        yield tally
    finally:
        _build._capturing.tally = None


def credit_launches(tally: Dict[str, int]) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``tally``."""
    for c in _counters():
        if tally.get(c.name):
            c.add(tally[c.name])
