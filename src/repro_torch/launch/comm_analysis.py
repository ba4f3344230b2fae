"""Collective counts and bytes of a step, as it runs.

The counterpart of the reference package's ``launch/hlo_analysis.py``.
The reference parses the compiled HLO, where a scanned layer body appears
once, and weights each collective by its while loop's trip count. Eager
PyTorch has no HLO: it runs the layer loop L times, so the collectives
seen while a step runs are already weighted by the trip count, and no
parsing is needed.

``CollectiveCounter`` is ``torch.distributed.tensor.debug.CommDebugMode``
(its ``get_comm_counts()`` gives the counts) plus a tally of each
collective's result bytes on this rank (the reference's per-device
post-partitioning shape bytes). ``record()`` returns the reference's
record shape, ``{"bytes": {kind: ..., "total": ...}, "counts": {...}}``,
over its five kinds. ``all-reduce`` is reported at its shape's bytes; the
ring factor of 2 belongs to the roofline, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# op name (``OpOverloadPacket.__name__`` of c10d's functional and in-place
# collectives) -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


def kind_of(func) -> str | None:
    """The reference's kind of a dispatched op (an ``OpOverload``), or
    None for a non-collective."""
    ns, _, name = func._overloadpacket._qualified_op_name.partition("::")
    return _KINDS.get(name) if ns in ("_c10d_functional", "c10d") else None


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's result bytes by
    the reference's kind."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
        self.counts: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = kind_of(func)
        if kind is not None:
            self.counts[kind] += 1
            self.bytes[kind] += _nbytes(out)
        return out

    def record(self) -> Dict:
        """-> {"bytes": {kind, "total"}, "counts": {kind, "total"},
        "comm_debug_counts": CommDebugMode's own counts by op}."""
        b = dict(self.bytes, total=sum(self.bytes.values()))
        c = dict(self.counts, total=sum(self.counts.values()))
        return {"bytes": b, "counts": c,
                "comm_debug_counts": {str(k): v for k, v in
                                      self.get_comm_counts().items()}}
