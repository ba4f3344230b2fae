"""Pipeline parallelism (GPipe schedule) over a mesh dim.

The reference package's ``distributed/pipeline.py`` on
``torch.distributed``: the stacked layer params [L, ...] are split into S
contiguous stages, one per rank along the stage dim; activations flow
stage to stage while M microbatches fill the pipe (GPipe: M + S - 1 ticks,
bubble fraction (S-1)/(M+S-1)).

At tick t stage s runs microbatch t - s when that index is live: stage 0
takes it from the input, the others from what the previous stage sent at
tick t - 1; the last stage banks its output. The reference's
``collective_permute`` becomes one ``batch_isend_irecv`` a tick between
neighbouring stages, and only where the sender's microbatch is live (its
ppermute also moves the masked zeros of idle stages; skipping them sends
the same live values). At the end the last stage broadcasts its bank
(the reference's psum of the masked bank).

``body_fn`` is ``(one layer's params, h) -> h``, so any of the
framework's layer bodies can ride the pipe. Forward only, as the
reference's tests use it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.nn.module import tree_leaves, tree_map

Tree = Any


def pipeline_forward(layer_params: Tree, x: torch.Tensor,
                     body_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
                     mesh, stage_axis: str,
                     n_microbatches: int) -> torch.Tensor:
    """Run ``body_fn`` over stacked layers with GPipe staging.

    layer_params: tree of full [L, ...] tensors (the same on every rank;
                  each stage keeps its L/S layers), L % S == 0
    x:            [B, T, D] (the same on every rank), B % n_microbatches == 0
    Returns [B, T, D] on every rank: the sequential loop's result up to the
    reordering of reductions between microbatch shapes.
    """
    import torch.distributed as dist
    group = mesh.get_group(stage_axis)
    n_stages = dist.get_world_size(group)
    sid = dist.get_rank(group)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches}")
    l_total = tree_leaves(layer_params)[0].shape[0]
    if l_total % n_stages:
        raise ValueError(f"{l_total} layers do not split into {n_stages}")
    per = l_total // n_stages
    local = tree_map(lambda p: p[sid * per:(sid + 1) * per], layer_params)
    xm = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    prev = dist.get_global_rank(group, sid - 1) if sid > 0 else None
    nxt = dist.get_global_rank(group, sid + 1) \
        if sid < n_stages - 1 else None
    last = dist.get_global_rank(group, n_stages - 1)

    def live(stage, t):
        return 0 <= t - stage < n_microbatches

    def run_local(h):
        for i in range(per):
            h = body_fn(tree_map(lambda p: p[i], local), h)
        return h

    buf = torch.zeros_like(xm[0])
    acc = torch.zeros_like(xm)
    for t in range(n_microbatches + n_stages - 1):
        ops = []
        h_out = None
        if live(sid, t):
            h_out = run_local(xm[t] if sid == 0 else buf)
            if nxt is None:
                acc[t - sid] = h_out
            else:
                ops.append(dist.P2POp(dist.isend, h_out.contiguous(), nxt,
                                      group))
        recv = None
        if prev is not None and live(sid - 1, t):
            recv = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, recv, prev, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is not None:
            buf = recv
    dist.broadcast(acc, src=last, group=group)
    return acc.reshape(x.shape)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
