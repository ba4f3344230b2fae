"""Collective helpers: gradient buckets, the pod all-reduce, and the
optimization barrier.

The reference package's ``distributed/collectives.py`` on
``torch.distributed``. The reference's GSPMD inserts collectives from
shardings; these helpers cover the places where explicit control matters:

  * ``bucket_leaves`` — greedy size-bucketing of a tree's leaves, so a
    staged all-reduce can start on the first bucket while the backward
    still produces the rest (the same buckets as the reference's: leaves
    in ``jax.tree.leaves`` order, dict keys sorted);
  * ``pod_psum`` — an all-reduce over the "pod" mesh dim's group only (the
    slow inter-node hop), used with ``optim.compression``;
  * ``with_optimization_barrier`` — the identity. ``jax.lax.optimization_
    barrier`` stops XLA from moving computation across a point of a
    compiled program; eager PyTorch runs each op where the code issues it
    and has no scheduler to hold back.
"""

from __future__ import annotations

from typing import Any, List

from repro_torch.nn.module import tree_flatten_with_paths, tree_map

Tree = Any


def bucket_leaves(tree: Tree, bucket_bytes: int = 32 * 2**20) -> List[List]:
    """Greedy size-bucketing of tree leaves for a staged all-reduce."""
    buckets, cur, cur_b = [], [], 0
    for _, leaf in tree_flatten_with_paths(tree):
        nb = leaf.numel() * leaf.element_size()
        if cur and cur_b + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(leaf)
        cur_b += nb
    if cur:
        buckets.append(cur)
    return buckets


def pod_psum(tree: Tree, mesh) -> Tree:
    """Sum every leaf over the mesh's "pod" dim: a plain tensor is summed
    whole, a ``DTensor``'s local shard is summed and keeps its
    placements (the reference's ``shard_map`` psum over local shards)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    group = mesh.get_group("pod")

    def one(x):
        local = (x.to_local() if isinstance(x, DTensor) else x).clone()
        dist.all_reduce(local, op=dist.ReduceOp.SUM, group=group)
        if not isinstance(x, DTensor):
            return local
        return DTensor.from_local(local, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return tree_map(one, tree)


def with_optimization_barrier(x: Tree) -> Tree:
    """The identity (see the module docstring)."""
    return x
