"""Fault-tolerant checkpoints of a tree of tensors, in the reference
package's on-disk protocol, so that a checkpoint written by either package
restores in the other.

* **atomicity** — a save goes to ``<dir>/tmp.<step>.<pid>/`` and is renamed
  to ``<dir>/step_<step:08d>/`` only after its fsync'd ``manifest.json``
  has landed: a crash mid-write never corrupts the latest complete
  checkpoint, and a stale ``tmp.*`` never counts as one.
* **layout** — every leaf in ``proc_0.npz`` (the one process's blob of
  the multi-host layout), named by its path of dict keys (list indices)
  joined with ``/`` and stored with ``__`` in its place; dict keys are
  walked in sorted order, as ``jax.tree_util`` flattens a dict. The
  manifest records each leaf's shape and its true dtype: bfloat16 (and
  any dtype numpy lacks) is stored as float32, which holds it exactly,
  so a restore is lossless.
* **restore** — into the structure and dtypes of a target tree (tensors,
  or ``device="meta"`` tensors for shape and dtype alone), onto ``device``
  (else each target leaf's own; the CPU for a meta leaf), or, given
  ``mesh=`` and a ``placements=`` tree (``launch.shardings.
  tree_shardings``), as DTensors on that mesh, each rank keeping its
  slice: the counterpart of the reference's ``shardings=`` (the elastic
  restart onto another mesh, ``distributed/elastic.py``).
* **under a mesh** — a tree holding DTensors is gathered whole on every
  rank (a collective: every rank saves) and rank 0 writes it; the layout
  on disk is the one-process layout, so a checkpoint of any mesh
  restores onto any other, and in either package.
* **keep-k GC** — old steps are pruned after a save, and stale ``tmp.*``
  directories of crashed writers removed.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, prefix: str = "", is_leaf=None
             ) -> Iterator[Tuple[str, Any]]:
    """``("a/b/0", leaf)`` for every leaf: dict keys sorted, sequences by
    index (``is_leaf`` stops the walk at a node of its own)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flatten(tree[k], join(k), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, join(i), is_leaf)
    else:
        yield prefix, tree


def _is_placements(node) -> bool:
    """A leaf of a placements tree: a list or tuple of placements."""
    from torch.distributed.tensor import Placement
    return isinstance(node, (list, tuple)) and all(
        isinstance(p, Placement) for p in node)


def _unflatten(target: Tree, leaves: Dict[str, Any], prefix: str = "") -> Tree:
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(target, Mapping):
        return {k: _unflatten(v, leaves, join(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(v, leaves, join(i))
                            for i, v in enumerate(target))
    return leaves[prefix]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def _whole(leaf):
    """A DTensor gathered whole (a collective), else the leaf."""
    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf -> (the numpy array stored, its true dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _dtype_name(t.dtype)
        try:
            arr = t.numpy()
        except TypeError:                  # bfloat16, float8: store float32
            arr = t.float().numpy()
        return arr, name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind not in "biufc":      # ml_dtypes (bf16/f8): store f32
        arr = arr.astype(np.float32)
    return arr, name


def save_checkpoint(directory: str | Path, step: int, tree: Tree,
                    extra: Optional[Dict] = None) -> Path:
    """Atomic save of a tree. Returns the final checkpoint path. Under a
    process group every rank calls it: DTensor leaves are gathered, rank
    0 writes, and the ranks meet at a barrier after the rename."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    leaves = [(name, _whole(leaf)) for name, leaf in _flatten(tree)]
    if _rank() != 0:
        _barrier()
        return final
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp.{step}.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": {}}
    for name, leaf in leaves:
        arr, stored_dtype = _to_host(leaf)
        arrays[name.replace("/", "__")] = arr
        manifest["leaves"][name] = {"shape": list(arr.shape),
                                    "dtype": stored_dtype}
    np.savez(tmp / "proc_0.npz", **arrays)
    mpath = tmp / "manifest.json"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic on POSIX
    _barrier()
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str | Path, target: Tree,
                       step: Optional[int] = None,
                       device=None, mesh=None,
                       placements: Optional[Tree] = None) -> Tree:
    """Restore into the structure and dtypes of ``target`` (a tree of
    tensors, meta tensors allowed), onto ``device`` or else each target
    leaf's device (the CPU for a meta tensor; a DTensor target leaf's
    mesh and placements). With ``mesh`` and
    ``placements`` (a tree of DTensor placements matching ``target``)
    each leaf lands as a DTensor on ``mesh``, this rank keeping its
    slice (on the mesh's device type when ``device`` is None)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import distribute
    place = dict(_flatten(placements, is_leaf=_is_placements)) \
        if placements is not None else None
    if place is not None and device is None:
        device = mesh.device_type if mesh.device_type != "cuda" else \
            torch.device("cuda", torch.cuda.current_device())
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    cdir = directory / f"step_{step:08d}"
    leaves = {}
    with np.load(cdir / "proc_0.npz") as data:
        for name, ref in _flatten(target):
            key = name.replace("/", "__")
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {tuple(ref.shape)}")
            dev = device if device is not None else (
                "cpu" if ref.device.type == "meta" else ref.device)
            # float32 -> bfloat16 rounds to nearest even: exact for a
            # value that was bfloat16
            leaf = torch.from_numpy(np.asarray(arr, order="C")).to(
                dtype=ref.dtype).to(dev)
            if place is not None:
                leaf = distribute(leaf, mesh, place[name])
            elif isinstance(ref, DTensor):       # onto the target's layout
                leaf = distribute(leaf, ref.device_mesh, ref.placements)
            leaves[name] = leaf
    return _unflatten(target, leaves)


class CheckpointManager:
    """keep-k manager with restart support + preemption-signal save hook."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 save_interval_steps: int = 100):
        self.directory = Path(directory)
        self.keep = keep
        self.save_interval_steps = save_interval_steps

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval_steps == 0

    def save(self, step: int, tree: Tree, extra: Optional[Dict] = None,
             force: bool = False) -> Optional[Path]:
        if not force and not self.should_save(step):
            return None
        path = save_checkpoint(self.directory, step, tree, extra)
        if _rank() == 0:
            self._gc()
        return path

    def restore_latest(self, target: Tree, device=None, mesh=None,
                       placements: Optional[Tree] = None):
        """-> (step, tree) of the latest complete checkpoint, or (None,
        None) when there is none."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, target, step, device,
                                        mesh, placements)

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith("step_"))
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for p in self.directory.glob("tmp.*"):
            shutil.rmtree(p, ignore_errors=True)
