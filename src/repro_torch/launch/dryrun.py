"""Production-mesh dry run: one step of every (arch x shape x mesh) cell on a
fake process group.

The reference package's ``launch/dryrun.py`` on ``torch.distributed``. The
reference lowers and compiles each cell's step over 512 placeholder host
devices. Here the step runs once, eagerly, on a ``fake`` process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``) under
``FakeTensorMode``: the params, optimizer state, batch and cache are fake
DTensors placed by ``launch.shardings`` on the production mesh
(``launch.mesh``), so no device is touched and nothing is allocated. This
process is rank 0 of the fake group; every rank would hold the same bytes.

Each cell records:
  * ``bytes_per_rank``: params, optimizer state and gradients (the
    params' placements; the KV cache for decode), counted from the specs,
    and ``state_fits``: their sum within one H100's memory
    (``launch.mesh.HBM_PER_CHIP``);
  * ``memory``: the counterpart of the reference's
    ``compiled.memory_analysis()``, per rank (``StorageTracker``):
    ``argument_size_bytes`` (the local shards of the step's inputs),
    ``output_size_bytes`` (of its outputs), ``temp_size_bytes`` (the peak
    of the storage the step allocates while it runs) and ``peak_bytes``
    (arguments plus temp). Eager PyTorch donates no buffer and generates
    no code: the reference's ``alias_size_bytes`` and
    ``generated_code_size_bytes`` have no counterpart and are left out;
  * ``flops``: ``FlopCounterMode``'s count over the step. It sees the ops
    DTensor dispatches with their global shapes, so the count is the
    global step's (``flops_scope: "global"``; divide by the ranks for a
    rank's share of an evenly split step);
  * ``collectives``: ``launch.comm_analysis`` (per-rank result bytes and
    counts by kind, weighted by the layers' trip count as they run);
  * ``wall_s`` and ``status`` (a cell that fails records its error and
    traceback, as the reference's does).

Usage:
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multipod] [--out DIR]
  python -m repro_torch.launch.dryrun --arch smollm-360m --smoke   # narrow

Results land in ``<out>/<arch>__<shape>__<mesh>.json`` (default ``out``:
``build/dryrun``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.comm_analysis import CollectiveCounter
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import lm as lm_mod
from repro_torch.nn.module import tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# DTensor's sharding propagation runs each op once more on fake tensors of
# the op's global shapes, under the fake mode that is active: the dry
# run's own. Those tensors are no rank's storage.
_PROPAGATION = "torch.distributed.tensor._sharding_prop"
_WAIT = torch.ops._c10d_functional.wait_tensor.default


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of
    ``world_size`` ranks (replacing a fake group of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "dry run needs a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    # DTensor's native sharding-propagation cache keys a mesh by its shape
    # and dim names, not by its process groups: an entry an earlier world
    # left hands back that world's mesh, whose groups are destroyed
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()


def _fake_like(meta_tree):
    """Zeros of each meta tensor's shape and dtype (fake under the mode)."""
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype), meta_tree)


def _storages(tree) -> Dict[int, int]:
    """The storages of ``tree``'s tensors (a DTensor's local shard) -> the
    bytes those tensors take of them: a shard may be a view of the whole
    tensor's storage, and holds only its own bytes of it."""
    views = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x._local_tensor if isinstance(x, DTensor) else x
            views[(x.untyped_storage()._cdata, x.storage_offset(),
                   x.numel())] = x.numel() * x.element_size()
    out: Dict[int, int] = {}
    for (key, _, _), n in views.items():
        out[key] = out.get(key, 0) + n
    return out


def _in_propagation(frame) -> bool:
    """Whether ``frame`` or a caller of it runs DTensor's propagator."""
    while frame is not None:
        if frame.f_globals.get("__name__") == _PROPAGATION:
            return True
        frame = frame.f_back
    return False


class StorageTracker(TorchDispatchMode):
    """The bytes one rank holds while a step runs, on real tensors or on
    the dry run's fake ones alike.

    It sits below DTensor's dispatch (it declines DTensor ops, so it sees
    the local ops DTensor runs on the shards) and adds each new storage an
    op returns once, dropping it when the storage is freed (a
    ``weakref.finalize`` on the storage, whose Python object lives as long
    as the storage does). ``peak`` is the most storage live at once
    beyond the arguments' (``args``, registered first: a view of an
    argument allocates nothing). Ops of DTensor's sharding propagation,
    which run at the global shapes, and tensors of any other fake mode are
    not counted. Under a fake mode ``wait_tensor`` returns its input, as
    it does eagerly (its meta kernel makes a new tensor).
    """

    def __init__(self, args):
        super().__init__()
        self._mode = active_fake_mode()
        self._args = _storages(args)
        self._live: Dict[int, int] = {}
        self.live = self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is _WAIT and self._mode is not None:
            return args[0]
        out = func(*args, **(kwargs or {}))
        if (active_fake_mode() is self._mode
                and not _in_propagation(sys._getframe(1))):
            for x in tree_leaves(out):
                if isinstance(x, torch.Tensor):
                    st = x.untyped_storage()
                    key = st._cdata
                    if key not in self._live and key not in self._args:
                        self._live[key] = st.nbytes()
                        self.live += self._live[key]
                        self.peak = max(self.peak, self.live)
                        weakref.finalize(st, self._free, key)
        return out

    def record(self, outputs) -> Dict[str, int]:
        """The reference's ``memory`` record of the step that returned
        ``outputs``."""
        args = sum(self._args.values())
        return {"argument_size_bytes": args,
                "output_size_bytes": sum(_storages(outputs).values()),
                "temp_size_bytes": self.peak,
                "peak_bytes": args + self.peak}


def _mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(s) for s in shape)


def run_step(cfg: ModelConfig, cell: specs_mod.ShapeCell, mesh,
             rules: Dict, params=None, cache_dtype=None) -> Dict:
    """Place the state on ``mesh`` and run ``cell``'s step once under the
    collective, FLOP and storage counters. -> the cell's numbers.

    ``params``: the param tree to place (default ``init_lm(0, cfg)``; a
    ``quantize_lm_params`` tree places its ``wq`` / ``ws`` leaves by their
    rules); ``cache_dtype``: the decode cache's bfloat16 leaves cast to it.
    Fake under ``FakeTensorMode`` (the dry run), real otherwise. The
    optimizer state is made from the whole params and placed by its rules,
    as ``launch/train.py`` does."""
    from torch.utils.flop_counter import FlopCounterMode
    if params is None:
        params = lm_mod.init_lm(0, cfg, device="cpu")
    p_place = sh.tree_shardings(params, cfg, mesh, rules)
    p_specs = sh.tree_specs(params, cfg, mesh, rules)
    inputs = _fake_like(specs_mod.input_specs(cfg, cell))
    rec: Dict = {"bytes_per_rank": {
        "params": sh.per_rank_bytes(params, p_specs, mesh)}}
    dparams = sh.place_tree(params, mesh, p_place)
    if cell.kind == "train":
        opt_cfg = AdamWConfig()
        opt = adamw_init(params, opt_cfg)
        rec["bytes_per_rank"]["optimizer"] = sh.per_rank_bytes(
            opt, sh.tree_specs(opt, cfg, mesh, rules), mesh)
        rec["bytes_per_rank"]["gradients"] = rec["bytes_per_rank"]["params"]
        opt = sh.distribute_tree(opt, cfg, mesh, rules)
        batch = sh.place_tree(inputs, mesh, sh.batch_shardings(
            inputs, cfg, mesh, rules))
        step = make_train_step(cfg, opt_cfg, cell.seq, grad_shardings=p_place)
        args = (dparams, opt, batch)
    elif cell.kind == "prefill":
        batch = sh.place_tree(inputs, mesh, sh.batch_shardings(
            inputs, cfg, mesh, rules))
        step = make_prefill_step(cfg)
        args = (dparams, batch)
    else:
        cache = inputs["cache"]
        if cache_dtype is not None:
            cache = tree_map(lambda x: x.to(cache_dtype)
                             if x.dtype == torch.bfloat16 else x, cache)
        rec["bytes_per_rank"]["cache"] = sh.per_rank_bytes(
            cache, sh.cache_specs(cache, mesh, rules), mesh)
        cache = sh.place_tree(cache, mesh, sh.cache_shardings(
            cache, cfg, mesh, rules))
        token = sh.place_tree({"token": inputs["token"]}, mesh,
                              sh.batch_shardings({"token": inputs["token"]},
                                                 cfg, mesh, rules))["token"]
        step = make_serve_step(cfg)
        args = (dparams, cache, token)
    del params, inputs
    counter, flops = CollectiveCounter(), FlopCounterMode(display=False)
    memory = StorageTracker(args)
    with use_rules(mesh, rules), memory, counter, flops:
        out = step(*args)
    rec["memory"] = memory.record(out)
    del out
    rec["hbm_per_chip"] = mesh_mod.HBM_PER_CHIP
    rec["state_fits"] = sum(rec["bytes_per_rank"].values()) \
        <= mesh_mod.HBM_PER_CHIP
    rec["flops"] = int(flops.get_total_flops())
    rec["flops_scope"] = "global"
    rec["collectives"] = counter.record()
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             out_dir: Optional[Path] = None,
             mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]
             = None, cfg: Optional[ModelConfig] = None) -> Dict:
    """One cell: the production mesh (or ``mesh_shape``: (sizes, names))
    on a fake group of its size, ``cfg`` (default ``get_config(arch)``).
    Writes ``<out_dir>/<arch>__<shape>__<mesh>.json`` when ``out_dir``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes, names = mesh_shape or mesh_mod.production_shape(multi_pod)
    mesh_name = _mesh_name(sizes)
    t0 = time.time()
    rec: Dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "mesh_dims": list(names)}
    try:
        cfg = cfg or get_config(arch)
        cell = specs_mod.SHAPES[shape]
        skip = specs_mod.cell_status(arch, shape, cfg)
        if skip:
            rec["status"] = skip
        else:
            world = 1
            for s in sizes:
                world *= s
            fake_world(world)
            mesh = mesh_mod.make_mesh(sizes, names, device_type="cpu")
            rules = sh.build_rules(cfg, mesh, serve=(cell.kind == "decode"))
            rec["rules"] = {str(k): v for k, v in rules.items()}
            with FakeTensorMode(allow_non_fake_inputs=True):
                rec.update(run_step(cfg, cell, mesh, rules))
            rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failed cell is recorded
        rec["status"] = f"error: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-12000:]
    rec["wall_s"] = round(time.time() - t0, 3)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{arch}__{shape}__{mesh_name}.json"
        path.write_text(json.dumps(rec, indent=1, default=str))
    print(f"[dryrun] {arch} x {shape} x {mesh_name}: {rec['status']} "
          f"({rec['wall_s']}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(specs_mod.SHAPES) + [None])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke variant at the production mesh")
    ap.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = (list(specs_mod.SHAPES) if (args.all or not args.shape)
              else [args.shape])
    ok = skipped = failed = 0
    for arch in archs:
        for shape in shapes:
            cfg = smoke_variant(arch) if args.smoke else None
            s = run_cell(arch, shape, args.multipod, out_dir,
                         cfg=cfg)["status"]
            if s == "ok":
                ok += 1
            elif s.startswith("skip"):
                skipped += 1
            else:
                failed += 1
    print(f"[dryrun] done: {ok} ok, {skipped} skipped, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
