"""The multi-rank checks of the distributed path, one function a check, each
run on every rank of a world (``distributed.world.run_world``) and
returning plain numbers.

* ``train_check``: ``make_train_step`` on DTensor params placed by the
  rules (TP+DP, or FSDP with ``fsdp=True``) against the unsharded step on
  the same seeded params and batches: the loss of each step (relative
  error), ``loss_and_grads``'s gradients (each leaf's max error over its
  largest |entry|), and whether the new params keep their placements;
* ``remat_check``: ``cfg.remat="full"`` recomputes every layer once in
  the backward of the sharded loss as of the unsharded one (the ``obs``
  counter ``remat.recompute``), with gradients bitwise those of
  ``remat="none"`` on the same DTensors;
* ``moe_check``: the MoE block's expert-parallel branch against its
  fallback: expert indices, slots, dropped fraction, ``y`` and the
  gradients;
* ``compression_check``: ``compressed_allreduce_update`` against the mean
  of every rank's dequantized leaves computed in one process;
* ``pipeline_check``: GPipe's ``pipeline_forward`` against the sequential
  loop over the layers;
* ``elastic_save`` / ``elastic_restore``: a checkpoint saved from one
  world restored by ``elastic_remesh`` on another, and the data
  pipeline's rank slices of the global batch.

``device_type`` is ``"cpu"`` or ``"cuda"`` (every rank on ``cuda:0``, so the
checks need only one card). The smoke configs run in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import smoke_variant
from repro_torch.data.synthetic import SyntheticTextConfig, synthetic_lm_batch
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shardings as sh
from repro_torch.nn.module import tree_flatten_with_paths, tree_map

MESH_DIMS = ("data", "model")


def _device(device_type: str) -> torch.device:
    return torch.device("cuda", 0) if device_type == "cuda" else \
        torch.device("cpu")


def smoke_cfg(arch: str, fsdp: bool = False):
    return dataclasses.replace(smoke_variant(arch), dtype="float32",
                               fsdp=fsdp)


def _batch(cfg, step, batch, seq, device):
    b = synthetic_lm_batch(SyntheticTextConfig(vocab=cfg.vocab, seq=seq,
                                               batch=batch, seed=0), step)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _rel_leaf_err(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero)."""
    scale = want.abs().max().item() or 1.0
    return (got - want).abs().max().item() / scale


def train_check(rank: int, world: int, arch: str,
                mesh_shape: Tuple[int, int], fsdp: bool = False,
                steps: int = 2, batch: int = 4, seq: int = 16,
                device_type: str = "cpu", overrides=None) -> Dict:
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    device = _device(device_type)
    cfg = dataclasses.replace(smoke_cfg(arch, fsdp), **(overrides or {}))
    mesh = mesh_mod.make_mesh(mesh_shape, MESH_DIMS, device_type)
    rules = sh.build_rules(cfg, mesh)
    params = lm.init_lm(0, cfg, device=device)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    place = sh.tree_shardings(params, cfg, mesh, rules)
    dparams = sh.place_tree(params, mesh, place)
    dopt = sh.distribute_tree(opt, cfg, mesh, rules)

    def placed(b):
        return sh.place_tree(b, mesh, sh.batch_shardings(b, cfg, mesh,
                                                         rules))

    b0 = _batch(cfg, 0, batch, seq, device)
    loss, _, grads = loss_and_grads(params, b0, cfg)
    with sharding.use_rules(mesh, rules), sharding.plain_operands():
        dloss, _, dgrads = loss_and_grads(dparams, placed(b0), cfg)
    grad_err = {p: _rel_leaf_err(sharding.full_tensor(g), dict(
        tree_flatten_with_paths(grads))[p])
        for p, g in tree_flatten_with_paths(dgrads)}
    full = sharding.full_tensor
    out = {"grad_loss_rel": abs(full(dloss).item() - loss.item())
           / abs(loss.item()),
           "grad_err": max(grad_err.values()),
           "grad_err_leaf": max(grad_err, key=grad_err.get)}

    step = make_train_step(cfg, opt_cfg, seq)
    dstep = make_train_step(cfg, opt_cfg, seq, grad_shardings=place)
    losses, dlosses = [], []
    for i in range(steps):
        b = _batch(cfg, i, batch, seq, device)
        params, opt, m = step(params, opt, b)
        with sharding.use_rules(mesh, rules):
            dparams, dopt, dm = dstep(dparams, dopt, placed(b))
        losses.append(m["loss"].item())
        dlosses.append(dm["loss"].item())
    out["losses"], out["sharded_losses"] = losses, dlosses
    out["loss_rel"] = max(abs(a - b) / abs(a) for a, b in zip(losses,
                                                              dlosses))
    out["param_err"] = max(_rel_leaf_err(full(d), p) for (_, d), (_, p) in
                           zip(tree_flatten_with_paths(dparams),
                               tree_flatten_with_paths(params)))
    out["placements_kept"] = all(
        tuple(d.placements) == tuple(place_leaf)
        for (_, d), (_, place_leaf) in zip(
            tree_flatten_with_paths(dparams),
            tree_flatten_with_paths(_placement_tree(place))))
    out["sharded_leaves"] = sum(
        any(p.is_shard() for p in d.placements)
        for _, d in tree_flatten_with_paths(dparams))
    return out


def remat_check(rank: int, world: int, arch: str,
                mesh_shape: Tuple[int, int], batch: int = 4, seq: int = 16,
                device_type: str = "cpu") -> Dict:
    from repro_torch import obs
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import lm
    device = _device(device_type)
    cfg = smoke_cfg(arch)
    mesh = mesh_mod.make_mesh(mesh_shape, MESH_DIMS, device_type)
    rules = sh.build_rules(cfg, mesh)
    params = lm.init_lm(0, cfg, device=device)
    dparams = sh.place_tree(params, mesh, sh.tree_shardings(params, cfg,
                                                            mesh, rules))
    b = _batch(cfg, 0, batch, seq, device)
    db = sh.place_tree(b, mesh, sh.batch_shardings(b, cfg, mesh, rules))
    recomputes = obs.counter("remat.recompute")

    def grads(remat, sharded):
        c = dataclasses.replace(cfg, remat=remat)
        before = recomputes.get()
        if not sharded:
            return loss_and_grads(params, b, c)[2], recomputes.get() - before
        with sharding.use_rules(mesh, rules), sharding.plain_operands():
            g = loss_and_grads(dparams, db, c)[2]
        return g, recomputes.get() - before

    g_full, n_sharded = grads("full", True)
    g_none, n_none = grads("none", True)
    _, n_unsharded = grads("full", False)
    full = sharding.full_tensor
    return {"layers": cfg.n_layers, "recomputes_sharded": n_sharded,
            "recomputes_unsharded": n_unsharded,
            "recomputes_remat_none": n_none,
            "bitwise_remat_none": all(
                torch.equal(full(a), full(c)) for (_, a), (_, c) in zip(
                    tree_flatten_with_paths(g_full),
                    tree_flatten_with_paths(g_none)))}


def driver_check(rank: int, world: int, ckpt_dir: str,
                 mesh: str = "1x2", steps: int = 3) -> Dict:
    """``launch/train.py`` on this world's process group (``--mesh``):
    its losses against the driver's single-device run on rank 0 (made
    before the world's; the same seed and batches)."""
    import os
    import torch.distributed as dist
    from repro_torch.launch import train
    argv = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--steps", str(steps), "--seq", "16", "--batch", "4",
            "--ckpt-every", "2"]
    run = train.train(argv + ["--mesh", mesh, "--ckpt-dir",
                              os.path.join(ckpt_dir, "sharded")])
    leaves = [x for _, x in tree_flatten_with_paths(run.state["params"])]
    return {"losses": run.losses, "first_step": run.first_step,
            "dtensors": all(sharding.is_dtensor(x) for x in leaves),
            "sharded": sum(any(p.is_shard() for p in x.placements)
                           for x in leaves),
            "world": dist.get_world_size()}


def _placement_tree(place):
    """A placements tree with each leaf wrapped, so that the tree walk
    stops at it (lists are not walked as trees)."""
    if isinstance(place, dict):
        return {k: _placement_tree(v) for k, v in place.items()}
    return tuple(place)


def moe_check(rank: int, world: int, arch: str, mesh_shape: Tuple[int, int],
              fsdp: bool = False, ffn_parallel: bool = False,
              capacity: int = 3, batch: int = 4, seq: int = 16,
              device_type: str = "cpu") -> Dict:
    from torch.distributed.tensor import Shard
    from repro_torch.nn import moe
    device = _device(device_type)
    cfg = smoke_cfg(arch, fsdp)
    mcfg = moe.MoEConfig(cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff,
                         cfg.capacity_factor)
    mesh = mesh_mod.make_mesh(mesh_shape, MESH_DIMS, device_type)
    rules = sh.build_rules(cfg, mesh)
    if ffn_parallel:          # the fallback with its FFN dim over "model"
        rules.update(experts=None, moe_ffn=("model",))
    g = torch.Generator().manual_seed(0)
    params = {k: v.to(device) for k, v in moe.init_moe(g, mcfg,
                                                       device="cpu").items()}
    x = torch.randn(batch, seq, cfg.d_model, generator=g).to(device)
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xr = x.clone().requires_grad_(True)
    ref = moe.moe_ffn_grouped(live, xr, mcfg, capacity=capacity)
    ref.y.square().sum().backward()
    # the params' placements as the LM's stacked leaves get them, minus
    # the layer dim
    stacked = sh.tree_shardings({"layers": {"moe": {k: v[None] for k, v in
                                                    params.items()}}},
                                cfg, mesh, rules)["layers"]["moe"]
    dparams = {k: sharding.distribute(
        v, mesh, [Shard(p.dim - 1) if p.is_shard() else p
                  for p in stacked[k]]).requires_grad_(True)
        for k, v in params.items()}
    dx = sharding.distribute(x, mesh, sharding.placements(
        ("data", None, None), mesh))
    dx.requires_grad_(True)
    with sharding.use_rules(mesh, rules), sharding.plain_operands():
        out = moe.moe_ffn_grouped(dparams, dx, mcfg, capacity=capacity)
        out.y.square().sum().backward()
        _, top_i, slots, *_ = moe.route_rows(dparams["router"], dx,
                                             cfg.n_experts, cfg.top_k,
                                             capacity)
    _, _, ref_i = moe._route(x.float() @ params["router"], cfg.top_k)
    ref_i = ref_i.reshape(batch, -1)
    ref_slots = moe._slots(ref_i.reshape(batch, -1), cfg.n_experts,
                           capacity)
    return {
        "expert_parallel": bool(rules.get("experts")),
        "ffn_parallel": bool(rules.get("moe_ffn")),
        "indices_equal": bool(torch.equal(sharding.full_tensor(top_i), ref_i)),
        "slots_equal": bool(torch.equal(sharding.full_tensor(slots),
                                        ref_slots)),
        "dropped": (sharding.full_tensor(out.dropped_fraction).item(),
                    ref.dropped_fraction.item()),
        "balance_rel": abs(sharding.full_tensor(out.balance_loss).item()
                           - ref.balance_loss.item())
        / abs(ref.balance_loss.item()),
        "y_err": (sharding.full_tensor(out.y) - ref.y).abs().max().item(),
        "y_max": ref.y.abs().max().item(),
        "x_grad_err": _rel_leaf_err(sharding.full_tensor(dx.grad), xr.grad),
        "w_grad_err": max(_rel_leaf_err(sharding.full_tensor(dparams[k].grad),
                                        live[k].grad) for k in params),
    }


def _grad_leaves(seed: int, device) -> Dict[str, torch.Tensor]:
    """Random leaves of ragged sizes (a block of 256, one past it, a
    matrix), as one rank's gradients."""
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(256, generator=g).to(device),
            "b": {"c": torch.randn(257, generator=g).to(device) * 1e-3},
            "d": torch.randn(33, 17, generator=g).to(device)}


def compression_check(rank: int, world: int, steps: int = 2,
                      device_type: str = "cpu") -> Dict:
    from repro_torch.core.quant import true_div
    from repro_torch.optim import compression as comp
    device = _device(device_type)
    err = comp.init_error_state(_grad_leaves(0, device))
    errs = [comp.init_error_state(_grad_leaves(0, device))
            for _ in range(world)]
    bitwise, err_bitwise = True, True
    for step in range(steps):
        grads = [_grad_leaves(1000 * step + r, device) for r in range(world)]
        avg, err = comp.compressed_allreduce_update(grads[rank], err)
        # every rank's dequantized leaves and new errors, in one process
        deqs, new_errs = [], []
        for r in range(world):
            def one(gl, el):
                c, s = comp.compress_int8(gl.float() + el)
                d = comp.decompress_int8(c, s, gl.shape)
                return d, gl.float() + el - d
            pair = tree_map(one, grads[r], errs[r])
            deqs.append(tree_map(lambda p: p[0], pair))
            new_errs.append(tree_map(lambda p: p[1], pair))
        errs = new_errs
        total = deqs[0]
        for d in deqs[1:]:
            total = tree_map(torch.add, total, d)
        want = tree_map(lambda t: true_div(t, world), total)
        for (_, a), (_, b) in zip(tree_flatten_with_paths(avg),
                                  tree_flatten_with_paths(want)):
            bitwise &= bool(torch.equal(a, b))
        for (_, a), (_, b) in zip(tree_flatten_with_paths(err),
                                  tree_flatten_with_paths(errs[rank])):
            err_bitwise &= bool(torch.equal(a, b))
    return {"bitwise": bitwise, "error_bitwise": err_bitwise,
            "device": str(device)}


def pod_check(rank: int, world: int, device_type: str = "cpu") -> Dict:
    """``collectives.pod_psum`` over a (world, 1, 1) mesh's "pod" dim: a
    plain leaf and a DTensor leaf's local shard summed over the pods."""
    from torch.distributed.tensor import Shard
    from repro_torch.distributed.collectives import pod_psum
    device = _device(device_type)
    mesh = mesh_mod.make_mesh((world, 1, 1), ("pod", "data", "model"),
                              device_type)
    plain = torch.full((3,), float(rank + 1), device=device)
    full = torch.arange(4 * world, dtype=torch.float32, device=device)
    dt = sharding.distribute(full, mesh, [Shard(0), Shard(0), Shard(0)])
    out = pod_psum({"plain": plain, "dt": dt}, mesh)
    want = sum(range(1, world + 1))
    local = out["dt"].to_local()
    expect = sum(full[4 * r:4 * r + 4] for r in range(world))
    return {"plain": bool(torch.all(out["plain"] == want)),
            "dtensor": bool(torch.equal(local, expect)),
            "placements": tuple(out["dt"].placements) == tuple(dt.placements)}


def debug_mesh_check(rank: int, world: int,
                     device_type: str = "cpu") -> Dict:
    """``launch.mesh.make_debug_mesh`` over this world: its shape and
    dims."""
    mesh = mesh_mod.make_debug_mesh(device_type=device_type)
    return {"shape": tuple(mesh.shape), "dims": tuple(mesh.mesh_dim_names)}


def pipeline_layers(n_layers: int = 8, d: int = 16, seed: int = 0):
    """Numpy weights of a stack of ``tanh(h @ w + b)`` layers and an
    input [8, 4, d]."""
    rng = np.random.default_rng(seed)
    return ({"w": (rng.standard_normal((n_layers, d, d)) / np.sqrt(d))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal((n_layers, d)))
             .astype(np.float32)},
            rng.standard_normal((8, 4, d)).astype(np.float32))


def pipeline_body(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def pipeline_check(rank: int, world: int,
                   microbatches: Sequence[int] = (4, 8),
                   device_type: str = "cpu") -> Dict:
    from repro_torch.distributed.pipeline import pipeline_forward
    device = _device(device_type)
    layers_np, x_np = pipeline_layers()
    layers = {k: torch.from_numpy(v).to(device) for k, v in
              layers_np.items()}
    x = torch.from_numpy(x_np).to(device)
    mesh = mesh_mod.make_mesh((world,), ("stage",), device_type)
    h = x
    for i in range(layers["w"].shape[0]):
        h = pipeline_body({k: v[i] for k, v in layers.items()}, h)
    out = {"sequential": h.cpu().numpy()}
    for m in microbatches:
        y = pipeline_forward(layers, x, pipeline_body, mesh, "stage", m)
        out[m] = y.cpu().numpy()
        out[f"err_{m}"] = float((y - h).abs().max())
    return out


def _elastic_state(arch: str, device):
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = smoke_cfg(arch)
    params = lm.init_lm(0, cfg, device=device)
    return cfg, params, adamw_init(params, AdamWConfig())


def elastic_save(rank: int, world: int, ckpt_dir: str, arch: str,
                 mesh_shape: Tuple[int, int], step: int = 7,
                 device_type: str = "cpu") -> Dict:
    from repro_torch.checkpoint.ckpt import save_checkpoint
    device = _device(device_type)
    cfg, params, opt = _elastic_state(arch, device)
    mesh = mesh_mod.make_mesh(mesh_shape, MESH_DIMS, device_type)
    rules = sh.build_rules(cfg, mesh)
    tree = {"params": sh.distribute_tree(params, cfg, mesh, rules),
            "opt": sh.distribute_tree(opt, cfg, mesh, rules)}
    save_checkpoint(ckpt_dir, step, tree)
    return {"saved": step}


def elastic_restore(rank: int, world: int, ckpt_dir: str, arch: str,
                    mesh_shape: Tuple[int, int],
                    device_type: str = "cpu") -> Dict:
    """``elastic_remesh`` onto ``mesh_shape``: every leaf gathered whole is
    bitwise the seeded state, and lands with the rules' placements; then
    the data pipeline's DTensor batches."""
    from repro_torch.distributed.elastic import elastic_remesh
    from repro_torch.launch.specs import as_meta
    device = _device(device_type)
    cfg, params, opt = _elastic_state(arch, device)
    mesh = mesh_mod.make_mesh(mesh_shape, MESH_DIMS, device_type)
    rules = sh.build_rules(cfg, mesh)
    step, rparams, ropt = elastic_remesh(ckpt_dir, cfg, mesh,
                                         as_meta(params), as_meta(opt))
    bitwise = True
    for tree, want in ((rparams, params), (ropt, opt)):
        for (_, got), (_, w) in zip(tree_flatten_with_paths(tree),
                                    tree_flatten_with_paths(want)):
            bitwise &= bool(torch.equal(sharding.full_tensor(got).to(w.device),
                                        w))
    place = _placement_tree(sh.tree_shardings(params, cfg, mesh, rules))
    placed = all(tuple(g.placements) == p for (_, g), (_, p) in zip(
        tree_flatten_with_paths(rparams), tree_flatten_with_paths(place)))
    return {"step": step, "bitwise": bitwise, "placements": placed,
            "data": data_slices(mesh, cfg, rules, device)}


def data_slices(mesh, cfg, rules, device, batch: int = 8, seq: int = 16,
                steps: int = 2) -> Dict:
    """``DataPipeline`` with the batch placements: each rank uploads its
    rows, and the ranks' rows (gathered) are the global batch."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataPipeline
    text = SyntheticTextConfig(vocab=cfg.vocab, seq=seq, batch=batch,
                               seed=0)
    want = synthetic_lm_batch(text, 0)
    place = sh.batch_shardings({k: torch.from_numpy(v) for k, v in
                                want.items()}, cfg, mesh, rules)
    pipe = DataPipeline(lambda s: synthetic_lm_batch(text, s),
                        device=device, mesh=mesh, placements=place)
    equal, local_rows = True, []
    try:
        for _ in range(steps):
            step, got = pipe.next()
            want = synthetic_lm_batch(text, step)
            for k, v in got.items():
                local = v.to_local()
                parts = [torch.empty_like(local)
                         for _ in range(dist.get_world_size())]
                dist.all_gather(parts, local.contiguous())
                # the data ranks' rows in rank order (model ranks repeat)
                data_rows = torch.cat(
                    [parts[r] for r in _data_ranks(mesh)], dim=0)
                equal &= np.array_equal(data_rows.cpu().numpy(), want[k])
                equal &= np.array_equal(sharding.full_tensor(v).cpu().numpy(),
                                        want[k])
                local_rows.append(local.shape[0])
    finally:
        pipe.stop()
    return {"equal": equal, "local_rows": local_rows}


def _data_ranks(mesh) -> List[int]:
    """The global ranks at model coordinate 0, in data order."""
    ranks = mesh.mesh.reshape(mesh.size(0), -1)
    return [int(r) for r in ranks[:, 0]]


def suite(rank: int, world: int, items: Sequence[Tuple[str, str, tuple,
                                                        dict]]) -> Dict:
    """Several checks in one world (one process-group start-up):
    ``items`` are (name, check function's name, args, kwargs); -> {name:
    result}."""
    return {name: globals()[fn](rank, world, *args, **kwargs)
            for name, fn, args, kwargs in items}
