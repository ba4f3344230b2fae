"""The LM training driver: an LM family trained on the planted-bigram
stream, with checkpoint/restart, a straggler monitor and failure drills.

    # smollm-360m at its published width and depth, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --steps 30

    # its smoke variant on the CPU, a failure drill, then the restart
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 20 --device cpu --ckpt-dir ckpt --fail-at 12
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 20 --device cpu --ckpt-dir ckpt

The reference's ``launch/train.py``, flag for flag (``--arch --smoke
--steps --batch --seq --lr --quant --ckpt-dir --ckpt-every --fail-at
--seed``) plus ``--device`` (default ``cuda``; it raises when there is no
GPU). The same wiring: ``init_lm`` from a generator seeded ``--seed``,
``adamw_init`` at ``AdamWConfig(lr=--lr)``, ``steps.make_train_step``,
batches from ``synthetic_lm_batch`` (``modality_batch`` for the audio and
vision frontends), ``CheckpointManager(keep=2)``, ``StragglerMonitor``,
``RestartableLoop`` and ``FailureInjector``. ``--quant w4a4|w3a4|w2a4``
trains through the [W:A] fake-quant of ``nn.layers.dense`` (STE). A
checkpoint in ``--ckpt-dir`` is resumed (the default directory is
``repro_torch_ckpt`` under the system's temporary directory, as the
reference keeps one under ``/tmp``). Prints the reference's ``[train]``
lines; ``main`` returns the losses.

Distributed (the reference's "mesh execution when >1 device is present"):

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch smollm-360m --smoke --device cpu --mesh 1x2

Under ``torchrun`` (``WORLD_SIZE`` in the environment) the driver joins the
process group (``nccl`` on the card, each rank on ``cuda:<LOCAL_RANK>``;
``gloo`` with ``--device cpu``), and whenever a process group is
initialized (by ``torchrun`` or by the caller) it trains on the
``--mesh DxM`` ("data" x "model", D*M = the world size) DeviceMesh: rules
from ``launch.shardings.build_rules``, params and optimizer state placed
by ``distribute_tree``, each rank uploading its slice of every global
batch, the step under ``use_rules`` with ``grad_shardings``, checkpoints
gathered and written by rank 0 (and restored onto the same layout), and
the ``[train]`` lines printed by rank 0. Without a process group the
mesh must be 1x1 and the path is the single-device one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import ModelConfig, get_config, smoke_variant
from repro_torch.core.program import resolve_device
from repro_torch.data.synthetic import (SyntheticTextConfig, modality_batch,
                                        synthetic_lm_batch)
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     RestartableLoop,
                                                     StragglerMonitor)
from repro_torch.distributed.sharding import distribute, use_rules
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as lm_mod
from repro_torch.optim.adamw import AdamWConfig, adamw_init


@dataclasses.dataclass
class TrainRun:
    """What a run did: the losses and metrics of the steps it took (from
    ``first_step`` to ``last_step``), the final state ``{"params",
    "opt"}``, its wall seconds, each step's ms (CUDA events on the card,
    the host clock on the CPU), the step and batch functions it ran, and
    its DeviceMesh (None on the single-device path)."""
    cfg: ModelConfig
    losses: List[float]
    history: List[Dict[str, torch.Tensor]]
    state: Dict
    first_step: int
    last_step: int
    seconds: float
    step_ms: List[float]
    train_step: Callable
    batch_fn: Callable
    mesh: Any = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quant", default="none",
                    choices=["none", "w4a4", "w3a4", "w2a4"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (drill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: the data x model DeviceMesh (D*M ranks)")
    return ap.parse_args(argv)


def join_process_group(device_arg: str) -> None:
    """Under ``torchrun`` (``WORLD_SIZE`` set), join its process group:
    ``nccl`` for the card, ``gloo`` for ``--device cpu``."""
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return
    cuda = torch.device(device_arg).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")


def parse_mesh(text: str):
    d, m = (int(v) for v in text.lower().split("x"))
    return d, m


def train(argv=None) -> TrainRun:
    """Parse ``argv`` and run; the injected failure propagates."""
    import torch.distributed as dist
    args = parse_args(argv)
    join_process_group(args.device)
    mesh_shape = parse_mesh(args.mesh)
    mesh = rules = None
    rank = 0
    device = resolve_device(args.device)
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        if mesh_shape[0] * mesh_shape[1] != dist.get_world_size():
            raise ValueError(f"--mesh {args.mesh} has "
                             f"{mesh_shape[0] * mesh_shape[1]} ranks; the "
                             f"world has {dist.get_world_size()}")
        mesh = make_mesh(mesh_shape, ("data", "model"), device.type)
    elif mesh_shape != (1, 1):
        raise ValueError(f"--mesh {args.mesh} needs a process group: run "
                         f"under torchrun --nproc-per-node "
                         f"{mesh_shape[0] * mesh_shape[1]}")
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = smoke_variant(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, quant_scheme=args.quant,
                              max_seq=max(cfg.max_seq, args.seq))
    say(f"[train] arch={cfg.name} quant={cfg.quant_scheme} "
        f"params~{lm_mod.count_params(cfg)/1e6:.1f}M"
        + (f" mesh={args.mesh}" if mesh is not None else ""))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm_mod.init_lm(gen, cfg, device=device)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params, opt_cfg)
    train_step = make_train_step(cfg, opt_cfg, args.seq)
    if mesh is not None:
        rules = sh.build_rules(cfg, mesh)
        place = sh.tree_shardings(params, cfg, mesh, rules)
        params = sh.place_tree(params, mesh, place)
        opt_state = sh.distribute_tree(opt_state, cfg, mesh, rules)
        sharded_step = make_train_step(cfg, opt_cfg, args.seq,
                                       grad_shardings=place)

        def train_step(params, opt_state, batch):
            with use_rules(mesh, rules):
                return sharded_step(params, opt_state, batch)
    text_cfg = SyntheticTextConfig(vocab=cfg.vocab, seq=args.seq,
                                   batch=args.batch, seed=args.seed)

    def batch_fn(step: int):
        if cfg.frontend == "none":
            b = synthetic_lm_batch(text_cfg, step)   # planted structure
        else:
            b = modality_batch(cfg, args.batch, args.seq,
                               seed=args.seed * 1_000_003 + step)
        if mesh is not None:                     # this rank's slice
            return {k: distribute(v, mesh, sh.batch_spec_placements(
                v, mesh, rules), device) for k, v in b.items()}
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    cuda = device.type == "cuda"
    marks = []

    def loop_step(state, batch):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        else:
            t = time.perf_counter()
        params, opt_state, metrics = train_step(state["params"],
                                                state["opt"], batch)
        if cuda:
            end.record()
            marks.append((start, end))
        else:
            marks.append((time.perf_counter() - t) * 1e3)
        return {"params": params, "opt": opt_state}, metrics

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt")
    ckpt = CheckpointManager(ckpt_dir, keep=2,
                             save_interval_steps=args.ckpt_every)
    monitor = StragglerMonitor(
        on_straggler=lambda ev: say(f"[straggler] step {ev.step}: "
                                    f"{ev.ratio:.1f}x EWMA"))
    loop = RestartableLoop(loop_step, batch_fn, ckpt,
                           injector=FailureInjector(args.fail_at),
                           monitor=monitor)

    init = [{"params": params, "opt": opt_state}]
    del params, opt_state
    t0 = time.time()
    # the loop holds the only reference to the state, so each step's
    # inputs are freed once its outputs replace them (the reference
    # donates them); a reference kept here would hold the initial state
    # for the whole run
    state, last_step, history = loop.run(init.pop(), 0, args.steps)
    losses = [float(m["loss"]) for m in history]     # waits for the card
    dt = time.time() - t0
    step_ms = ([a.elapsed_time(z) for a, z in marks] if cuda else marks)
    say(f"[train] {last_step} steps in {dt:.1f}s "
        f"({dt/max(len(history),1)*1e3:.0f} ms/step)")
    if losses:
        say(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(min {min(losses):.4f})")
    return TrainRun(cfg, losses, history, state, last_step - len(history),
                    last_step, dt, step_ms, train_step, batch_fn, mesh)


def main(argv: Optional[List[str]] = None) -> List[float]:
    return train(argv).losses


if __name__ == "__main__":
    main()
