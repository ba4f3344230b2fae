"""Elastic scaling: resume the same logical job on a different mesh.

The reference package's ``distributed/elastic.py`` on DTensor. Protocol:
  1. checkpoints are mesh-agnostic (whole arrays + manifest, written by
     rank 0 after a gather: ``checkpoint/ckpt.py``);
  2. on restart with another world size, rebuild the mesh and rules with
     ``launch.shardings`` and ``restore_checkpoint(..., mesh=,
     placements=)``: each rank keeps its slice of every leaf;
  3. the data pipeline is a pure function of the step, so the global batch
     is the same however many ranks slice it (``data/pipeline.py``).

``elastic_remesh`` is the one-call wrapper: given a checkpoint directory, a
config and a new mesh it returns (step, params, opt_state) placed for that
mesh.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

from repro_torch.checkpoint.ckpt import latest_step, restore_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as sh


def elastic_remesh(ckpt_dir: str | Path, cfg: ModelConfig, mesh,
                   params_target, opt_target=None,
                   step: Optional[int] = None) -> Tuple:
    """Restore a checkpoint onto ``mesh`` (any shape and world size).
    ``params_target`` / ``opt_target`` give structure, shapes and dtypes
    (meta tensors will do)."""
    rules = sh.build_rules(cfg, mesh)
    target = {"params": params_target}
    place = {"params": sh.tree_shardings(params_target, cfg, mesh, rules)}
    if opt_target is not None:
        target["opt"] = opt_target
        place["opt"] = sh.tree_shardings(opt_target, cfg, mesh, rules)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    restored = restore_checkpoint(ckpt_dir, target, step, mesh=mesh,
                                  placements=place)
    return step, restored["params"], restored.get("opt")
