"""Hillclimbing harness: run a cell under a named variant, report the
three roofline terms, log hypothesis -> change -> before/after.

The reference package's ``launch/hillclimb.py``. Where the reference
lowers and compiles the cell's step for 512 placeholder devices, a
variant here runs the step once on a fake process group of the mesh's
size, through ``launch.dryrun.run_step`` (fake tensors, nothing
allocated): its collectives and memory a rank are what the dry run
records, and the terms divide by ``launch/mesh.py``'s constants of one
H100 (``launch.roofline``). There is no compile to time: a record keeps
the run's wall time as ``step_wall_s``.

    python -m repro_torch.launch.hillclimb --cell yi-decode --variant serve_tp
    python -m repro_torch.launch.hillclimb --cell kimi-train --all-variants

Variants change ONE lever each (sharding rules, dispatch algorithm,
carrier dtypes) so deltas are attributable; results go to
``<out>/<cell>.json`` (default ``build/hillclimb``), one record a variant,
replaced when the variant runs again. A hypothesis states the expected
direction; what the port's run shows is in ``PERF.md``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant as Q
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.roofline import (BUILD, _cache_bytes, cell_flops,
                                         cell_hbm_bytes, collective_bytes,
                                         terms)
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import active_params, count_params

QUANT = {"w4a4": Q.W4A4, "w3a4": Q.W3A4, "w2a4": Q.W2A4}


@dataclasses.dataclass
class Variant:
    name: str
    hypothesis: str
    cfg_patch: Dict = dataclasses.field(default_factory=dict)
    rules_patch: Dict = dataclasses.field(default_factory=dict)
    quant_serving: Optional[str] = None      # "w4a4" etc -> wq/ws params
    cache_dtype: Optional[str] = None        # e.g. "float8_e4m3fn"
    # analytic memory-term adjustments (bytes factors vs baseline model)
    param_bytes: float = 2.0                 # bytes per weight read
    cache_elem_bytes: float = 2.0


def run_variant(arch: str, shape: str, v: Variant, multi_pod: bool = False,
                mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]
                = None, cfg: Optional[ModelConfig] = None) -> Dict:
    """The cell's step under ``v``, once on a fake group of the production
    mesh (or ``mesh_shape``: (sizes, names)) -> its dry-run record. The
    rules are ``build_rules(cfg, mesh)`` (the training rules, FSDP at
    inference too) with ``v.rules_patch`` over them; ``quant_serving``
    places ``quantize_lm_params``' ``wq`` / ``ws`` leaves, ``cache_dtype``
    narrows the decode cache's bfloat16 leaves. ``cfg``: the config
    ``v.cfg_patch`` applies to (default ``get_config(arch)``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = dataclasses.replace(cfg or get_config(arch), **v.cfg_patch)
    cell = specs_mod.SHAPES[shape]
    sizes, names = mesh_shape or mesh_mod.production_shape(multi_pod)
    dryrun.fake_world(math.prod(sizes))
    mesh = mesh_mod.make_mesh(sizes, names, device_type="cpu")
    rules = sh.build_rules(cfg, mesh)
    rules.update(v.rules_patch)
    cache_dtype = getattr(torch, v.cache_dtype) if v.cache_dtype else None
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = lm_mod.init_lm(0, cfg, device="cpu")
        if v.quant_serving:
            params = lm_mod.quantize_lm_params(params, cfg,
                                               QUANT[v.quant_serving])
        return dryrun.run_step(cfg, cell, mesh, rules, params=params,
                               cache_dtype=cache_dtype)


def measure(arch: str, shape: str, v: Variant, multi_pod: bool = False,
            mesh_shape=None, cfg: Optional[ModelConfig] = None) -> Dict:
    """``v``'s record: the three roofline terms (the analytic FLOPs and
    HBM bytes, the run's collectives), memory a rank and the run's wall
    time. ``mesh_shape`` / ``cfg`` as ``run_variant``'s."""
    chips = math.prod((mesh_shape or mesh_mod.production_shape(multi_pod))[0])
    t0 = time.time()
    rec = run_variant(arch, shape, v, multi_pod, mesh_shape, cfg)
    wall = time.time() - t0
    coll = collective_bytes(rec)              # ring AR ~ 2x payload
    base = cfg or get_config(arch)
    flops = cell_flops(base, specs_mod.SHAPES[shape])
    hbm = cell_hbm_bytes(base, specs_mod.SHAPES[shape])
    if v.param_bytes != 2.0 or v.cache_elem_bytes != 2.0:
        hbm = analytic_hbm_bytes_adjusted(arch, shape, v, cfg)
    mem = rec["memory"]
    return {
        "arch": arch, "shape": shape, "variant": v.name,
        "hypothesis": v.hypothesis, **terms(flops, hbm, coll, chips),
        "collective_bytes_per_dev": int(coll),
        "collectives": rec["collectives"]["bytes"],
        "temp_gib_per_dev": mem["temp_size_bytes"] / 2**30,
        "args_gib_per_dev": mem["argument_size_bytes"] / 2**30,
        "bytes_per_rank": rec["bytes_per_rank"],
        "step_wall_s": round(wall, 1),
    }


def analytic_hbm_bytes_adjusted(arch: str, shape: str, v: Variant,
                                cfg: Optional[ModelConfig] = None) -> float:
    """Re-derive the decode memory model with variant carrier widths."""
    cfg = dataclasses.replace(cfg or get_config(arch), **v.cfg_patch)
    cell = specs_mod.SHAPES[shape]
    if cell.kind != "decode":
        return cell_hbm_bytes(cfg, cell)
    if cfg.family == "moe":
        frac = min(1.0, cell.global_batch * cfg.top_k / cfg.n_experts)
        expert_n = (count_params(cfg) - active_params(cfg)) \
            / max(cfg.n_experts - cfg.top_k, 1) * cfg.n_experts
        nonexpert_n = count_params(cfg) - expert_n
        traffic = (nonexpert_n + expert_n * frac) * v.param_bytes
    else:
        traffic = count_params(cfg) * v.param_bytes
    traffic += _cache_bytes(cfg, cell.global_batch, cell.seq) \
        * (v.cache_elem_bytes / 2.0)
    return float(traffic)


# ---------------------------------------------------------------------------
# Experiment registry — one cell per hillclimb target
# ---------------------------------------------------------------------------

CELLS = {
    "yi-decode": ("yi-34b", "decode_32k"),
    "kimi-train": ("kimi-k2-1t-a32b", "train_4k"),
    "grok-train": ("grok-1-314b", "train_4k"),
}

_SERVE_TP = {"embed": None, "expert_embed": None}

VARIANTS: Dict[str, list] = {
    "yi-decode": [
        Variant("base", "baseline: the training rules (FSDP: params split "
                "over data) at inference"),
        Variant("serve_tp",
                "FSDP re-gathers every layer's params over data for each "
                "decoded token. Pure-TP serving rules (params replicated "
                "over data) remove those all-gathers: the collective term "
                "should fall to the level of the attention's partial sums",
                rules_patch=dict(_SERVE_TP)),
        Variant("serve_tp_w4",
                "int4 MR carriers (the paper's storage) cut the param bytes "
                "4x: the memory term falls by three quarters of the params' "
                "share of the step's bytes. At batch 128 x 32k the KV cache "
                "outweighs the params, so the move should be small: weight "
                "quantization is the lever for small-batch decode",
                rules_patch=dict(_SERVE_TP),
                quant_serving="w4a4", param_bytes=0.5),
        Variant("serve_tp_kv8",
                "narrow the dominant stream instead: an f8 KV cache (the "
                "CRC 4-bit-activation idea applied to cache storage) halves "
                "the cache's bytes: the memory term should fall by half the "
                "cache's share",
                rules_patch=dict(_SERVE_TP),
                cache_dtype="float8_e4m3fn", cache_elem_bytes=1.0),
        Variant("serve_tp_kv8_w4",
                "stack both narrow carriers: the memory term to half the "
                "cache's bytes plus a quarter of the params'; the "
                "collective term (the TP layers' all-reduces) should then "
                "come closer to the memory term",
                rules_patch=dict(_SERVE_TP),
                quant_serving="w4a4", param_bytes=0.5,
                cache_dtype="float8_e4m3fn", cache_elem_bytes=1.0),
    ],
    "kimi-train": [
        Variant("base", "baseline: the registered config (its moe_dispatch "
                "is grouped)"),
        Variant("grouped",
                "a sorted dispatch fills its [E*C, d] buffer by a scatter "
                "across the whole batch, which crosses the data dim; "
                "group-local dispatch scatters within each batch row, so "
                "that traffic leaves the collective term and the combine's "
                "gather over model remains. The registered config already "
                "dispatches grouped: this variant should equal base",
                cfg_patch={"moe_dispatch": "grouped"}),
        Variant("grouped_cf1",
                "capacity_factor 1.25 -> 1.0 cuts the dispatch buffer and "
                "the combine's payload by a fifth, with the same drop rule",
                cfg_patch={"moe_dispatch": "grouped",
                           "capacity_factor": 1.0}),
        Variant("grouped_f8",
                "the combine payload in f8 (CRC-style narrow carriers "
                "across the wire) halves what the remaining gather moves",
                cfg_patch={"moe_dispatch": "grouped",
                           "capacity_factor": 1.0,
                           "moe_combine_dtype": "float8_e4m3fn"}),
    ],
    "grok-train": [
        Variant("base", "baseline: the registered config (its moe_dispatch "
                "is grouped)"),
        Variant("grouped",
                "as kimi-k2's grouped variant: equal to base, the registered "
                "config dispatching grouped already. On the 32x8 mesh "
                "grok-1's 8 experts are expert-parallel over model = 8, as "
                "kimi-k2's are, not split along their FFN dim",
                cfg_patch={"moe_dispatch": "grouped"}),
        Variant("grouped_cf1_f8",
                "stack capacity 1.0 + f8 combine on top",
                cfg_patch={"moe_dispatch": "grouped",
                           "capacity_factor": 1.0,
                           "moe_combine_dtype": "float8_e4m3fn"}),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all-variants", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default=str(BUILD / "hillclimb"))
    args = ap.parse_args(argv)

    arch, shape = CELLS[args.cell]
    variants = VARIANTS[args.cell]
    if args.variant:
        variants = [v for v in variants if v.name == args.variant]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / f"{args.cell}.json"
    log = json.loads(log_path.read_text()) if log_path.exists() else []

    for v in variants:
        rec = measure(arch, shape, v, args.multipod)
        log = [r for r in log if r["variant"] != v.name] + [rec]
        log_path.write_text(json.dumps(log, indent=1))
        print(f"[{args.cell}/{v.name}] compute={rec['t_compute_s']:.4g}s "
              f"memory={rec['t_memory_s']:.4g}s "
              f"collective={rec['t_collective_s']:.4g}s "
              f"dominant={rec['dominant']} "
              f"frac={rec['roofline_fraction']:.3f} "
              f"(step {rec['step_wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
