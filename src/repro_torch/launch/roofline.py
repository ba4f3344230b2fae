"""Roofline per (arch x shape x mesh), over the dry run's records.

The reference package's ``launch/roofline.py``, function for function.
Three terms, in seconds a step:

    compute    = FLOPs / (chips * PEAK_FLOPS_BF16)
    memory     = HBM bytes / (chips * HBM_BW)
    collective = collective bytes a rank / NVLINK_BW

with ``launch/mesh.py``'s constants of one H100: the bf16 GEMM rate and
the HBM rate as measured on the card, NVLink's rate from the data sheet
(where the reference divides by a TPU's ICI link). Collectives over
"data" and "pod" cross the slower fabric between 8-GPU nodes, so there the
collective term is a lower bound.

Sources:
  * FLOPs: analytic, ``models.lm.model_flops`` (6*N_active*D for train,
    2*N_active*D + attention for inference): what MFU is measured
    against. The dry run's counted FLOPs (``FlopCounterMode`` over the
    step as it runs, the global step's) are kept beside them as
    ``counted_flops_global``;
  * HBM bytes: analytic traffic (params, optimizer state, activation
    residuals under remat, KV caches), the reference's model;
  * collective bytes: the dry run's per-rank result bytes
    (``launch.comm_analysis``; eager, so already weighted by the layers'
    trip count), all-reduce counted twice (a ring is a reduce-scatter and
    an all-gather);
  * memory a rank: the dry run's ``memory`` record (temp and arguments).

A cell with no usable dry-run record keeps the arithmetic (its collective
term 0) and says so (``dryrun``: ``"absent"`` or the record's status).

Usage:
    python -m repro_torch.launch.roofline [--dryrun-dir build/dryrun]
        [--out build/roofline.md] [--json-out build/roofline.json]
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.specs import SHAPES, ShapeCell, cell_status
from repro_torch.models.lm import active_params, count_params, model_flops

BUILD = DEFAULT_OUT.parent
MESHES = ("32x8", "2x32x8")


def cell_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """``analytic_flops`` of a config and a shape cell of one's own."""
    if cell.kind == "train":
        return model_flops(cfg, cell.seq, cell.global_batch, train=True)
    if cell.kind == "prefill":
        return model_flops(cfg, cell.seq, cell.global_batch, train=False)
    return model_flops(cfg, cell.seq, cell.global_batch, train=False,
                       decode=True)


def analytic_flops(arch: str, shape: str) -> float:
    return cell_flops(get_config(arch), SHAPES[shape])


def _param_bytes(cfg: ModelConfig, dtype_bytes=2) -> int:
    return count_params(cfg) * dtype_bytes


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    total = 0
    if cfg.family in ("dense", "moe", "encoder", "vlm", "hybrid"):
        s = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
        total += (cfg.n_layers * batch * s * cfg.n_kv_heads * cfg.head_dim
                  * 2 * 2)                               # k+v, bf16
    if cfg.family in ("ssm", "hybrid"):
        total += cfg.n_layers * batch * cfg.ssm_heads * cfg.ssm_head_dim \
            * cfg.ssm_state * 4                          # f32 state
        total += cfg.n_layers * batch * (cfg.conv_kernel - 1) * cfg.conv_dim * 2
    return total


def cell_hbm_bytes(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Per-step global HBM traffic of a config and a shape cell (see the
    module docstring)."""
    p_total = _param_bytes(cfg)                          # bf16
    n_params = count_params(cfg)
    d = cfg.d_model
    if cell.kind == "train":
        toks = cell.global_batch * cell.seq
        # params: fwd read + bwd(dgrad) read + bwd(wgrad) read
        traffic = 3 * p_total
        # grads f32 write+read, AdamW: mu,nu,master read+write (f32)
        traffic += n_params * (4 + 4) + n_params * 6 * 4
        traffic += p_total                               # new params write
        # activation residuals (remat=full): store+reread layer inputs,
        # recompute writes ~= 3x (B,T,D) bf16 per layer
        traffic += 3 * cfg.n_layers * toks * d * 2
        return float(traffic)
    if cell.kind == "prefill":
        toks = cell.global_batch * cell.seq
        traffic = p_total + 8 * cfg.n_layers * toks * d * 2
        return float(traffic)
    # decode: weight-streaming dominates; MoE reads only routed experts'
    # weights (top_k of n_experts) amortized over the batch, capped by total
    if cfg.family == "moe":
        frac = min(1.0, cell.global_batch * cfg.top_k / cfg.n_experts)
        expert_b = (count_params(cfg) - active_params(cfg)) \
            / max(cfg.n_experts - cfg.top_k, 1) * cfg.n_experts * 2
        nonexpert_b = p_total - expert_b
        traffic = nonexpert_b + expert_b * frac
    else:
        traffic = p_total
    traffic += _cache_bytes(cfg, cell.global_batch, cell.seq)  # read cache
    return float(traffic)


def analytic_hbm_bytes(arch: str, shape: str) -> float:
    return cell_hbm_bytes(get_config(arch), SHAPES[shape])


def terms(flops: float, hbm: float, coll_bytes: float, chips: int) -> Dict:
    """The three terms in seconds, the dominant one and the compute
    term's share of the bound."""
    t = {"compute": flops / (chips * PEAK_FLOPS_BF16),
         "memory": hbm / (chips * HBM_BW),
         "collective": coll_bytes / NVLINK_BW}   # already a rank's bytes
    bound = max(t.values())
    return {"t_compute_s": t["compute"], "t_memory_s": t["memory"],
            "t_collective_s": t["collective"],
            "dominant": max(t, key=t.get),
            "roofline_fraction": t["compute"] / bound if bound else 0.0}


def collective_bytes(rec: Dict) -> int:
    """A dry-run record's collective bytes a rank, all-reduce twice (a
    ring moves its payload out and back)."""
    b = rec.get("collectives", {}).get("bytes", {})
    return b.get("total", 0) + b.get("all-reduce", 0)


def roofline_terms(arch: str, shape: str, mesh: str,
                   dryrun_dir: Path) -> Dict:
    cfg = get_config(arch)
    skip = cell_status(arch, shape, cfg)
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": skip}
    rec_path = Path(dryrun_dir) / f"{arch}__{shape}__{mesh}.json"
    rec = json.loads(rec_path.read_text()) if rec_path.exists() else {}
    dry = rec.get("status", "absent")
    if dry != "ok":
        rec = {}
    chips = math.prod(int(n) for n in mesh.split("x"))   # 32x8 -> 256
    flops = analytic_flops(arch, shape)
    hbm = analytic_hbm_bytes(arch, shape)
    coll = collective_bytes(rec)
    cell = SHAPES[shape]
    mem = rec.get("memory", {})
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
        "dryrun": dry, "chips": chips,
        "flops_global": flops,
        "hbm_bytes_global": hbm,
        "collective_bytes_per_dev": coll,
        **terms(flops, hbm, coll, chips),
        "model_flops_6nd": 6.0 * active_params(cfg) * cell.global_batch
        * (cell.seq if cell.kind != "decode" else 1),
        "counted_flops_global": rec.get("flops"),
        "memory_per_dev_gib": mem.get("temp_size_bytes", 0) / 2**30,
        "args_per_dev_gib": mem.get("argument_size_bytes", 0) / 2**30,
    }


def build_table(dryrun_dir: Path, meshes=MESHES) -> str:
    lines = ["| arch | shape | mesh | compute s | memory s | collective s "
             "| dominant | roofline frac | note |",
             "|---|---|---|---|---|---|---|---|---|"]
    for arch in list_configs():
        for shape in SHAPES:
            for mesh in meshes:
                r = roofline_terms(arch, shape, mesh, dryrun_dir)
                if r["status"] != "ok":
                    if mesh == meshes[0]:
                        lines.append(f"| {arch} | {shape} | - | - | - | - | "
                                     f"- | - | {r['status']} |")
                    continue
                note = ("" if r["dryrun"] == "ok" else
                        f"no dry-run record ({r['dryrun']}): collective 0")
                lines.append(
                    f"| {arch} | {shape} | {mesh} | {r['t_compute_s']:.3g} "
                    f"| {r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} "
                    f"| **{r['dominant']}** "
                    f"| {r['roofline_fraction']:.2f} | {note} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun-dir", default=str(DEFAULT_OUT))
    ap.add_argument("--out", default=str(BUILD / "roofline.md"))
    ap.add_argument("--json-out", default=str(BUILD / "roofline.json"))
    args = ap.parse_args(argv)
    dd = Path(args.dryrun_dir)
    table = build_table(dd)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(table + "\n")
    recs = [roofline_terms(arch, shape, mesh, dd)
            for arch in list_configs() for shape in SHAPES
            for mesh in MESHES]
    Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json_out).write_text(json.dumps(recs, indent=1))
    print(table)


if __name__ == "__main__":
    main()
