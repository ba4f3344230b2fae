"""repro_torch's hillclimb harness (``launch/hillclimb.py``) against the
reference's ``repro.launch.hillclimb``, on the CPU.

The reference module sets ``XLA_FLAGS`` (512 host devices) when imported,
so it is read in a subprocess of its own, never imported here:

* ``CELLS`` and every ``Variant`` field but ``hypothesis`` (restated
  without the reference's measurements) equal the reference's;
* ``analytic_hbm_bytes_adjusted`` equals the reference's for every
  variant of every cell;
* yi-34b's smoke variant (FSDP on, as the full config has it) runs
  ``base``, ``serve_tp`` and ``serve_tp_kv8`` through ``measure`` on a
  fake 4x4 group: each record has the reference's keys and the step's
  wall time, serve_tp holds more param bytes a rank than base (the params
  no longer split over "data"), and kv8's f8 cache takes half of
  serve_tp's bytes (its 4-byte position aside). The fake group is torn
  down after them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.configs import smoke_variant
from repro_torch.launch import hillclimb

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE_MESH = ((4, 4), ("data", "model"))
REFERENCE = """
import dataclasses, json
from repro.launch import hillclimb as H
print(json.dumps({
    "cells": H.CELLS,
    "variants": {c: [dataclasses.asdict(v) for v in vs]
                 for c, vs in H.VARIANTS.items()},
    "adjusted": {c: {v.name: H.analytic_hbm_bytes_adjusted(*H.CELLS[c], v)
                     for v in vs} for c, vs in H.VARIANTS.items()}}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("cell", list(hillclimb.CELLS))
def test_cells_and_variants_equal_the_reference_s(reference, cell):
    assert list(hillclimb.CELLS) == list(reference["cells"])
    assert list(hillclimb.CELLS[cell]) == reference["cells"][cell]
    got = [dataclasses.asdict(v) for v in hillclimb.VARIANTS[cell]]
    for g, w in zip(got, reference["variants"][cell], strict=True):
        assert g.pop("hypothesis") and w.pop("hypothesis")
        assert g == w, (cell, g["name"])


@pytest.mark.parametrize("cell", list(hillclimb.CELLS))
def test_adjusted_hbm_bytes_equal_the_reference_s(reference, cell):
    for v in hillclimb.VARIANTS[cell]:
        assert hillclimb.analytic_hbm_bytes_adjusted(
            *hillclimb.CELLS[cell], v) == \
            reference["adjusted"][cell][v.name], v.name


@pytest.fixture(scope="module")
def yi_smoke():
    """base, serve_tp and serve_tp_kv8 of yi-decode at smoke width on a
    fake 4x4 group; the group is destroyed after."""
    import torch.distributed as dist
    cfg = dataclasses.replace(smoke_variant("yi-34b"), fsdp=True)
    variants = {v.name: v for v in hillclimb.VARIANTS["yi-decode"]}
    try:
        yield {name: hillclimb.measure("yi-34b", "decode_32k",
                                       variants[name],
                                       mesh_shape=SMOKE_MESH, cfg=cfg)
               for name in ("base", "serve_tp", "serve_tp_kv8")}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_yi_decode_variants_measure_on_a_fake_group(yi_smoke):
    keys = {"arch", "shape", "variant", "hypothesis", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant", "roofline_fraction",
            "collective_bytes_per_dev", "collectives", "temp_gib_per_dev",
            "args_gib_per_dev", "step_wall_s"}
    for name, rec in yi_smoke.items():
        assert keys <= set(rec), name
        assert rec["variant"] == name
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["temp_gib_per_dev"] > 0 and rec["args_gib_per_dev"] > 0
        assert rec["collective_bytes_per_dev"] == \
            rec["collectives"]["total"] + rec["collectives"]["all-reduce"]
    base, tp, kv8 = (yi_smoke[n]["bytes_per_rank"]
                     for n in ("base", "serve_tp", "serve_tp_kv8"))
    assert tp["params"] > base["params"]
    assert tp["cache"] == 2 * (kv8["cache"] - 4) + 4
    assert yi_smoke["serve_tp_kv8"]["t_memory_s"] < \
        yi_smoke["serve_tp"]["t_memory_s"]


def test_a_new_fake_world_gets_none_of_the_last_world_s_meshes():
    """The dry run's smoke cells on a fake 4x4 world, the world destroyed,
    then a variant on a new 4x4 world: DTensor's native sharding cache,
    which keys meshes by shape and dim names, must not hand the first
    world's meshes (their groups destroyed) to the second
    (``dryrun.fake_world`` clears it)."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(smoke_variant("yi-34b"), fsdp=True)
    base = next(v for v in hillclimb.VARIANTS["yi-decode"]
                if v.name == "base")
    try:
        for arch, shape in (("smollm-360m", "train_4k"),
                            ("kimi-k2-1t-a32b", "decode_32k")):
            rec = dryrun.run_cell(arch, shape, mesh_shape=SMOKE_MESH,
                                  cfg=smoke_variant(arch))
            assert rec["status"] == "ok", rec["status"]
        dist.destroy_process_group()
        rec = hillclimb.measure("yi-34b", "decode_32k", base,
                                mesh_shape=SMOKE_MESH, cfg=cfg)
        assert rec["variant"] == "base" and rec["t_memory_s"] > 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
