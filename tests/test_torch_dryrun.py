"""repro_torch's dry-run tooling (``launch/specs.py``, ``launch/dryrun.py``,
``launch/comm_analysis.py``) on the CPU.

``SHAPES``, ``FULL_ATTENTION_ARCHS`` and ``cell_status`` equal the
reference's for every arch x shape; ``input_specs`` and ``params_shape``
give the shapes and dtypes of the reference's ``jax.eval_shape``
stand-ins (as meta tensors). Then two smoke cells run through the dry run
on a fake process group of 16 ranks as a 4x4 mesh: each completes, its
per-rank param bytes equal the sum of the placed DTensors' local shards,
and the TP cell counts at least one all-reduce. The fake group is torn
down after them, so no later test in the worker sees a process group.
"""

from __future__ import annotations

import jax
import pytest

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.launch import specs as jspecs
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import comm_analysis, dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs
from repro_torch.nn.module import tree_flatten_with_paths

SMOKE_MESH = ((4, 4), ("data", "model"))


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", "")) for k in pk): leaf
            for pk, leaf in flat}


def _same(tleaves, jleaves):
    assert sorted(tleaves) == sorted(jleaves)
    for path, leaf in tleaves.items():
        j = jleaves[path]
        assert tuple(leaf.shape) == tuple(j.shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(j.dtype), path
        assert leaf.device.type == "meta"


def test_shape_cells_equal_the_reference():
    assert {k: (c.name, c.seq, c.global_batch, c.kind)
            for k, c in specs.SHAPES.items()} == \
        {k: (c.name, c.seq, c.global_batch, c.kind)
         for k, c in jspecs.SHAPES.items()}
    assert specs.FULL_ATTENTION_ARCHS == jspecs.FULL_ATTENTION_ARCHS


@pytest.mark.parametrize("arch", list_configs())
def test_cell_status_and_input_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape, cell in specs.SHAPES.items():
        status = specs.cell_status(arch, shape, cfg)
        assert status == jspecs.cell_status(arch, shape, jcfg)
        if status:
            continue
        got = specs.input_specs(cfg, cell)
        want = jspecs.input_specs(jcfg, jspecs.SHAPES[shape])
        if cell.kind == "decode":
            _same(dict(tree_flatten_with_paths(got["cache"])),
                  _jflat(want["cache"]))
            got, want = {"token": got["token"]}, {"token": want["token"]}
        _same(got, want)


@pytest.mark.parametrize("arch", list_configs())
def test_params_shape_equals_the_reference_eval_shape(arch):
    _same(dict(tree_flatten_with_paths(specs.params_shape(get_config(arch)))),
          _jflat(jspecs.params_shape(jget_config(arch))))


@pytest.fixture(scope="module")
def smoke_cells():
    """Two smoke cells on a fake 4x4 group; the group is destroyed after."""
    import torch.distributed as dist
    try:
        recs = {(arch, shape): dryrun.run_cell(
            arch, shape, mesh_shape=SMOKE_MESH, cfg=smoke_variant(arch))
            for arch, shape in (("smollm-360m", "train_4k"),
                                ("kimi-k2-1t-a32b", "decode_32k"))}
        yield recs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _placed_param_bytes(arch):
    """This rank's bytes of the smoke params placed on the fake mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import lm
    cfg = smoke_variant(arch)
    mesh = mesh_mod.make_mesh(*SMOKE_MESH, device_type="cpu")
    rules = sh.build_rules(cfg, mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        placed = sh.distribute_tree(lm.init_lm(0, cfg, device="cpu"), cfg,
                                    mesh, rules)
        return sum(x.to_local().numel() * x.element_size()
                   for _, x in tree_flatten_with_paths(placed))


@pytest.mark.parametrize("cell", [("smollm-360m", "train_4k"),
                                  ("kimi-k2-1t-a32b", "decode_32k")])
def test_smoke_dry_run_completes_with_its_numbers(smoke_cells, cell):
    rec = smoke_cells[cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "4x4" and rec["flops"] > 0
    assert rec["bytes_per_rank"]["params"] == _placed_param_bytes(cell[0])
    coll = rec["collectives"]
    assert coll["counts"]["total"] == sum(
        coll["counts"][k] for k in comm_analysis.COLLECTIVE_OPS)
    assert coll["counts"]["all-reduce"] >= 1          # TP's partial sums
    assert coll["bytes"]["all-reduce"] > 0
    assert rec["peak_bytes"] is None                 # no usable peak yet
    assert rec["peak_bytes_absent"] == dryrun.PEAK_ABSENT
    if cell[1] == "train_4k":
        assert rec["bytes_per_rank"]["optimizer"] > 0
        assert coll["counts"]["reduce-scatter"] >= 1  # gradients to params


def test_dry_run_records_a_failing_cell(tmp_path):
    rec = dryrun.run_cell("smollm-360m", "no_such_shape",
                          mesh_shape=SMOKE_MESH, out_dir=tmp_path)
    assert rec["status"].startswith("error: KeyError")
    assert (tmp_path / "smollm-360m__no_such_shape__4x4.json").exists()


def test_dry_run_skips_what_the_reference_skips():
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k",
                          mesh_shape=SMOKE_MESH)
    assert rec["status"].startswith("skip: encoder-only")
