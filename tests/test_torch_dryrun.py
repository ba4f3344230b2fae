"""repro_torch's dry-run tooling (``launch/specs.py``, ``launch/dryrun.py``,
``launch/comm_analysis.py``) on the CPU.

``SHAPES``, ``FULL_ATTENTION_ARCHS`` and ``cell_status`` equal the
reference's for every arch x shape; ``input_specs`` and ``params_shape``
give the shapes and dtypes of the reference's ``jax.eval_shape``
stand-ins (as meta tensors). Then two smoke cells run through the dry run
on a fake process group of 16 ranks as a 4x4 mesh: each completes, its
per-rank param bytes equal the sum of the placed DTensors' local shards,
the TP cell counts at least one all-reduce, and its memory record holds
the inputs' local bytes as arguments (params, AdamW state and batch; or
params, cache and token), at most its peak. The FLOPs and collectives
of each are the same with the storage tracker replaced by a pass-through
mode. The tracker itself: three matmuls with known live sets give their
exact peak, on real tensors and fake ones; and each family's train,
prefill and decode steps at a tiny shape on a fake group of one rank, a
(1, 1) mesh, give the same memory record on real CPU tensors as on fake
ones. Every fake group is torn down after its tests, so no later test in
the worker sees a process group.
"""

from __future__ import annotations

import contextlib

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

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
    mem = rec["memory"]
    inputs = specs.input_specs(smoke_variant(cell[0]), specs.SHAPES[cell[1]])
    data = SMOKE_MESH[0][0]               # the batch dim splits over "data"
    if cell[1] == "train_4k":
        state = rec["bytes_per_rank"]["params"] \
            + rec["bytes_per_rank"]["optimizer"]
        batch = sum(x.numel() * x.element_size() for x in inputs.values())
    else:
        state = rec["bytes_per_rank"]["params"] \
            + rec["bytes_per_rank"]["cache"]
        batch = inputs["token"].numel() * inputs["token"].element_size()
    assert mem["argument_size_bytes"] == state + batch // data
    assert mem["argument_size_bytes"] <= mem["peak_bytes"]
    assert mem["peak_bytes"] == mem["argument_size_bytes"] \
        + mem["temp_size_bytes"]
    assert 0 < mem["output_size_bytes"] <= mem["temp_size_bytes"]
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


class _PassThrough(TorchDispatchMode):
    """``StorageTracker``'s place in the mode stack, counting nothing."""

    def __init__(self, args):
        super().__init__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))

    def record(self, outputs):
        return {}


@pytest.mark.parametrize("cell", [("smollm-360m", "train_4k"),
                                  ("kimi-k2-1t-a32b", "decode_32k")])
def test_the_storage_tracker_leaves_flops_and_collectives_alone(
        smoke_cells, cell, monkeypatch):
    monkeypatch.setattr(dryrun, "StorageTracker", _PassThrough)
    bare = dryrun.run_cell(*cell, mesh_shape=SMOKE_MESH,
                           cfg=smoke_variant(cell[0]))
    tracked = smoke_cells[cell]
    assert bare["status"] == "ok" and bare["memory"] == {}
    assert bare["flops"] == tracked["flops"]
    assert bare["collectives"] == tracked["collectives"]


def _three_matmuls(x, w1, w2, w3):
    h1 = x @ w1                    # [8, 32] f32: 1024 B live
    h2 = h1 @ w2                   # [8, 64]: 2048 B more, 3072 live (peak)
    del h1                         # 2048 live
    return h2 @ w3                 # [8, 4]: 128 B, 2176 live; h2 freed


@pytest.mark.parametrize("fake", [False, True])
def test_the_storage_tracker_gives_three_matmuls_their_exact_peak(fake):
    shapes = ((8, 16), (16, 32), (32, 64), (64, 4))
    with FakeTensorMode() if fake else contextlib.nullcontext():
        args = tuple(torch.ones(s) for s in shapes)
        tracker = dryrun.StorageTracker(args)
        with tracker:
            out = _three_matmuls(*args)
        assert tracker.live == 128          # the output alone
        rec = tracker.record(out)
    assert rec == {"argument_size_bytes": 4 * (128 + 512 + 2048 + 256),
                   "output_size_bytes": 128, "temp_size_bytes": 3072,
                   "peak_bytes": 4 * (128 + 512 + 2048 + 256) + 3072}


@pytest.fixture(scope="module")
def world1():
    """A fake group of one rank and a (1, 1) mesh; destroyed after."""
    import torch.distributed as dist
    try:
        dryrun.fake_world(1)
        yield mesh_mod.make_mesh((1, 1), ("data", "model"),
                                 device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("arch,kind", [
    ("smollm-360m", "train"), ("mamba2-1.3b", "train"),
    ("hymba-1.5b", "prefill"), ("kimi-k2-1t-a32b", "decode"),
    ("grok-1-314b", "train")])
def test_real_and_fake_steps_give_the_same_memory_record(world1, arch, kind):
    cfg = smoke_variant(arch)
    cell = specs.ShapeCell("tiny", 16, 2, kind)
    rules = sh.build_rules(cfg, world1, serve=kind == "decode")
    real = dryrun.run_step(cfg, cell, world1, rules)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = dryrun.run_step(cfg, cell, world1, rules)
    assert real["memory"] == fake["memory"]
    assert real["flops"] == fake["flops"]
    assert real["memory"]["argument_size_bytes"] == \
        sum(v for k, v in real["bytes_per_rank"].items()
            if k != "gradients") + sum(
            x.numel() * x.element_size()
            for k, x in specs.input_specs(cfg, cell).items() if k != "cache")


def test_the_ce_backward_holds_only_a_rank_s_rows():
    """``lm._ce`` on logits split over "data" 16 ways: its backward's
    storage stays a few of a rank's rows, where DTensor's gather backward
    made a replicated zeros of the global shape on every rank."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    try:
        dryrun.fake_world(16)
        mesh = mesh_mod.make_mesh((16, 1), ("data", "model"),
                                  device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                sharding.use_rules(mesh, sharding.base_rules()):
            logits = sharding.distribute(torch.zeros(32, 8, 64), mesh,
                                         sharding.placements(
                                             ("data", None, None), mesh))
            labels = sharding.distribute(
                torch.zeros(32, 8, dtype=torch.int32), mesh,
                sharding.placements(("data", None), mesh))
            logits.requires_grad_()
            tracker = dryrun.StorageTracker((logits, labels))
            with tracker:
                torch.autograd.grad(lm._ce(logits, labels).sum(), logits)
        rows = 2 * 8 * 64 * 4                 # a rank's float32 logits
        assert tracker.peak <= 5 * rows < 32 * 8 * 64 * 4
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_the_driver_holds_no_state_beyond_its_step(tmp_path):
    """``launch/train.py``'s whole run, tracked from before its init, peaks
    where one of its steps does (the state, the step's temp): no
    reference of the driver's keeps the initial state alive past the
    first step."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    if dist.is_initialized():                    # no mesh for the driver
        dist.destroy_process_group()
    cfg = smoke_variant("smollm-360m")
    cfg = dataclasses.replace(cfg, max_seq=max(cfg.max_seq, 128))
    opt_cfg = AdamWConfig(lr=3e-4)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = adamw_init(params, opt_cfg)
    batch = {k: torch.zeros((8, 128), dtype=torch.int32)
             for k in ("tokens", "labels")}
    tracker = dryrun.StorageTracker((params, opt, batch))
    with tracker:
        out = steps.make_train_step(cfg, opt_cfg, 128)(params, opt, batch)
    step = tracker.record(out)
    state = step["argument_size_bytes"] - 2 * 8 * 128 * 4
    del params, opt, out
    run = dryrun.StorageTracker(())
    with run:
        train.train(["--arch", "smollm-360m", "--smoke", "--steps", "3",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "100"])
    assert step["peak_bytes"] - state // 2 < run.peak \
        < step["peak_bytes"] + state // 2
