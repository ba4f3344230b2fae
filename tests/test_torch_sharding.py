"""repro_torch's sharding rules (``distributed/sharding.py``,
``launch/shardings.py``, ``launch/mesh.py``) on the CPU, against the
reference's ``repro.distributed.sharding`` and ``repro.launch.shardings``.

No process group is needed: the rules and specs take a mesh's dims and
sizes (``launch.mesh.MeshShape``; the reference's side an ``AbstractMesh``
built with jax 0.9's ``(axis_sizes, axis_names)`` signature). For every
arch of ``list_configs()`` at the reference's 16x16 and 2x16x16 and at the
port's production shapes 32x8 and 2x32x8: the rule table, every param
leaf's ``param_spec`` after ``_sanitize``, the batch specs and the decode
cache specs are equal to the reference's. Then the reference's own cases
on the port: every sanitized spec divides its dim, the MoE strategy (at
the port's model = 8, grok-1's 8 experts become expert-parallel),
``spec_for``, ``shard`` outside rules, and the per-rank bytes of yi-34b,
kimi-k2 and grok-1's params at the H100 mesh against one card's 80 GB.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.distributed import sharding as jsharding
from repro.launch import shardings as jsh
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs
from repro_torch.nn.module import tree_flatten_with_paths

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "32x8": mesh_mod.production_shape(False),
          "2x32x8": mesh_mod.production_shape(True)}
H100_BYTES = 80 * 10**9


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), mesh_mod.MeshShape(shape, names)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return specs.params_shape(get_config(arch))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jspecs.params_shape(jget_config(arch))


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", "")) for k in pk): leaf
            for pk, leaf in flat}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_rules_and_param_specs_equal_the_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for serve in (False, True):
        rules = sh.build_rules(cfg, tmesh, serve=serve)
        jrules = jsh.build_rules(jcfg, jmesh, serve=serve)
        assert rules == jrules, (arch, serve)
    rules = sh.build_rules(cfg, tmesh)
    jrules = jsh.build_rules(jcfg, jmesh)
    tleaves = dict(tree_flatten_with_paths(_params(arch)))
    jleaves = _jpaths(_jparams(arch))
    assert sorted(tleaves) == sorted(jleaves)
    for path, leaf in tleaves.items():
        jleaf = jleaves[path]
        assert tuple(leaf.shape) == tuple(jleaf.shape), path
        want = tuple(jsh._sanitize(jsh.param_spec(path, jleaf.ndim, jcfg,
                                                  jrules),
                                   jleaf.shape, jmesh))
        assert sh.leaf_spec(path, leaf, cfg, tmesh, rules) == want, path
        # the optimizer's moments mirror the param below them
        assert sh.leaf_spec("mu/" + path, leaf, cfg, tmesh, rules) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_batch_and_cache_specs_equal_the_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in ("train_4k", "decode_32k"):
        if specs.cell_status(arch, shape, cfg):
            continue
        cell = specs.SHAPES[shape]
        rules = sh.build_rules(cfg, tmesh, serve=cell.kind == "decode")
        jrules = jsh.build_rules(jcfg, jmesh, serve=cell.kind == "decode")
        inputs = specs.input_specs(cfg, cell)
        jinputs = jspecs.input_specs(jcfg, jspecs.SHAPES[shape])
        if cell.kind == "decode":
            got = dict(tree_flatten_with_paths(
                sh.cache_specs(inputs["cache"], tmesh, rules)))
            want = {p: tuple(s.spec) for p, s in _jpaths(
                jsh.cache_shardings(jinputs["cache"], jcfg, jmesh,
                                    jrules)).items()}
            assert got == want
            batch = {"token": inputs["token"]}
            jbatch = {"token": jinputs["token"]}
        else:
            batch, jbatch = inputs, jinputs
        want = {k: tuple(s.spec) for k, s in jsh.batch_shardings(
            jbatch, jcfg, jmesh, jrules).items()}
        assert {k: sh.batch_spec(v, tmesh, rules)
                for k, v in batch.items()} == want


@pytest.mark.parametrize("mesh_name", ["32x8", "2x32x8"])
@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_divide_at_the_production_meshes(arch, mesh_name):
    """Every param leaf's spec evenly divides its dims, and its DTensor
    placements shard each named dim on the mesh dims the spec names."""
    _, tmesh = _meshes(mesh_name)
    cfg = get_config(arch)
    rules = sh.build_rules(cfg, tmesh)
    names = tmesh.mesh_dim_names
    for path, leaf in tree_flatten_with_paths(_params(arch)):
        spec = sh.leaf_spec(path, leaf, cfg, tmesh, rules)
        place = sharding.placements(spec, tmesh)
        for i, entry in enumerate(spec):
            axes = sharding.entry_axes(entry)
            size = int(np.prod([mesh_mod.axis_size(tmesh, a)
                                for a in axes]))
            assert leaf.shape[i] % size == 0, (arch, path, spec)
            for a in axes:
                assert place[names.index(a)].is_shard(i)


@pytest.mark.parametrize("arch", ["yi-34b", "kimi-k2-1t-a32b",
                                  "grok-1-314b"])
def test_big_arch_params_fit_one_card(arch):
    """Per-rank param bytes at the H100 mesh (32x8) are under one card's
    80 GB, counted from the placements."""
    _, tmesh = _meshes("32x8")
    cfg = get_config(arch)
    rules = sh.build_rules(cfg, tmesh)
    params = _params(arch)
    per_rank = sh.per_rank_bytes(params, sh.tree_specs(params, cfg, tmesh,
                                                       rules), tmesh)
    total = sum(x.numel() * x.element_size()
                for _, x in tree_flatten_with_paths(params))
    assert total // tmesh.size() <= per_rank < H100_BYTES, \
        (arch, per_rank / 1e9)


@pytest.mark.parametrize("mesh_name", ["16x16", "32x8"])
def test_moe_expert_sharding_strategy(mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    kimi = sh.build_rules(get_config("kimi-k2-1t-a32b"), tmesh)
    grok = sh.build_rules(get_config("grok-1-314b"), tmesh)
    assert kimi["experts"] == ("model",)      # 384 experts -> EP
    assert kimi["moe_ffn"] is None
    if mesh_name == "16x16":                  # the reference's case
        assert grok["experts"] is None        # 8 experts -> shard ffn
        assert grok["moe_ffn"] == ("model",)
        assert grok == jsh.build_rules(jget_config("grok-1-314b"), jmesh)
    else:                                     # model = 8: EP for grok too
        assert grok["experts"] == ("model",)
        assert grok["moe_ffn"] is None


def test_spec_for_and_rules():
    rules = sharding.base_rules(multi_pod=True, fsdp=True)
    assert sharding.spec_for("batch", None, "heads", rules=rules) == \
        (("pod", "data"), None, "model")
    assert sharding.spec_for("batch", rules=sharding.base_rules()) == \
        ("data",)
    for kw in ({}, {"multi_pod": True}, {"fsdp": True},
               {"multi_pod": True, "fsdp": True, "seq_shard": True}):
        assert sharding.base_rules(**kw) == jsharding.base_rules(**kw)
        for names in (("batch", None, "heads"), ("embed", "vocab"),
                      ("experts", "expert_embed", "moe_ffn")):
            assert sharding.spec_for(
                *names, rules=sharding.base_rules(**kw)) == tuple(
                jsharding.spec_for(*names,
                                   rules=jsharding.base_rules(**kw)))
    assert sharding.spec_for("batch") == ()   # no rules active


def test_placements_follow_the_spec_and_keep_unresolved_dims():
    from torch.distributed.tensor import Partial, Replicate, Shard
    m = mesh_mod.MeshShape((2, 16, 8), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, None), m) == [Replicate()] * 3
    # an unresolved dim keeps its current placement (UNCONSTRAINED)
    cur = (Shard(0), Replicate(), Shard(2))
    assert sharding.placements((None, None, None), m, current=cur) == \
        list(cur)
    assert sharding.placements(("data", None, None), m,
                               current=(Shard(1), Partial(), Shard(0))) \
        == [Shard(1), Shard(0), Replicate()]
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), m)


def test_local_slices_tile_the_global_tensor():
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_mod.MeshShape((2, 2, 2), ("pod", "data", "model"))
    place = [Shard(0), Shard(0), Shard(1)]
    seen = np.zeros((8, 6), int)
    for coord in np.ndindex(2, 2, 2):
        sl = sharding.local_slices((8, 6), m, place, coord=list(coord))
        seen[sl] += 1
        assert sl[0] == slice(4 * coord[0] + 2 * coord[1],
                              4 * coord[0] + 2 * coord[1] + 2)
    assert (seen == 1).all()
    assert sharding.local_slices((8, 6), m, [Replicate()] * 3,
                                 coord=[1, 1, 1]) == (slice(0, 8),
                                                      slice(0, 6))
    with pytest.raises(ValueError):
        sharding.local_slices((3, 6), m, place, coord=[0, 0, 0])


def test_shard_is_the_identity_outside_rules_and_on_plain_tensors():
    x = torch.ones((4, 4))
    assert sharding.shard(x, "batch", None) is x
    with sharding.use_rules(mesh_mod.MeshShape((1, 1), ("data", "model")),
                            sharding.base_rules()):
        assert sharding.shard(x, "batch", None) is x
        assert sharding.current_rules()["batch"] == ("data",)
    assert sharding.current_rules() is None
    jx = jax.numpy.ones((4, 4))
    np.testing.assert_array_equal(np.asarray(jsharding.shard(jx, "batch",
                                                             None)),
                                  x.numpy())


def test_production_meshes_keep_the_reference_device_counts():
    assert mesh_mod.production_shape(False) == ((32, 8), ("data", "model"))
    assert mesh_mod.production_shape(True) == ((2, 32, 8),
                                               ("pod", "data", "model"))
    for multi in (False, True):
        shape, _ = mesh_mod.production_shape(multi)
        assert int(np.prod(shape)) == (512 if multi else 256)
    assert mesh_mod.debug_shape(8) == (4, 2)
    assert mesh_mod.debug_shape(6) == (2, 3)
    assert mesh_mod.debug_shape(3) == (1, 3)
