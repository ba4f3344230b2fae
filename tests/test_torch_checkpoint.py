"""repro_torch's checkpoints (``checkpoint/ckpt.py``) on the CPU, against
the reference's ``repro.checkpoint.ckpt``.

Every case of the reference's ``tests/test_checkpoint.py`` on the port
(round trip, atomicity, keep-k GC, shape and key mismatches, the dtype
cast on restore, the manifest, restore onto a device as the counterpart
of ``shardings=``), and the on-disk protocol held against the reference's:
the same tree saved by both packages gives the same manifest leaves and
npz keys, and a checkpoint written by either package restores bitwise in
the other, an LM's training state included (bfloat16 params, AdamW's
step counter, float32 master copy and moments).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import smoke_variant
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig, adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.nn.module import tree_flatten_with_paths
from repro_torch.optim.adamw import AdamWConfig as TAdamWConfig
from repro_torch.optim.adamw import adamw_init as tadamw_init
from repro_torch.weights import lm_params_from_numpy


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros(4)},
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.randn((3,), generator=g)]}


def _meta(tree):
    """Shape and dtype only (the reference's ShapeDtypeStruct)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _leaves(tree):
    return dict(tree_flatten_with_paths(
        {k: ({str(i): x for i, x in enumerate(v)} if isinstance(v, list)
             else v) for k, v in tree.items()}))


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 10, tree)
    assert latest_step(tmp_path) == 10
    out = restore_checkpoint(tmp_path, _meta(tree))
    got, want = _leaves(out), _leaves(tree)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].device.type == "cpu"
        assert torch.equal(got[k], want[k]), k
    # the reference restores the port's checkpoint
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), jnp.dtype(str(x.dtype).removeprefix("torch."))),
        tree)
    ref = jckpt.restore_checkpoint(tmp_path, target)
    assert isinstance(ref["nested"], list)
    for k, v in _leaves({"layers": ref["layers"], "step": ref["step"],
                         "nested": ref["nested"]}).items():
        np.testing.assert_array_equal(np.asarray(v), want[k].numpy())


def test_atomicity_no_partial_checkpoints(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 1, tree)
    # a crashed writer's stale tmp dir must not count as a checkpoint
    stale = tmp_path / "tmp.99.12345"
    stale.mkdir()
    (stale / "proc_0.npz").write_bytes(b"garbage")
    assert latest_step(tmp_path) == 1 == jckpt.latest_step(tmp_path)
    mgr = CheckpointManager(tmp_path, keep=2, save_interval_steps=1)
    mgr.save(2, tree, force=True)
    assert not any(p.name.startswith("tmp.") for p in tmp_path.iterdir())


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, save_interval_steps=1)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, force=True)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4]
    assert mgr.save(5, tree) == tmp_path / "step_00000005"
    mgr.save_interval_steps = 2
    assert mgr.save(7, tree) is None and latest_step(tmp_path) == 5


def test_restore_detects_shape_mismatch(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, {"w": torch.empty((8, 4),
                                                       device="meta")})
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path, {"v": torch.empty((4, 4),
                                                       device="meta")})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", {"w": torch.zeros((4, 4))})


def test_restore_with_dtype_cast(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones((4,), dtype=torch.float32)})
    out = restore_checkpoint(
        tmp_path, {"w": torch.empty((4,), dtype=torch.bfloat16,
                                    device="meta")})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.ones((4,), dtype=torch.bfloat16))


def test_manifest_contents(tmp_path):
    save_checkpoint(tmp_path / "port", 3, _tree(), extra={"arch": "smollm-360m"})
    man = json.load(open(tmp_path / "port" / "step_00000003" / "manifest.json"))
    assert man["step"] == 3
    assert man["extra"]["arch"] == "smollm-360m"
    assert "layers/w" in man["leaves"]
    # the reference's manifest and npz of the same tree
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _tree())
    jckpt.save_checkpoint(tmp_path / "ref", 3, jtree,
                          extra={"arch": "smollm-360m"})
    want = json.load(open(tmp_path / "ref" / "step_00000003" / "manifest.json"))
    assert man["leaves"] == want["leaves"]
    with np.load(tmp_path / "port" / "step_00000003" / "proc_0.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000003" / "proc_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_restore_onto_a_device(tmp_path):
    """The counterpart of the reference's restore with shardings: the
    leaves land on ``device``, whatever the target's."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    save_checkpoint(tmp_path, 5, tree)
    out = restore_checkpoint(tmp_path, {"w": torch.empty((4, 4),
                                                         device="meta")},
                             device="cpu")
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.arange(16.0).reshape(4, 4))
    mgr = CheckpointManager(tmp_path)
    step, back = mgr.restore_latest(tree, device=torch.device("cpu"))
    assert step == 5 and torch.equal(back["w"], tree["w"])
    assert CheckpointManager(tmp_path / "empty").restore_latest(tree) == \
        (None, None)


def _lm_state(arch="smollm-360m"):
    """An LM's training state in both packages, from the same numpy
    weights (bfloat16 params, float32 AdamW state), a step taken into
    the counter and the moments so that no leaf is trivially zero."""
    jcfg = smoke_variant(arch)
    tcfg = tconfigs.smoke_variant(arch)
    assert jcfg.dtype == "bfloat16"
    npw = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(1), jcfg))
    jp = jax.tree.map(jnp.asarray, npw)
    jo = jadamw_init(jp, AdamWConfig())
    rng = np.random.default_rng(0)
    jo = {**jo, "step": jnp.asarray(5, jnp.int32),
          "mu": jax.tree.map(lambda m: jnp.asarray(
              rng.standard_normal(m.shape).astype(np.float32)), jo["mu"]),
          "nu": jax.tree.map(lambda m: jnp.asarray(
              rng.random(m.shape).astype(np.float32)), jo["nu"]),
          "master": jax.tree.map(lambda m: m + jnp.float32(1e-3) * (
              jnp.asarray(rng.standard_normal(m.shape), jnp.float32)),
              jo["master"])}
    tp = lm_params_from_numpy(npw, "cpu", tcfg)
    to = tadamw_init(tp, TAdamWConfig())
    assert set(to) == set(jo)
    to["step"] = torch.tensor(5, dtype=torch.int32)
    for k in ("mu", "nu", "master"):
        to[k] = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jo[k])
    return {"params": jp, "opt": jo}, {"params": tp, "opt": to}


def _same(torch_tree, jax_tree):
    want = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, jax_tree)))
    got = dict(tree_flatten_with_paths(torch_tree))
    assert set(got) == set(want)
    for k, t in got.items():
        w = want[k]
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), k
        assert tuple(t.shape) == w.shape, k
        tw = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        ww = w.astype(np.float32) if w.dtype == ml_dtypes.bfloat16 else w
        assert tw.tobytes() == np.ascontiguousarray(ww).tobytes(), k


def test_lm_training_state_restores_bitwise_across_packages(tmp_path):
    jstate, tstate = _lm_state()
    _same(tstate, jstate)
    # the reference writes, the port restores
    jckpt.save_checkpoint(tmp_path / "ref", 5, jstate)
    _same(restore_checkpoint(tmp_path / "ref", _meta(tstate)), jstate)
    # the port writes, the reference restores
    save_checkpoint(tmp_path / "port", 5, tstate)
    target = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          jstate)
    _same(tstate, jckpt.restore_checkpoint(tmp_path / "port", target))
    # and the manifests agree leaf for leaf
    m = [json.load(open(d / "step_00000005" / "manifest.json"))["leaves"]
         for d in (tmp_path / "ref", tmp_path / "port")]
    assert m[0] == m[1]
    assert m[1]["params/embed/table"]["dtype"] == "bfloat16"
    assert m[1]["opt/step"] == {"shape": [], "dtype": "int32"}
