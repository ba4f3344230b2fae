"""repro_torch's distributed path over ``torch.distributed`` on the CPU:
multi-rank checks in spawned gloo worlds (``distributed/world.py``; the
checks themselves are ``distributed/checks.py``, which ``chip_smoke.py``'s
``[dist]`` phase runs too).

Three worlds, each started once for the file (a world costs ~4 s of
start-up), each with its own ``file://`` store under ``tmp_path`` (never a
fixed port: the suite runs with several workers) and its own deadline,
which kills its ranks and fails the tests that read it:

* 2 ranks: ``launch/train.py --mesh 1x2`` against its single-device run
  (bfloat16: within 2^-8 relative); the MoE block's expert-parallel
  branch against its fallback at 1x2 (experts over "model") and 2x1 under
  FSDP (the experts all-gathered over "data"), and the fallback with its
  FFN dim over "model" (1x2): expert indices, slots and dropped fraction
  exact, ``y`` within 1e-5, the gradients within 1e-5 of each leaf's
  largest; ``compressed_allreduce_update`` bitwise against the mean of
  both ranks' dequantized leaves computed in one process (a two-term sum
  is exact in either order), the error feedback too; ``pod_psum`` over a
  2x1x1 mesh; ``make_debug_mesh``; a checkpoint saved from DTensors at
  1x2;
* the train step of smollm's smoke variant (float32) under FSDP (2x1) and
  TP+DP (2x2, 4 ranks), and grok-1's (grouped dispatch, the experts over
  "model", 1x2), against the port's unsharded step: the loss within 1e-6
  relative, each gradient leaf within 1e-4 of its largest (row-parallel
  sums are not bitwise), the params keeping their placements after an
  AdamW step;
* 4 ranks: GPipe (``pipeline_forward``) at S = 4 with M = 4 and 8
  against the sequential loop and the reference's ``pipeline_forward``
  semantics (a ``lax.scan`` over the same numpy layers) within 1e-5; the
  1x2 checkpoint restored by ``elastic_remesh`` at 2x2 bitwise, and the
  data pipeline's rank slices;
* 1 rank: the same checkpoint restored at 1x1 bitwise;
* at 1x1 and 1x2: ``remat="full"`` recomputes every layer once in the
  sharded backward, as unsharded, and its gradients are bitwise those of
  ``remat="none"`` on the same DTensors.

``world.run_world`` itself: a rank's exception fails the call with its
traceback, and a hung world is killed at its deadline.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.distributed import checks, world
from repro_torch.distributed.pipeline import bubble_fraction

WORLD_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


@pytest.fixture(scope="module")
def world2(store):
    items = [
        ("moe_ep", "moe_check", ("kimi-k2-1t-a32b", (1, 2)), {}),
        ("moe_ep_fsdp", "moe_check", ("grok-1-314b", (2, 1)),
         {"fsdp": True}),
        ("moe_ffn_tp", "moe_check", ("grok-1-314b", (1, 2)),
         {"ffn_parallel": True}),
        ("compression", "compression_check", (), {}),
        ("save", "elastic_save", (str(store / "ckpt"), "smollm-360m",
                                  (1, 2)), {}),
        ("driver", "driver_check", (str(store / "driver"),), {}),
        ("pod", "pod_check", (), {}),
        ("debug_mesh", "debug_mesh_check", (), {}),
        ("remat", "remat_check", ("smollm-360m", (1, 2)), {}),
        ("fsdp", "train_check", ("smollm-360m", (2, 1)),
         {"fsdp": True, "steps": 1}),
        ("moe_ep_train", "train_check", ("grok-1-314b", (1, 2)),
         {"overrides": {"moe_dispatch": "grouped"}, "steps": 1}),
    ]
    t0 = time.perf_counter()
    out = world.run_world(checks.suite, 2, str(store), args=(items,),
                          timeout=WORLD_TIMEOUT)
    return out, time.perf_counter() - t0


@pytest.fixture(scope="module")
def world4(store, world2):
    items = [
        ("tp_dp", "train_check", ("smollm-360m", (2, 2)), {"steps": 1}),
        ("pipeline", "pipeline_check", (), {}),
        ("restore", "elastic_restore", (str(store / "ckpt"), "smollm-360m",
                                        (2, 2)), {}),
    ]
    t0 = time.perf_counter()
    out = world.run_world(checks.suite, 4, str(store), args=(items,),
                          timeout=WORLD_TIMEOUT)
    return out, time.perf_counter() - t0


@pytest.fixture(scope="module")
def world1(store, world2):
    items = [("restore", "elastic_restore", (str(store / "ckpt"),
                                             "smollm-360m", (1, 1)), {}),
             ("remat", "remat_check", ("smollm-360m", (1, 1)), {})]
    return world.run_world(checks.suite, 1, str(store), args=(items,),
                           timeout=WORLD_TIMEOUT)


@pytest.mark.parametrize("name", ["moe_ep", "moe_ep_fsdp", "moe_ffn_tp"])
def test_moe_expert_parallel_block_matches_the_fallback(world2, name):
    for r in world2[0]:
        got = r[name]
        assert got["expert_parallel"] != (name == "moe_ffn_tp")
        assert got["ffn_parallel"] == (name == "moe_ffn_tp")
        assert got["indices_equal"] and got["slots_equal"]
        assert got["dropped"][0] == got["dropped"][1] > 0
        assert got["balance_rel"] <= 1e-6
        assert got["y_err"] <= 1e-5 * max(1.0, got["y_max"])
        assert got["x_grad_err"] <= 1e-5 and got["w_grad_err"] <= 1e-5


def test_debug_mesh_splits_the_world_as_the_reference(world2):
    for r in world2[0]:
        assert r["debug_mesh"] == {"shape": (2, 1),
                                   "dims": ("data", "model")}


def test_pod_psum_sums_over_the_pod_dim(world2):
    for r in world2[0]:
        assert r["pod"] == {"plain": True, "dtensor": True,
                            "placements": True}


def test_compressed_allreduce_is_bitwise_the_mean_of_the_dequantized(
        world2):
    for r in world2[0]:
        assert r["compression"]["bitwise"]
        assert r["compression"]["error_bitwise"]


@pytest.mark.parametrize("world_name,name", [
    ("world4", "tp_dp"), ("world2", "fsdp"), ("world2", "moe_ep_train")])
def test_sharded_train_step_matches_the_unsharded(request, world_name, name):
    for r in request.getfixturevalue(world_name)[0]:
        got = r[name]
        assert got["sharded_leaves"] > 0
        assert got["grad_loss_rel"] <= 1e-6
        assert got["grad_err"] <= 1e-4, got["grad_err_leaf"]
        assert got["loss_rel"] <= 1e-6
        assert got["placements_kept"]
        assert got["param_err"] <= 1e-4


def test_train_driver_trains_on_the_mesh_as_on_one_device(world2, store):
    """``launch/train.py --mesh 1x2`` under a process group: the params
    DTensors (the MLP and vocab sharded), the losses those of the driver's
    single-device run within 2^-8 relative (the smoke config is bfloat16:
    the row-parallel partial sums round to bfloat16 before they meet;
    measured 5e-5), and the last step's checkpoint gathered and written
    by rank 0."""
    from repro_torch.launch import train
    run = train.train(["--arch", "smollm-360m", "--smoke", "--device",
                       "cpu", "--steps", "3", "--seq", "16", "--batch",
                       "4", "--ckpt-dir", str(store / "driver_one")])
    for r in world2[0]:
        got = r["driver"]
        assert got["world"] == 2 and got["dtensors"] and got["sharded"] > 0
        assert got["first_step"] == 0
        np.testing.assert_allclose(got["losses"], run.losses, rtol=2**-8,
                                   atol=0)
    assert (store / "driver" / "sharded" / "step_00000003").exists()


def _reference_sequential(layers, x):
    """The reference's pipeline semantics: ``lax.scan`` of the layer body
    over the stacked layers."""
    def body(h, lp):
        return jnp.tanh(h @ lp["w"] + lp["b"]), None
    out, _ = jax.lax.scan(body, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in layers.items()})
    return np.asarray(out)


@pytest.mark.parametrize("m", [4, 8])
def test_gpipe_matches_sequential_and_the_reference(world4, m):
    layers, x = checks.pipeline_layers()
    ref = _reference_sequential(layers, x)
    for r in world4[0]:
        got = r["pipeline"]
        assert got[f"err_{m}"] <= 1e-5
        np.testing.assert_allclose(got[m], got["sequential"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got[m], ref, rtol=0, atol=1e-5)
    assert bubble_fraction(4, m) == 3 / (m + 3)


def test_elastic_restore_at_four_ranks_is_bitwise(world4):
    for r in world4[0]:
        got = r["restore"]
        assert got["step"] == 7 and got["bitwise"] and got["placements"]


@pytest.mark.parametrize("world_name", ["world1", "world2"])
def test_remat_recomputes_every_layer_under_the_rules(request, world_name):
    """``remat="full"`` on DTensor params (1x1 and TP 1x2) recomputes each
    layer once in the backward, as unsharded, with the gradients of
    ``remat="none"`` bitwise."""
    out = request.getfixturevalue(world_name)
    for r in (out if world_name == "world1" else out[0]):
        got = r["remat"]
        assert got["recomputes_sharded"] == got["layers"] > 0
        assert got["recomputes_unsharded"] == got["layers"]
        assert got["recomputes_remat_none"] == 0
        assert got["bitwise_remat_none"]


def test_elastic_restore_at_one_rank_is_bitwise(world1):
    got = world1[0]["restore"]
    assert got["step"] == 7 and got["bitwise"] and got["placements"]
    assert got["data"]["equal"] and got["data"]["local_rows"][0] == 8


def test_data_pipeline_rank_slices_concatenate_to_the_global_batch(world4):
    for r in world4[0]:
        data = r["restore"]["data"]
        assert data["equal"]
        assert set(data["local_rows"]) == {4}      # 8 rows over data = 2


def _raises(rank, world_size):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def _hangs(rank, world_size):
    time.sleep(60)


def test_run_world_reports_a_failing_rank(store):
    with pytest.raises(RuntimeError, match="rank one fails"):
        world.run_world(_raises, 2, str(store), timeout=60)


def test_run_world_kills_a_hung_world_at_its_deadline(store):
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        world.run_world(_hangs, 2, str(store), timeout=8)
    assert time.perf_counter() - t0 < 30
