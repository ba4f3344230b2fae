"""repro_torch's LM training slice on the CPU against the JAX reference.

The reference's ``init_lm`` weights (its own PRNG), carried as numpy
(``lm_params_from_numpy``), and the same seeded batches go through both
packages:

* ``lm_loss``'s value and gradients, the port's ``steps.loss_and_grads``
  against ``jax.value_and_grad``, in float32: one smoke arch a family
  (dense, ssm, hybrid, encoder, vlm, and the moe under both dispatches),
  and the W4A4 fake-quant (STE) on two. Loss within 1e-6 relative, each
  gradient leaf within 1e-4 of its largest |entry| (sums in another
  order; measured <= 5e-6);
* remat: ``"none"``, ``"full"`` and ``"dots"`` give bitwise equal losses
  and gradients; ``"dots"`` keeps the matmul outputs (no matmul runs again
  in the backward pass) where ``"full"`` runs them again; an explicit
  generator's draws (MR noise under the fake-quant) replay in the
  recompute;
* three ``make_train_step`` steps against the reference's (float32):
  losses within 1e-6 relative, grad norms within 1e-5, the params,
  AdamW's master copy and moments within 1e-4 of each leaf's largest
  |entry|, or for params and master within 0.1 * lr absolute: AdamW moves
  a weight by ~lr * g / (|g| + eps), and where |g| is a few eps (1e-8) the
  gradients' float32 error moves that by a few percent of lr (smollm's
  smoke ``w_gate``: 0.05 lr on two elements);
* ``vocab_chunk_for``, the prefill and serve steps;
* the driver (``launch/train.py``), every train-side case of the
  reference's ``tests/test_train_e2e.py``: the loss falls (and follows the
  reference driver's on the same initial weights within 1e-2 relative at
  every step: the smoke configs are bfloat16, whose step is 2^-8), a
  restart does only the remaining steps (the reference's driver and the
  port's resuming one checkpoint the port wrote), the W4A4 QAT run is
  finite (and follows the reference's); a crash and restart equals the
  uninterrupted run bitwise.
"""

from __future__ import annotations

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config, list_configs, smoke_variant
from repro.data.synthetic import (SyntheticTextConfig as JText,
                                  modality_batch,
                                  synthetic_lm_batch as jbatch)
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch.core.quant import WASpec, fake_quant_weight
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn.module import tree_flatten_with_paths
from repro_torch.nn.remat import remat
from repro_torch.optim.adamw import AdamWConfig as TAdamW
from repro_torch.optim.adamw import adamw_init as tadamw_init
from repro_torch.weights import lm_params_from_numpy

OPTS = {"xla_disable_hlo_passes": "algsimp",
        "xla_allow_excess_precision": False}
LOSS_TOL, GRAD_TOL = 1e-6, 1e-4
GRAD_CASES = [("smollm-360m", "none", None), ("mamba2-1.3b", "none", None),
              ("hymba-1.5b", "none", None), ("hubert-xlarge", "none", None),
              ("internvl2-26b", "none", None),
              ("grok-1-314b", "none", "sorted"),
              ("grok-1-314b", "none", "grouped"),
              ("smollm-360m", "w4a4", None), ("mamba2-1.3b", "w4a4", None)]


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)


def configs(arch, dtype="float32", quant="none", dispatch=None, **kw):
    kw.update(dtype=dtype, quant_scheme=quant)
    if dispatch is not None:
        kw["moe_dispatch"] = dispatch
    return (dataclasses.replace(smoke_variant(arch), **kw),
            dataclasses.replace(tconfigs.smoke_variant(arch), **kw))


@functools.lru_cache(maxsize=None)
def weights(arch, dtype="float32", seed=None):
    jcfg, _ = configs(arch, dtype)
    key = jax.random.PRNGKey(len(arch) if seed is None else seed)
    return jax.tree.map(np.asarray, jlm.init_lm(key, jcfg))


def leaf_errors(got_tree, want_tree):
    """{path: (max |got - want|, max |want|)} over the leaves."""
    want = dict(tree_flatten_with_paths(jax.tree.map(
        lambda a: np.asarray(a, np.float32), want_tree)))
    out = {}
    for path, g in tree_flatten_with_paths(got_tree):
        w = want[path]
        assert g.shape == w.shape, path
        out[path] = (float(np.abs(g.float().numpy() - w).max()),
                     float(np.abs(w).max()))
    assert set(out) == set(want)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# lm_loss's gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,quant,dispatch", GRAD_CASES)
def test_lm_loss_value_and_grads_match_reference(arch, quant, dispatch):
    jcfg, tcfg = configs(arch, quant=quant, dispatch=dispatch)
    npw = weights(arch)
    batch = modality_batch(jcfg, 2, 16, seed=1)
    jp = jax.tree.map(jnp.asarray, npw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg),
                            has_aux=True)
    (jloss, jmet), jgrads = compiled(fn, jp, jb)(jp, jb)
    loss, met, grads = tsteps.loss_and_grads(
        lm_params_from_numpy(npw, "cpu", tcfg), torch_batch(batch), tcfg)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    for k in ("ce", "balance", "z"):
        assert abs(float(met[k]) - float(jmet[k])) <= \
            LOSS_TOL * max(abs(float(jmet[k])), 1e-30), k
    assert float(met["dropped"]) == float(jmet["dropped"])
    for path, (err, scale) in leaf_errors(grads, jgrads).items():
        assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.mark.parametrize("arch,quant,dispatch",
                         [("smollm-360m", "w4a4", None),
                          ("mamba2-1.3b", "none", None),
                          ("hymba-1.5b", "none", None),
                          ("grok-1-314b", "w4a4", "grouped"),
                          ("internvl2-26b", "none", None)])
def test_remat_policies_give_bitwise_equal_gradients(arch, quant, dispatch):
    _, tcfg = configs(arch, quant=quant, dispatch=dispatch)
    params = tlm.init_lm(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    batch = torch_batch(modality_batch(tcfg, 2, 16, seed=2))
    runs = {policy: tsteps.loss_and_grads(
        params, batch, dataclasses.replace(tcfg, remat=policy))
        for policy in ("none", "full", "dots")}
    loss, _, grads = runs["none"]
    want = dict(tree_flatten_with_paths(grads))
    for policy in ("full", "dots"):
        got_loss, _, got = runs[policy]
        assert torch.equal(got_loss, loss), policy
        for path, g in tree_flatten_with_paths(got):
            assert torch.equal(g, want[path]), (policy, path)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_matmul_outputs_and_full_recomputes_them():
    _, base = configs("smollm-360m")
    params = tlm.init_lm(torch.Generator().manual_seed(0), base,
                         device="cpu")
    live = {k: v for k, v in tree_flatten_with_paths(params)}
    for v in live.values():
        v.requires_grad_(True)
    batch = torch_batch(modality_batch(base, 2, 16, seed=2))
    counts = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=policy)
        loss, _ = tlm.lm_loss(params, batch, cfg)
        with _CountMatmuls() as mode:
            torch.autograd.grad(loss, list(live.values()))
        counts[policy] = mode.n
    # "full" runs each layer's seven projections (and attention's
    # products) again, "dots" none of them
    assert counts["dots"] == counts["none"]
    assert counts["full"] >= counts["none"] + 7 * base.n_layers


def test_remat_replays_an_explicit_generators_draws():
    """MR noise under the fake-quant, drawn from a generator of the
    caller's: the recompute draws what the forward drew, and the generator
    ends where the run without remat leaves it."""
    spec = WASpec(4, 4, mr_noise_std=0.5)
    w = torch.randn((16, 8), generator=torch.Generator().manual_seed(1))
    x = torch.randn((4, 16), generator=torch.Generator().manual_seed(2))

    def layer(w, gen):
        return (x @ fake_quant_weight(w, spec, noise_generator=gen)).square()

    def run(policy, replay):
        gen = torch.Generator().manual_seed(7)
        leaf = w.clone().requires_grad_(True)
        y = remat(functools.partial(layer, gen=gen), leaf, policy=policy,
                  generators=(gen,) if replay else ())
        after_forward = torch.randn(3, generator=gen)
        grad, = torch.autograd.grad(y.sum(), leaf)
        return y.detach(), grad, after_forward, torch.randn(3, generator=gen)

    y, grad, after, later = run("none", False)
    for policy in ("full", "dots"):
        got = run(policy, True)
        assert torch.equal(got[0], y) and torch.equal(got[1], grad), policy
        # the generator is where the forward left it, not rewound
        assert torch.equal(got[2], after) and torch.equal(got[3], later)
    # without the replay the recompute draws new noise: other gradients
    assert not torch.equal(run("full", False)[1], grad)


# ---------------------------------------------------------------------------
# The train, prefill and serve steps
# ---------------------------------------------------------------------------

def test_three_train_steps_match_reference():
    arch = "smollm-360m"
    jcfg, tcfg = configs(arch)
    lr, seq = 2e-3, 16
    npw = weights(arch, seed=3)
    jstate = {"params": jax.tree.map(jnp.asarray, npw)}
    jstate["opt"] = jadamw_init(jstate["params"], JAdamW(lr=lr))
    tparams = lm_params_from_numpy(npw, "cpu", tcfg)
    tstate = {"params": tparams, "opt": tadamw_init(tparams, TAdamW(lr=lr))}
    text = JText(vocab=jcfg.vocab, seq=seq, batch=4, seed=0)
    jstep = jsteps.make_train_step(jcfg, JAdamW(lr=lr), seq)
    tstep = tsteps.make_train_step(tcfg, TAdamW(lr=lr), seq)
    jb0 = {k: jnp.asarray(v) for k, v in jbatch(text, 0).items()}
    jrun = compiled(jstep, jstate["params"], jstate["opt"], jb0)
    for step in range(3):
        b = jbatch(text, step)
        jp, jo, jm = jrun(jstate["params"], jstate["opt"],
                          {k: jnp.asarray(v) for k, v in b.items()})
        jstate = {"params": jp, "opt": jo}
        tp, to, tm = tstep(tstate["params"], tstate["opt"], torch_batch(b))
        tstate = {"params": tp, "opt": to}
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            LOSS_TOL * float(jm["loss"]), step
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"]), step
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    for path, (err, scale) in leaf_errors(
            {"params": tstate["params"], "master": tstate["opt"]["master"],
             "mu": tstate["opt"]["mu"], "nu": tstate["opt"]["nu"]},
            {"params": jstate["params"], "master": jstate["opt"]["master"],
             "mu": jstate["opt"]["mu"], "nu": jstate["opt"]["nu"]}).items():
        bound = GRAD_TOL * scale
        if path.startswith(("params/", "master/")):
            bound = max(bound, 0.1 * lr)
        assert err <= bound, (path, err, scale)


def test_vocab_chunk_for_matches_reference():
    for arch in list_configs():
        for seq in (128, 2048, 4096, 32768):
            cfg = get_config(arch)
            assert tsteps.vocab_chunk_for(tconfigs.get_config(arch), seq) \
                == jsteps.vocab_chunk_for(cfg, seq), (arch, seq)
    assert tsteps.vocab_chunk_for(tconfigs.get_config("smollm-360m"),
                                  128) == 0


def test_prefill_and_serve_steps_match_reference():
    jcfg, tcfg = configs("tinyllama-1.1b")
    npw = weights("tinyllama-1.1b")
    jp = jax.tree.map(jnp.asarray, npw)
    tp = lm_params_from_numpy(npw, "cpu", tcfg)
    batch = modality_batch(jcfg, 2, 8, seed=4)
    jb = {"tokens": jnp.asarray(batch["tokens"])}
    want = compiled(jsteps.make_prefill_step(jcfg), jp, jb)(jp, jb)
    got = tsteps.make_prefill_step(tcfg)(
        tp, {"tokens": torch.from_numpy(batch["tokens"])})
    assert got.shape == want.shape == (2, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    cache = tlm.init_cache(tcfg, 2, 4, dtype=torch.float32, device="cpu")
    tok = torch.from_numpy(batch["tokens"][:, :1])
    logits, new_cache = tsteps.make_serve_step(tcfg)(tp, cache, tok)
    want_logits, want_cache = tlm.decode_step(tp, cache, tok, tcfg)
    assert torch.equal(logits, want_logits)
    assert int(new_cache["pos"]) == 1 and int(want_cache["pos"]) == 1


# ---------------------------------------------------------------------------
# The driver: the reference's tests/test_train_e2e.py (train side)
# ---------------------------------------------------------------------------

@pytest.fixture
def reference_weights(monkeypatch):
    """The port's driver starts from the reference driver's initial
    weights (``init_lm`` under ``PRNGKey(--seed)``)."""
    def init_lm(generator, cfg, device="cuda"):
        arch = cfg.name.removesuffix("-smoke")
        jcfg = dataclasses.replace(smoke_variant(arch),
                                   quant_scheme=cfg.quant_scheme,
                                   max_seq=cfg.max_seq)
        seed = int(generator.initial_seed())
        npw = jax.tree.map(np.asarray,
                           jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
        return lm_params_from_numpy(npw, device, cfg)
    monkeypatch.setattr(tlm, "init_lm", init_lm)


def follows(got, want, tol=1e-2):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), (got, want)


def test_train_loss_decreases(tmp_path, reference_weights):
    args = ["--arch", "smollm-360m", "--smoke", "--steps", "30",
            "--batch", "8", "--seq", "64", "--lr", "2e-3",
            "--ckpt-every", "10"]
    losses = ttrain.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    assert len(losses) == 30
    # planted bigram structure is learnable: clear loss drop
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])
    follows(losses, jtrain.main(args + ["--ckpt-dir",
                                        str(tmp_path / "ref")]))


def test_train_restart_resumes(tmp_path, reference_weights):
    args = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "4",
            "--seq", "32", "--ckpt-every", "5"]
    first = ttrain.main(args + ["--steps", "10", "--device", "cpu",
                                "--ckpt-dir", str(tmp_path / "port")])
    assert len(first) == 10
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    # resume: only the remaining steps (10 already checkpointed), from the
    # port's checkpoint in both drivers
    losses = ttrain.main(args + ["--steps", "12", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path / "port")])
    assert len(losses) == 2                   # 10 -> 12
    want = jtrain.main(args + ["--steps", "12",
                               "--ckpt-dir", str(tmp_path / "ref")])
    assert len(want) == 2
    follows(losses, want)


def test_qat_training_runs(tmp_path, reference_weights):
    args = ["--arch", "smollm-360m", "--smoke", "--steps", "10",
            "--batch", "4", "--seq", "32", "--quant", "w4a4"]
    losses = ttrain.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    assert len(losses) == 10 and all(np.isfinite(l) for l in losses)
    follows(losses, jtrain.main(args + ["--ckpt-dir",
                                        str(tmp_path / "ref")]))


def test_crash_and_restart_equals_the_uninterrupted_run(tmp_path):
    args = ["--arch", "hymba-1.5b", "--smoke", "--steps", "8", "--batch",
            "2", "--seq", "16", "--ckpt-every", "3", "--device", "cpu"]
    ref = ttrain.train(args + ["--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        ttrain.train(args + ["--ckpt-dir", str(tmp_path / "run"),
                             "--fail-at", "5"])
    resumed = ttrain.train(args + ["--ckpt-dir", str(tmp_path / "run")])
    assert (resumed.first_step, resumed.last_step) == (3, 8)
    assert resumed.losses == ref.losses[3:]
    want = dict(tree_flatten_with_paths(ref.state))
    for path, leaf in tree_flatten_with_paths(resumed.state):
        assert torch.equal(leaf, want[path]), path


def test_train_lm_100m_config_and_wiring(monkeypatch, tmp_path):
    from repro_torch.configs import base
    from repro_torch.examples import train_lm_100m
    cfg, smoke = train_lm_100m.config_100m()
    want = dataclasses.replace(
        get_config("smollm-360m"), name="smollm-100m", n_layers=12,
        d_model=768, n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
        vocab=8192, remat="none", max_seq=512)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert tlm.count_params(cfg) == jlm.count_params(want) == 81_808_128
    # the wiring at a narrow width (the 100M run is the card's), registered
    # for the run only
    monkeypatch.setattr(base, "_REGISTRY", dict(base._REGISTRY))
    monkeypatch.setattr(base, "_SMOKE", dict(base._SMOKE))
    narrow = dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, head_dim=16, d_ff=128,
                                 vocab=256)
    monkeypatch.setattr(train_lm_100m, "config_100m",
                        lambda: (narrow, narrow))
    run = train_lm_100m.run(["--steps", "12", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    assert run.cfg.name == "smollm-100m" and len(run.losses) == 12
    assert np.mean(run.losses[-10:]) < np.mean(run.losses[:10])
