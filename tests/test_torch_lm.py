"""repro_torch's LM (``models/lm.py``) against the JAX reference, on the
CPU, for every smoke architecture.

The reference's ``init_lm`` weights (its own PRNG) are carried to the port
by ``lm_params_from_numpy``; the inputs come from ``modality_batch`` with
a seed. Every arch in float32 under quant ``none`` and ``w4a4``
(fake-quant), and one arch of each family (``FAMILY_ARCHS``) also in the
configs' own bfloat16 under ``none``; the MoE archs' smoke variants
dispatch ``sorted``, and run again under ``grouped`` (their FULL
configs' dispatch) in float32:

* ``lm_forward``'s logits and aux (the MoE balance and z losses within
  the run's tolerance of the reference's, relative; the dropped fraction
  equal; 0 for the other families), and ``lm_loss`` (quant ``none``,
  compiled with the forward; with a loss mask and in vocab chunks on one
  arch);
* three ``decode_step``s from an empty cache, logits and cache;
* ``quantize_lm_params``: ``wq`` equal, ``ws`` bitwise, and the forward
  through that storage;
* ``init_lm``'s shapes, dtypes and per-leaf spread against the
  reference's (the MoE router float32 under bfloat16).

``greedy_generate`` and the prefill-against-decode check are in
``test_torch_lm_generate.py``.

The reference runs compiled with XLA's algebraic simplifier off (under
``jit`` it turns the fake-quant's division by the 1/15 step into a
reciprocal multiply, which the port and the eager reference do not do)
and without excess precision (which lets XLA skip a bf16 rounding its code
asks for, e.g. of ``silu(gate) * up`` before the next fake-quant).

Tolerances, against the largest |logit| of the reference: float32 within
2e-5 (sums in another order), bfloat16 within 2e-2 (a bf16 ulp is 2^-8).
Decode runs keep their KV caches in the run's dtype (the default bf16
cache would turn a float32 ulp of k or v into a bf16 ulp on one side
only). bfloat16 under ``w4a4`` is not held: XLA's CPU dot sums a
16-wide output's products in another order than PyTorch's, and a
float32 sum an ulp apart can round to the other bf16 neighbour, which
moves the next layer's CRC code a whole step (smollm's 16-wide ``wv``:
6.5e-2 of the largest logit two steps on). The same runs are held in
float32, where an ulp is 2^16 times finer than the bf16 step. Each
(arch, dtype, quant) compiles the reference's forward and decode step
once; the bfloat16 runs are kept to one arch a family because those
compiles are most of this file's time.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_configs, smoke_variant
from repro.core.quant import W4A4 as JW4A4
from repro.data.synthetic import modality_batch
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.core.quant import W4A4
from repro_torch.models import lm as tlm
from repro_torch.nn.module import tree_leaves
from repro_torch.weights import lm_params_from_numpy, lm_params_to_numpy

OPTS = {"xla_disable_hlo_passes": "algsimp",
        "xla_allow_excess_precision": False}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCHS = list_configs()
DECODERS = [a for a in ARCHS if get_config(a).family != "encoder"]
MOE = [a for a in ARCHS if get_config(a).family == "moe"]
# one arch of each family: dense, ssm, hybrid, encoder, vlm, moe
FAMILY_ARCHS = ["tinyllama-1.1b", "mamba2-1.3b", "hymba-1.5b",
                "hubert-xlarge", "internvl2-26b", "grok-1-314b"]
CASES = [(a, d, q) for a in ARCHS
         for d, q in (("float32", "none"), ("float32", "w4a4"),
                      ("bfloat16", "none"))
         if d == "float32" or a in FAMILY_ARCHS]


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)


def configs(arch, dtype="bfloat16", quant="none", dispatch=None):
    kw = dict(dtype=dtype, quant_scheme=quant)
    if dispatch is not None:
        kw["moe_dispatch"] = dispatch
    return (dataclasses.replace(smoke_variant(arch), **kw),
            dataclasses.replace(tconfigs.smoke_variant(arch), **kw))


@functools.lru_cache(maxsize=None)
def weights(arch, dtype):
    """The reference's init_lm weights as numpy (bf16 as ml_dtypes)."""
    jcfg, _ = configs(arch, dtype)
    return jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.PRNGKey(len(arch)), jcfg))


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@functools.lru_cache(maxsize=None)
def run(arch, dtype, quant, dispatch=None):
    """Both packages on the same weights and inputs: forward and (quant
    none) loss from one compile, three decode steps with caches of the
    run's dtype."""
    jcfg, tcfg = configs(arch, dtype, quant, dispatch)
    npw = weights(arch, dtype)
    jp = jax.tree.map(jnp.asarray, npw)
    tp = lm_params_from_numpy(npw, "cpu", tcfg)
    batch = modality_batch(jcfg, 2, 16, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if quant == "none":
        jfwd, jloss = compiled(lambda p, b: (jlm.lm_forward(p, b, jcfg),
                                             jlm.lm_loss(p, b, jcfg)),
                               jp, jb)(jp, jb)
        out = {"loss": (jloss, tlm.lm_loss(tp, tb, tcfg))}
    else:
        jfwd = compiled(lambda p, b: jlm.lm_forward(p, b, jcfg),
                        jp, jb)(jp, jb)
        out = {}
    out["fwd"] = (jfwd, tlm.lm_forward(tp, tb, tcfg))
    if jcfg.family != "encoder":
        cdt = getattr(jnp, dtype)
        jc = jlm.init_cache(jcfg, 2, 8, dtype=cdt)
        tc = tlm.init_cache(tcfg, 2, 8, dtype=getattr(torch, dtype),
                            device="cpu")
        tok = np.asarray(batch["tokens"][:, :1])
        step = compiled(lambda p, c, t: jlm.decode_step(p, c, t, jcfg),
                        jp, jc, jnp.asarray(tok))
        steps = []
        for _ in range(3):
            jl, jc = step(jp, jc, jnp.asarray(tok))
            tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(tok), tcfg)
            steps.append((jl, tl))
            tok = np.asarray(jnp.argmax(jl, -1)[:, None]).astype(np.int32)
        out["decode"] = (steps, jc, tc)
    return out


def assert_forward_close(fwd, arch, dtype):
    (jlogits, jaux), (tlogits, taux) = fwd
    assert tlogits.dtype == getattr(torch, dtype)
    assert rel_err(tlogits, jlogits) <= TOL[dtype]
    assert float(taux["dropped"]) == float(jaux["dropped"])
    for k in ("balance", "z"):
        if arch in MOE:
            assert float(jaux[k]) > 0
            assert abs(float(taux[k]) - float(jaux[k])) <= \
                TOL[dtype] * float(jaux[k])
        else:
            assert float(taux[k]) == float(jaux[k]) == 0.0


@pytest.mark.parametrize("arch,dtype,quant", CASES)
def test_forward_against_reference(arch, dtype, quant):
    assert_forward_close(run(arch, dtype, quant)["fwd"], arch, dtype)


def assert_loss_close(got, want, dtype):
    (tloss, tm), (jloss, jm) = got, want
    assert abs(float(tloss) - float(jloss)) <= TOL[dtype] * float(jloss)
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= \
        TOL[dtype] * float(jm["ce"])
    assert sorted(tm) == sorted(jm)


@pytest.mark.parametrize("arch,dtype", [(a, d) for a, d, q in CASES
                                        if q == "none"])
def test_loss_against_reference(arch, dtype):
    """lm_loss (quant none), the mean CE; relative to the loss, the run's
    tolerance."""
    jloss, tloss = run(arch, dtype, "none")["loss"]
    assert_loss_close(tloss, jloss, dtype)


@pytest.mark.parametrize("mask,vocab_chunk", [("mask", 0), (None, 4),
                                              ("mask", 4)])
def test_loss_masked_and_chunked_against_reference(mask, vocab_chunk):
    """lm_loss with a loss mask and in vocab chunks (tinyllama, float32);
    relative to the loss, float32's tolerance."""
    arch, dtype = "tinyllama-1.1b", "float32"
    jcfg, tcfg = configs(arch, dtype)
    npw = weights(arch, dtype)
    batch = modality_batch(jcfg, 2, 16, seed=1)
    if mask:
        batch["loss_mask"] = (np.arange(batch["labels"].shape[1])[None]
                              % 3 != 0).astype(np.float32).repeat(2, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, npw)
    want = compiled(lambda p, b: jlm.lm_loss(p, b, jcfg, vocab_chunk),
                    jp, jb)(jp, jb)
    got = tlm.lm_loss(lm_params_from_numpy(npw, "cpu", tcfg),
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      tcfg, vocab_chunk)
    assert_loss_close(got, want, dtype)


def assert_decode_close(decode, dtype):
    steps, jc, tc = decode
    for jl, tl in steps:
        assert rel_err(tl, jl) <= TOL[dtype]
    assert int(tc["pos"]) == int(jc["pos"]) == 3
    assert tc["pos"].dtype == torch.int32
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc["layers"])[0]:
        t = tc["layers"]
        for p in path:
            t = t[p.key]
        assert str(t.dtype).endswith(jnp.dtype(leaf.dtype).name), path
        assert rel_err(t, leaf) <= TOL[dtype], path


@pytest.mark.parametrize("arch,dtype,quant", [c for c in CASES
                                              if c[0] in DECODERS])
def test_decode_steps_against_reference(arch, dtype, quant):
    assert_decode_close(run(arch, dtype, quant)["decode"], dtype)


@pytest.mark.parametrize("arch", MOE)
def test_moe_grouped_dispatch_against_reference(arch):
    """The MoE archs under the grouped dispatch their FULL configs use
    (each batch row its own capacity), float32, quant none: forward and
    aux, loss, three decode steps (W4A4 under it: ``test_torch_moe.py``)."""
    out = run(arch, "float32", "none", "grouped")
    assert_forward_close(out["fwd"], arch, "float32")
    jloss, tloss = out["loss"]
    assert_loss_close(tloss, jloss, "float32")
    assert_decode_close(out["decode"], "float32")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "hymba-1.5b", "internvl2-26b"] + MOE)
def test_quantize_lm_params_against_reference(arch):
    """W4A4 storage: the int levels equal (the reference's int4 carrier as
    int8 values), the scales bitwise, every other leaf untouched (the MoE
    router float32); the MoE's stacked experts become {wq, ws} with one
    scale per (layer, expert, out-channel); and the forward through that
    storage (weights dequantized in the activations' dtype) against the
    reference's, bf16 tolerance."""
    jcfg, tcfg = configs(arch)
    npw = weights(arch, "bfloat16")
    jq = jlm.quantize_lm_params(jax.tree.map(jnp.asarray, npw), jcfg, JW4A4)
    tq = tlm.quantize_lm_params(lm_params_from_numpy(npw, "cpu", tcfg),
                                tcfg, W4A4)
    jflat = jax.tree_util.tree_flatten_with_path(jq)[0]
    tflat = lm_params_to_numpy(tq)
    n_wq = 0
    for path, leaf in jflat:
        t = tflat
        for p in path:
            t = t[p.key]
        want = np.asarray(leaf)
        if path[-1].key == "wq":
            n_wq += 1
            assert t.dtype == np.int8 and str(want.dtype) == "int4"
            assert np.array_equal(t, want.astype(np.int8)), path
        elif path[-1].key == "ws":
            assert t.dtype == np.float32 and want.dtype == np.float32
            assert np.array_equal(t.view(np.uint32), want.view(np.uint32))
        else:
            assert np.array_equal(t, want.astype(np.float32)), path
    assert n_wq > 0
    batch = modality_batch(jcfg, 2, 16, seed=1)
    jl, _ = compiled(lambda p, b: jlm.lm_forward(p, b, jcfg), jq, {
        k: jnp.asarray(v) for k, v in batch.items()})(
        jq, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tlm.lm_forward(tq, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, tcfg)
    assert rel_err(tl, jl) <= TOL["bfloat16"]


def test_decode_leaves_the_cache_passed_in_and_clamps_past_the_end():
    """decode_step returns a new cache; a full non-ring KV cache keeps
    writing its last slot, as the reference's clamped update."""
    _, tcfg = configs("tinyllama-1.1b", "float32")
    tp = lm_params_from_numpy(weights("tinyllama-1.1b", "float32"), "cpu",
                              tcfg)
    cache = tlm.init_cache(tcfg, 1, 2, dtype=torch.float32, device="cpu")
    tok = torch.ones((1, 1), dtype=torch.int32)
    _, c1 = tlm.decode_step(tp, cache, tok, tcfg)
    assert int(cache["pos"]) == 0 and not cache["layers"]["kv"]["k"].any()
    _, c2 = tlm.decode_step(tp, c1, tok, tcfg)
    _, c3 = tlm.decode_step(tp, c2, tok * 2, tcfg)
    assert int(c3["pos"]) == 3
    k2, k3 = c2["layers"]["kv"]["k"], c3["layers"]["kv"]["k"]
    assert torch.equal(k3[:, :, 0], k2[:, :, 0])
    assert not torch.equal(k3[:, :, 1], k2[:, :, 1])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_tree_and_spread(arch):
    """Eight layers, so each stacked leaf has thousands of draws. Shapes
    and dtypes equal; constant leaves (norm scales, biases, D) equal, and
    A's log(1..H) within an ulp;
    each random leaf's std within 5% of the reference's, or 5 standard
    errors of the ratio of two sample stds (sqrt(1/n)) where a leaf is
    too small for 5%, and its mean within 5 standard errors of 0."""
    kw = dict(n_layers=8)
    jcfg = dataclasses.replace(smoke_variant(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.smoke_variant(arch), **kw)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = tlm.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_leaves = 0
    for path, leaf in jflat:
        t = tp
        for p in path:
            t = t[p.key]
        n_leaves += 1
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).endswith(jnp.dtype(leaf.dtype).name), path
        want = np.asarray(leaf.astype(jnp.float32))
        got = t.float().numpy()
        if path[-1].key == "a_log":
            # log(1..H): XLA's float32 log is an ulp off the correctly
            # rounded value PyTorch gives (ln 7)
            assert np.allclose(got, want, rtol=2.0 ** -23, atol=0), path
            continue
        if np.all(want == want.flat[0]):
            assert np.array_equal(got, want), path
            continue
        n = want.size
        ratio = got.std() / want.std()
        assert abs(ratio - 1) <= max(0.05, 5 * np.sqrt(1.0 / n)), \
            (path, ratio)
        assert abs(got.mean()) <= 5 * want.std() / np.sqrt(n), path
    assert n_leaves == len(tree_leaves(tp))
