"""repro_torch's greedy decode (``models/lm.py::greedy_generate``) against
the JAX reference, and the port's prefill against its decode, on the CPU.

* ``greedy_generate`` for every decoder smoke arch, float32,
  under quant ``none`` and ``w4a4``: the reference's ``init_lm`` weights
  carried by ``lm_params_from_numpy``, a 6-token prompt from a seed, 5
  tokens generated. The reference's ``greedy_generate`` jits its step with
  XLA's algebraic simplifier on (it turns the fake-quant's division by
  the 1/15 step into a reciprocal multiply), so its loop is written out
  here around its ``decode_step`` compiled with the simplifier off and
  without excess precision, from the bf16 cache its ``greedy_generate``
  makes (as the port's). The port's ``decode_step``, fed the reference's
  tokens, gives each step's logits within 2e-2 of the largest |logit|
  (the bf16 cache rounds k and v, and a float32 ulp between the two
  packages can round to the other bf16 neighbour, 2^-8). The port's
  tokens then equal the reference's up to the first step whose top-2
  margin is within twice that step's measured difference, where an
  argmax could rightly go either way. Ties in the argmax go to the
  lowest id in both libraries.
* prefill against decode in the port: teacher-forced ``lm_forward``
  logits equal the stepped ``decode_step`` logits within the reference
  test's rtol = atol = 5e-2 (``test_models_smoke.py``), bf16 configs
  (the archs whose forward takes tokens alone: the vlm's needs patches;
  the MoE archs where their forward drops no slot);
  and in bf16 the port's gap is the reference's own on the same weights.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_configs, smoke_variant
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.weights import lm_params_from_numpy

OPTS = {"xla_disable_hlo_passes": "algsimp",
        "xla_allow_excess_precision": False}
TOL = 2e-2
DECODERS = [a for a in list_configs()
            if get_config(a).family != "encoder"]
PROMPT, GEN = 6, 5


def configs(arch, dtype, quant="none"):
    kw = dict(dtype=dtype, quant_scheme=quant)
    return (dataclasses.replace(smoke_variant(arch), **kw),
            dataclasses.replace(tconfigs.smoke_variant(arch), **kw))


def reference_greedy(jp, jcfg, prompt, steps):
    """The reference's greedy_generate loop with its decode_step compiled
    under ``OPTS`` (once per cache signature: a float32 run's conv cache
    turns float32 after its first step, as in the reference's jit).
    Returns the tokens and the logits each step's argmax was taken of."""
    cache = jlm.init_cache(jcfg, prompt.shape[0],
                           prompt.shape[1] + steps + 1)
    steps_by_sig = {}

    def step(c, t):
        sig = tuple((x.shape, x.dtype) for x in jax.tree.leaves(c))
        if sig not in steps_by_sig:
            steps_by_sig[sig] = jax.jit(
                lambda p, c, t: jlm.decode_step(p, c, t, jcfg)).lower(
                jp, c, t).compile(compiler_options=OPTS)
        return steps_by_sig[sig](jp, c, t)

    toks = jnp.asarray(prompt)
    for i in range(prompt.shape[1]):
        logits, cache = step(cache, toks[:, i:i + 1])
    seen = []
    for _ in range(steps):
        seen.append(np.asarray(logits, np.float32))
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks = jnp.concatenate([toks, nxt], 1)
        logits, cache = step(cache, nxt)
    return np.asarray(toks), seen


@pytest.mark.parametrize("quant", ["none", "w4a4"])
@pytest.mark.parametrize("arch", DECODERS)
def test_greedy_generate_against_reference(arch, quant):
    jcfg, tcfg = configs(arch, "float32", quant)
    jp = jlm.init_lm(jax.random.PRNGKey(len(arch)), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", tcfg)
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    want, ref_logits = reference_greedy(jp, jcfg, prompt, GEN)
    # the port's steps along the reference's tokens
    cache = tlm.init_cache(tcfg, 2, PROMPT + GEN + 1, device="cpu")
    ids = torch.from_numpy(want.copy())
    for i in range(PROMPT + GEN - 1):
        logits, cache = tlm.decode_step(tp, cache, ids[:, i:i + 1], tcfg)
        if i >= PROMPT - 1:
            ref = ref_logits[i - PROMPT + 1]
            diff = float(np.max(np.abs(logits.numpy() - ref)))
            assert diff <= TOL * np.max(np.abs(ref)), (i, diff)
            top2 = np.sort(ref, -1)[:, -2:]
            if np.min(top2[:, 1] - top2[:, 0]) <= 2 * diff:
                n = i - PROMPT + 1
                break
    else:
        n = GEN
    got = tlm.greedy_generate(tp, tcfg, torch.from_numpy(prompt), GEN)
    assert got.dtype == torch.int32 and got.shape == (2, PROMPT + GEN)
    assert n >= 1
    assert np.array_equal(got.numpy()[:, :PROMPT + n], want[:, :PROMPT + n])


def test_argmax_ties_go_to_the_lowest_id_in_both():
    row = np.array([[0.5, 2.0, 1.0, 2.0, 2.0]], np.float32)
    assert int(torch.argmax(torch.from_numpy(row), -1)[0]) == \
        int(jnp.argmax(jnp.asarray(row), -1)[0]) == 1


def prefill_and_decode(tcfg):
    """The port's teacher-forced forward over an 8-token prompt and its
    stepped decode: (forward logits, its aux, decode logits)."""
    tp = tlm.init_lm(torch.Generator().manual_seed(1), tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (1, 8)).astype(np.int32))
    logits, aux = tlm.lm_forward(tp, {"tokens": toks}, tcfg)
    cache = tlm.init_cache(tcfg, 1, 16, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = tlm.decode_step(tp, cache, toks[:, i:i + 1], tcfg)
        outs.append(lg)
    return logits.float(), aux, torch.stack(outs, 1).float()


@pytest.mark.parametrize("arch", [a for a in DECODERS
                                  if get_config(a).frontend == "none"
                                  and get_config(a).family != "moe"])
def test_prefill_matches_decode_in_the_port(arch):
    logits, _, decoded = prefill_and_decode(configs(arch, "bfloat16")[1])
    assert torch.allclose(decoded, logits, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", [a for a in DECODERS
                                  if get_config(a).family == "moe"])
def test_moe_prefill_matches_decode_where_nothing_drops(arch):
    """The MoE forward routes the 8 prompt tokens through capacity-bounded
    experts at once, the decode one token at a time. With a capacity
    factor of E nothing drops, and the two agree as the other families'
    do; at the smoke config's own factor kimi-k2's forward drops slots, so
    the two paths route differently by design (not held)."""
    cfg = configs(arch, "bfloat16")[1]
    roomy = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    logits, aux, decoded = prefill_and_decode(roomy)
    assert float(aux["dropped"]) == 0.0
    assert torch.allclose(decoded, logits, rtol=5e-2, atol=5e-2)
    if arch.startswith("kimi"):
        assert float(prefill_and_decode(cfg)[1]["dropped"]) > 0.0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b"])
def test_prefill_decode_gap_in_bf16_is_the_reference_s(arch):
    """In bfloat16 the gap between the prefill's logits and the stepped
    decode's is the reference's own: on the reference's weights and one
    prompt (batch 4, 8 tokens), the port's max |decode - prefill| equals
    the reference's within 2e-2 of the largest |logit| (a bf16 ulp is
    2^-8), and each path's logits equal the reference's within that. The
    two paths sum their GEMMs in other shapes, so bf16 rounds them apart
    in both packages alike."""
    jcfg, tcfg = configs(arch, "bfloat16")
    jp = jlm.init_lm(jax.random.PRNGKey(len(arch)), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", tcfg)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab, (4, 8)).astype(np.int32)
    jfwd = np.asarray(jax.jit(
        lambda p, t: jlm.lm_forward(p, {"tokens": t}, jcfg)[0]).lower(
        jp, toks).compile(compiler_options=OPTS)(jp, toks), np.float32)
    cache = jlm.init_cache(jcfg, 4, 16)
    step = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg)).lower(
        jp, cache, toks[:, :1]).compile(compiler_options=OPTS)
    jdec = []
    for i in range(8):
        logits, cache = step(jp, cache, toks[:, i:i + 1])
        jdec.append(np.asarray(logits, np.float32))
    jdec = np.stack(jdec, 1)
    tfwd = tlm.lm_forward(tp, {"tokens": torch.from_numpy(toks)},
                          tcfg)[0].float().numpy()
    tcache = tlm.init_cache(tcfg, 4, 16, device="cpu")
    tdec = []
    for i in range(8):
        logits, tcache = tlm.decode_step(
            tp, tcache, torch.from_numpy(toks[:, i:i + 1]), tcfg)
        tdec.append(logits.float().numpy())
    tdec = np.stack(tdec, 1)
    bound = TOL * np.max(np.abs(jfwd))
    assert np.max(np.abs(tfwd - jfwd)) <= bound
    assert np.max(np.abs(tdec - jdec)) <= bound
    ref_gap = np.max(np.abs(jdec - jfwd))
    assert ref_gap > 0
    assert abs(np.max(np.abs(tdec - tfwd)) - ref_gap) <= bound
