"""repro_torch's LM configs, accounting, inputs and param trees against the
JAX reference, on the CPU.

* every registered config, FULL and SMOKE, equals the reference's field by
  field (``dataclasses.asdict``), and ``quant_spec`` names the same
  [W:A] spec;
* ``count_params``, ``active_params`` and ``model_flops`` equal the
  reference's for every config (integers and exact float products);
* ``modality_batch`` gives the reference's arrays (numpy, bitwise);
* the tree helpers agree with ``repro.nn.module``'s on one tree, the
  reference's int4 carriers arrive as int8 values with the same
  ``tree_bytes`` (ml_dtypes stores an int4 in a byte), and ``KeyGen``
  hands out the same generators for the same seed, other ones for
  another.

Everything here is exact: no tolerance.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.quant import W4A4 as JW4A4
from repro.data.synthetic import modality_batch as jmodality_batch
from repro.models import lm as jlm
from repro.nn import module as jmodule
from repro_torch import configs as tconfigs
from repro_torch.data.synthetic import modality_batch
from repro_torch.models import lm as tlm
from repro_torch.nn import module as tmodule
from repro_torch.weights import lm_params_from_numpy, lm_params_to_numpy

ARCHS = jconfigs.list_configs()
FLOP_CASES = [(4096, 8, True, False), (32768, 1, False, True),
              (524288, 2, False, False), (1, 4, False, True)]


def test_registries_list_the_same_architectures():
    assert tconfigs.list_configs() == ARCHS
    assert len(ARCHS) == 10
    assert tconfigs.vision_cnns.__all__ == jconfigs.vision_cnns.__all__
    assert sorted(tconfigs.vision_cnns.VISION_MODELS) == \
        sorted(jconfigs.vision_cnns.VISION_MODELS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_equals_reference_field_by_field(arch, variant):
    get = {"full": (tconfigs.get_config, jconfigs.get_config),
           "smoke": (tconfigs.smoke_variant, jconfigs.smoke_variant)}
    t, j = (f(arch) for f in get[variant])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("attn_dim", "kv_dim", "d_inner", "ssm_heads", "conv_dim"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for scheme in ("none", "w4a4", "w3a4", "w2a4"):
        ts = dataclasses.replace(t, quant_scheme=scheme).quant_spec()
        js = dataclasses.replace(j, quant_scheme=scheme).quant_spec()
        assert (ts is None) == (js is None)
        if ts is not None:
            assert (ts.w_bits, ts.a_bits, ts.per_channel, ts.mr_noise_std,
                    ts.w_qmax) == (js.w_bits, js.a_bits, js.per_channel,
                                   js.mr_noise_std, js.w_qmax)


def test_unknown_arch_raises_like_the_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_accounting_equals_reference(arch, variant):
    t = (tconfigs.get_config if variant == "full"
         else tconfigs.smoke_variant)(arch)
    j = (jconfigs.get_config if variant == "full"
         else jconfigs.smoke_variant)(arch)
    assert tlm.count_params(t) == jlm.count_params(j)
    assert tlm.active_params(t) == jlm.active_params(j)
    for seq, batch, train, decode in FLOP_CASES:
        assert tlm.model_flops(t, seq, batch, train, decode) == \
            jlm.model_flops(j, seq, batch, train, decode)


def test_published_sizes_of_the_two_served_configs():
    """The two configs the card serves at full width and depth."""
    tiny, mamba = (tconfigs.get_config("tinyllama-1.1b"),
                   tconfigs.get_config("mamba2-1.3b"))
    assert (tiny.n_layers, tiny.d_model, tiny.n_heads, tiny.n_kv_heads,
            tiny.d_ff, tiny.vocab, tiny.tie_embeddings) == \
        (22, 2048, 32, 4, 5632, 32000, False)
    assert (mamba.n_layers, mamba.d_model, mamba.ssm_state, mamba.vocab) == \
        (48, 2048, 128, 50280)
    assert 1.0e9 < tlm.count_params(tiny) < 1.2e9
    assert 1.3e9 < tlm.count_params(mamba) < 1.4e9


@pytest.mark.parametrize("arch", ARCHS)
def test_modality_batch_equals_reference(arch):
    cfg = tconfigs.smoke_variant(arch)
    t = modality_batch(cfg, 2, 24, seed=5)
    j = jmodality_batch(jconfigs.smoke_variant(arch), 2, 24, seed=5)
    assert sorted(t) == sorted(j)
    for k in t:
        assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k


def _reference_tree():
    cfg = jconfigs.smoke_variant("hymba-1.5b")
    params = jlm.init_lm(jax.random.PRNGKey(0), cfg)
    return cfg, params, jlm.quantize_lm_params(params, cfg, JW4A4)


def test_tree_helpers_agree_with_reference():
    """tree_size, tree_bytes and the flattened paths, in JAX's order; the
    reference's int4 carriers arrive as int8 with the same values and the
    same tree_bytes; cast_tree leaves integers alone."""
    jcfg, jparams, jq = _reference_tree()
    tcfg = tconfigs.smoke_variant("hymba-1.5b")
    for tree in (jparams, jq):
        ttree = lm_params_from_numpy(jax.tree.map(np.asarray, tree), "cpu",
                                     tcfg)
        assert tmodule.tree_size(ttree) == jmodule.tree_size(tree)
        assert tmodule.tree_bytes(ttree) == jmodule.tree_bytes(tree)
        jflat = list(jmodule.tree_flatten_with_paths(tree))
        tflat = list(tmodule.tree_flatten_with_paths(ttree))
        assert [n for n, _ in tflat] == [n for n, _ in jflat]
        for (name, t), (_, j) in zip(tflat, jflat):
            assert tuple(t.shape) == j.shape, name
            jn = np.asarray(j)
            if jn.dtype.name.startswith("int"):
                assert t.dtype == torch.int8, name
                assert np.array_equal(t.numpy(), jn.astype(np.int8)), name
            else:
                assert str(t.dtype).endswith(jn.dtype.name), name
                assert np.array_equal(t.float().numpy(),
                                      jn.astype(np.float32)), name
    assert str(np.asarray(jq["layers"]["attn"]["wq"]["wq"]).dtype) == "int4"
    back = lm_params_to_numpy(ttree)
    assert back["layers"]["attn"]["wq"]["wq"].dtype == np.int8
    assert back["layers"]["attn"]["wq"]["ws"].dtype == np.float32
    cast = tmodule.cast_tree(ttree, torch.float32)
    assert cast["layers"]["attn"]["wq"]["wq"].dtype == torch.int8
    assert cast["embed"]["table"].dtype == torch.float32
    stacked = tmodule.stack_layer_params(
        [{"a": {"w": torch.full((2,), float(i))}} for i in range(3)])
    assert torch.equal(stacked["a"]["w"],
                       torch.tensor([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]))
    jstacked = jmodule.stack_layer_params(
        [{"a": {"w": jnp.full((2,), float(i))}} for i in range(3)])
    assert np.array_equal(stacked["a"]["w"].numpy(),
                          np.asarray(jstacked["a"]["w"]))


def test_keygen_is_deterministic_and_splits():
    def draws(seed):
        kg = tmodule.KeyGen(seed)
        return [torch.randn(4, generator=kg()) for _ in range(3)]
    a, b, c = draws(7), draws(7), draws(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], a[1])
    # from a generator: its state picks the seed, and advances it
    def first(g):
        return torch.randn(4, generator=tmodule.KeyGen(g)())
    g = torch.Generator().manual_seed(3)
    assert not torch.equal(first(g), first(g))
    assert torch.equal(first(torch.Generator().manual_seed(3)),
                       first(torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_moe_weights_round_trip_bitwise(arch):
    """The reference's bf16 MoE tree, float and in W4A4 storage, numpy ->
    port -> numpy bitwise: the router float32 under bf16, the stacked
    experts [L, E, d, f] as they were, the storage dicts {wq, ws} carried
    (int4 levels as int8 values, scales float32)."""
    jcfg = jconfigs.smoke_variant(arch)
    tcfg = tconfigs.smoke_variant(arch)
    jparams = jlm.init_lm(jax.random.PRNGKey(2), jcfg)
    jq = jlm.quantize_lm_params(jparams, jcfg, JW4A4)
    for tree in (jparams, jq):
        npw = jax.tree.map(np.asarray, tree)
        ttree = lm_params_from_numpy(npw, "cpu", tcfg)
        moe = ttree["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        back = lm_params_to_numpy(ttree)
        jflat = jax.tree_util.tree_flatten_with_path(npw)[0]
        assert len(jflat) == len(list(tmodule.tree_flatten_with_paths(back)))
        for path, want in jflat:
            got = back
            for p in path:
                got = got[p.key]
            if want.dtype.name.startswith("int"):
                assert got.dtype == np.int8
                assert np.array_equal(got, want.astype(np.int8)), path
            else:
                assert got.shape == want.shape, path
                assert np.array_equal(got.view(np.uint32),
                                      want.astype(np.float32).view(
                                          np.uint32)), path
    assert moe["w_gate"]["wq"].shape == (jcfg.n_layers, jcfg.n_experts,
                                         jcfg.d_model, jcfg.d_ff)
    assert moe["w_gate"]["ws"].shape == (jcfg.n_layers, jcfg.n_experts, 1,
                                         jcfg.d_ff)
    assert str(np.asarray(jq["layers"]["moe"]["w_down"]["wq"]).dtype) == \
        "int4"
