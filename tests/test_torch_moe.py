"""repro_torch's Mixture-of-Experts (``nn/moe.py``) against the JAX
reference, on the CPU.

Every case of the reference's ``tests/test_moe.py`` runs on the port (the
dense-oracle headroom cases, drops at a tight capacity, the aux losses,
determinism, gradients flowing, the grouped oracle cases, per-row
capacity), and each also against the reference on the same parameters
(the reference's ``init_moe``, carried as numpy) and the same inputs
(numpy, seeded):

* the expert indices and the slot of every (token, k) pair equal exactly
  (the reference's taken from its own run: its ``jax.lax.top_k`` call, the
  sorted dispatch's ``jnp.take`` indices, the grouped one's
  ``_moe_block`` argument), and both equal a plain rank-within-expert
  walk in numpy;
* the dropped fraction equal exactly; ``y`` in float32 within 1e-5 of its
  largest |y| (the expert matmuls sum in another order); the balance and
  z losses within 1e-6 relative;
* under the W4A4 fake-quant and ``quantize_lm_params`` storage (its
  levels and scales equal), and the grouped dispatch under the three
  ``combine_dtype``s; the float8_e4m3fn cast equal to ml_dtypes' past
  +-448, at every tie and on infinities (PyTorch's own saturates).

The reference runs compiled with XLA's algebraic simplifier off, as the
LM tests compile it: with it on, ``jnp.mean`` multiplies by 1/n, and the
dropped fraction (a count over n) lands an ulp off the quotient. Gradient
*parity* waits for the LM trainer; here they flow (autograd).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.quant import W4A4 as JW4A4
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro_torch.core.quant import W4A4
from repro_torch.models import lm as tlm
from repro_torch.nn import moe as tmoe

OPTS = {"xla_disable_hlo_passes": "algsimp",
        "xla_allow_excess_precision": False}
Y_TOL, AUX_TOL = 1e-5, 1e-6


def _setup(e=4, k=2, d=16, f=32, cf=8.0, seed=0):
    """Both packages' configs and one set of params (the reference's
    ``init_moe``), as (numpy, port tensors)."""
    jcfg = jmoe.MoEConfig(n_experts=e, top_k=k, d_model=d, d_ff=f,
                          capacity_factor=cf)
    tcfg = tmoe.MoEConfig(n_experts=e, top_k=k, d_model=d, d_ff=f,
                          capacity_factor=cf)
    npw = {n: np.array(v) for n, v in
           jmoe.init_moe(jax.random.PRNGKey(seed), jcfg).items()}
    return jcfg, tcfg, npw, {n: torch.from_numpy(v.copy())
                             for n, v in npw.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def reference(fn, params, x, cfg, **kw):
    """The reference's ``moe_ffn`` / ``moe_ffn_grouped`` compiled under
    ``OPTS``; returns (MoEOutput, top_i, slots) of that run: the top-k
    indices of its ``jax.lax.top_k`` call, the slots of its combine
    (the sorted dispatch's ``jnp.take`` indices, the grouped dispatch's
    ``_moe_block`` argument)."""
    def run(p, x):
        seen = {}
        top_k, take, block = jax.lax.top_k, jnp.take, jmoe._moe_block

        def spy_top_k(probs, k):
            seen["top_w"], seen["top_i"] = top_k(probs, k)
            return seen["top_w"], seen["top_i"]

        def spy_take(a, idx, **kwargs):
            seen["slots"] = idx
            return take(a, idx, **kwargs)

        def spy_block(params, x, slots, *rest):
            seen["slots"] = slots
            return block(params, x, slots, *rest)

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(jax.lax, "top_k",
                                                  spy_top_k))
            if fn is jmoe.moe_ffn:
                stack.enter_context(mock.patch.object(jnp, "take", spy_take))
            else:
                stack.enter_context(mock.patch.object(jmoe, "_moe_block",
                                                      spy_block))
            out = fn(p, x, cfg, **kw)
        return out, seen["top_i"], seen["slots"]

    jp = jax.tree.map(jnp.asarray, params)
    jx = jnp.asarray(x)
    out, top_i, slots = jax.jit(run).lower(jp, jx).compile(
        compiler_options=OPTS)(jp, jx)
    return out, np.asarray(top_i), np.asarray(slots)


def port(fn, params, x, cfg, **kw):
    """The port's op; returns (MoEOutput, top_i, slots) of the run."""
    seen = {}
    route, slots_fn = tmoe._route, tmoe._slots

    def spy_route(logits, k):
        probs, top_w, seen["top_i"] = route(logits, k)
        return probs, top_w, seen["top_i"]

    def spy_slots(top_i, e, capacity):
        seen["slots"] = slots_fn(top_i, e, capacity)
        return seen["slots"]

    with mock.patch.object(tmoe, "_route", spy_route), \
            mock.patch.object(tmoe, "_slots", spy_slots):
        out = fn(params, torch.from_numpy(x), cfg, **kw)
    return out, seen["top_i"].numpy(), seen["slots"].numpy()


def plain_slots(rows, e, capacity):
    """Each row's (token, k) slots [G, n] in order: expert * C + the count
    of earlier slots of that expert in the row, or E*C past the
    capacity."""
    out = np.empty(rows.shape, np.int64)
    for g, row in enumerate(rows):
        seen = np.zeros(e, np.int64)
        for i, ex in enumerate(row):
            out[g, i] = ex * capacity + seen[ex] if seen[ex] < capacity \
                else e * capacity
            seen[ex] += 1
    return out


def capacity_of(cfg, x, grouped, capacity=None):
    if capacity is not None:
        return capacity
    b, s, _ = x.shape
    n = s if grouped else b * s
    return max(int(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def assert_matches_reference(tfn, jfn, tparams, jparams, x, tcfg, jcfg,
                             tkw=None, jkw=None, capacity=None):
    """The port's op against the reference's on the same params and x
    (the module docstring's bar); returns the port's output."""
    tkw = dict(tkw or {}, capacity=capacity)
    jkw = dict(jkw or {}, capacity=capacity)
    got, t_top, t_slots = port(tfn, tparams, x, tcfg, **tkw)
    want, j_top, j_slots = reference(jfn, jparams, x, jcfg, **jkw)
    assert np.array_equal(t_top, j_top)
    grouped = tfn is tmoe.moe_ffn_grouped
    cap = capacity_of(tcfg, x, grouped, capacity)
    assert np.array_equal(t_slots.reshape(j_slots.shape), j_slots)
    assert np.array_equal(
        t_slots, plain_slots(t_top.reshape(x.shape[0] if grouped else 1,
                                           -1), tcfg.n_experts, cap))
    assert float(got.dropped_fraction) == float(want.dropped_fraction)
    y = np.asarray(want.y, np.float32)
    assert got.y.dtype == torch.float32 and got.y.shape == y.shape
    assert np.max(np.abs(got.y.numpy() - y)) <= Y_TOL * np.max(np.abs(y))
    for mine, theirs in ((got.balance_loss, want.balance_loss),
                         (got.z_loss, want.z_loss)):
        assert abs(float(mine) - float(theirs)) <= AUX_TOL * float(theirs)
    return got


# ---------------------------------------------------------------------------
# tests/test_moe.py's cases, each also against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 4), (8, 1)])
def test_matches_dense_oracle_with_headroom(e, k):
    """With generous capacity nothing drops -> must equal the oracle."""
    jcfg, tcfg, npw, tp = _setup(e=e, k=k, cf=float(e))
    x = _x((2, 24, 16), 1)
    out = assert_matches_reference(tmoe.moe_ffn, jmoe.moe_ffn, tp, npw, x,
                                   tcfg, jcfg)
    want = tmoe.moe_ffn_dense_oracle(tp, torch.from_numpy(x), tcfg)
    assert float(out.dropped_fraction) == 0.0
    torch.testing.assert_close(out.y, want, rtol=2e-4, atol=2e-4)


def test_capacity_drops_tokens():
    jcfg, tcfg, npw, tp = _setup(cf=8.0)
    x = _x((2, 32, 16), 2)
    out = assert_matches_reference(tmoe.moe_ffn, jmoe.moe_ffn, tp, npw, x,
                                   tcfg, jcfg, capacity=2)   # absurdly tight
    assert float(out.dropped_fraction) > 0.0
    assert bool(torch.isfinite(out.y).all())


def test_aux_losses():
    jcfg, tcfg, npw, tp = _setup()
    x = _x((2, 16, 16), 3)
    out = assert_matches_reference(tmoe.moe_ffn, jmoe.moe_ffn, tp, npw, x,
                                   tcfg, jcfg)
    assert float(out.balance_loss) > 0.0             # ~coef when balanced
    assert float(out.z_loss) >= 0.0
    # a perfectly balanced router would give balance ~= coef * 1.0
    assert float(out.balance_loss) < tcfg.balance_coef * tcfg.n_experts


def test_deterministic():
    _, tcfg, _, tp = _setup()
    x = torch.from_numpy(_x((1, 16, 16), 4))
    y1 = tmoe.moe_ffn(tp, x, tcfg).y
    y2 = tmoe.moe_ffn(tp, x, tcfg).y
    assert torch.equal(y1, y2)


def _grad_norms(tp, loss_fn):
    params = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
    loss_fn(params).backward()
    return {n: float(v.grad.norm()) for n, v in params.items()}


def test_gradients_flow():
    _, tcfg, _, tp = _setup()
    x = torch.from_numpy(_x((1, 16, 16), 5))

    def loss(p):
        out = tmoe.moe_ffn(p, x, tcfg)
        return torch.sum(out.y ** 2) + out.balance_loss + out.z_loss

    g = _grad_norms(tp, loss)
    assert g["w_gate"] > 0 and g["w_down"] > 0
    assert g["router"] > 0                           # via combine weights


def test_shapes():
    """The reference's ``test_jit_and_shapes`` (the port has no jit)."""
    _, tcfg, _, tp = _setup(e=8, k=2)
    x = torch.from_numpy(_x((4, 8, 16), 6))
    assert tmoe.moe_ffn(tp, x, tcfg).y.shape == x.shape


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2)])
def test_grouped_matches_dense_oracle(e, k):
    """The grouped dispatch equals the oracle when per-group capacity has
    headroom."""
    jcfg, tcfg, npw, tp = _setup(e=e, k=k, cf=float(e))
    x = _x((3, 16, 16), 7)
    out = assert_matches_reference(tmoe.moe_ffn_grouped,
                                   jmoe.moe_ffn_grouped, tp, npw, x, tcfg,
                                   jcfg)
    want = tmoe.moe_ffn_dense_oracle(tp, torch.from_numpy(x), tcfg)
    assert float(out.dropped_fraction) == 0.0
    torch.testing.assert_close(out.y, want, rtol=2e-4, atol=2e-4)


def test_grouped_capacity_is_per_row():
    jcfg, tcfg, npw, tp = _setup(cf=8.0)
    x = _x((2, 32, 16), 8)
    out = assert_matches_reference(tmoe.moe_ffn_grouped,
                                   jmoe.moe_ffn_grouped, tp, npw, x, tcfg,
                                   jcfg, capacity=2)
    assert float(out.dropped_fraction) > 0.0
    assert bool(torch.isfinite(out.y).all())


def test_grouped_gradients_flow():
    _, tcfg, _, tp = _setup()
    x = torch.from_numpy(_x((2, 16, 16), 9))

    def loss(p):
        out = tmoe.moe_ffn_grouped(p, x, tcfg)
        return torch.sum(out.y ** 2) + out.balance_loss

    g = _grad_norms(tp, loss)
    assert g["w_down"] > 0 and g["router"] > 0


# ---------------------------------------------------------------------------
# the port against the reference: quant modes, combine dtypes, the oracle
# ---------------------------------------------------------------------------

def _storage(npw, tp):
    """Both packages' W4A4 storage of the experts (``quantize_lm_params``
    on a tree holding only the MoE block): levels and scales equal."""
    jq = jlm.quantize_lm_params({"moe": jax.tree.map(jnp.asarray, npw)},
                                None, JW4A4)["moe"]
    tq = tlm.quantize_lm_params({"moe": tp}, None, W4A4)["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        assert str(jq[name]["wq"].dtype) == "int4"
        assert np.array_equal(tq[name]["wq"].numpy(),
                              np.asarray(jq[name]["wq"]).astype(np.int8))
        assert np.array_equal(tq[name]["ws"].numpy().view(np.uint32),
                              np.asarray(jq[name]["ws"]).view(np.uint32))
    assert torch.equal(tq["router"], tp["router"])
    return jax.tree.map(np.asarray, jq), tq


@pytest.mark.parametrize("mode", ["w4a4", "storage"])
@pytest.mark.parametrize("grouped", [False, True], ids=["sorted", "grouped"])
def test_quant_modes_against_reference(grouped, mode):
    """The W4A4 fake-quant of the stacked experts (one scale per output
    feature over E and d together) and the int storage ({wq, ws}, each
    cast before the product), under both dispatches."""
    jcfg, tcfg, npw, tp = _setup(e=8, k=2, cf=2.0, seed=1)
    x = _x((2, 16, 16), 10)
    fns = ((tmoe.moe_ffn_grouped, jmoe.moe_ffn_grouped) if grouped else
           (tmoe.moe_ffn, jmoe.moe_ffn))
    if mode == "w4a4":
        assert_matches_reference(*fns, tp, npw, x, tcfg, jcfg,
                                 tkw={"quant": W4A4}, jkw={"quant": JW4A4})
    else:
        jq, tq = _storage(npw, tp)
        assert_matches_reference(*fns, tq, jq, x, tcfg, jcfg)


@pytest.mark.parametrize("combine", ["none", "bfloat16", "float8_e4m3fn"])
def test_grouped_combine_dtypes_against_reference(combine):
    """The expert outputs cast to ``combine_dtype`` before the combine;
    scaled so some pass float8_e4m3fn's range (NaN in both packages)."""
    jcfg, tcfg, npw, tp = _setup(e=4, k=2, cf=4.0, seed=2)
    x = _x((2, 16, 16), 11) * (60.0 if combine == "float8_e4m3fn" else 1.0)
    if combine == "none":
        assert_matches_reference(tmoe.moe_ffn_grouped, jmoe.moe_ffn_grouped,
                                 tp, npw, x, tcfg, jcfg)
        return
    got, _, _ = port(tmoe.moe_ffn_grouped, tp, x, tcfg,
                     combine_dtype=getattr(torch, combine))
    want, _, _ = reference(jmoe.moe_ffn_grouped, npw, x, jcfg,
                           combine_dtype=jnp.dtype(combine))
    y = np.asarray(want.y)
    finite = np.isfinite(y)
    assert np.array_equal(np.isfinite(got.y.numpy()), finite)
    assert finite.all() != (combine == "float8_e4m3fn")
    assert np.max(np.abs(got.y.numpy()[finite] - y[finite])) <= \
        Y_TOL * np.max(np.abs(y[finite]))
    assert float(got.dropped_fraction) == float(want.dropped_fraction)


def _f8_values():
    """float32 values around float8_e4m3fn's range: every midpoint of two
    neighbours (ties), 448, 464 and past it, infinities, NaN, subnormals
    and a spread of random magnitudes, both signs."""
    f8 = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    fin = np.sort(np.unique(f8.astype(np.float32)[np.isfinite(
        f8.astype(np.float32))]))
    mids = ((fin[1:].astype(np.float64) + fin[:-1]) / 2).astype(np.float32)
    edge = np.array([448, 449, 463.99, 464, 464.01, 480, 1e4, np.inf,
                     np.nan, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10],
                    np.float32)
    rnd = np.random.default_rng(0).standard_normal(20000).astype(
        np.float32) * np.float32(100)
    v = np.concatenate([fin, mids, edge, rnd])
    return np.concatenate([v, -v])


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "bfloat16"])
def test_combine_cast_equals_ml_dtypes(src, dtype):
    """``to_combine_dtype`` against ml_dtypes' cast (what ``astype`` does
    in the reference), ties and past +-448 included; PyTorch's plain cast
    saturates float8_e4m3fn there."""
    v = _f8_values().astype(getattr(ml_dtypes, src) if src == "bfloat16"
                            else np.float32)
    t = torch.from_numpy(v.astype(np.float32)).to(getattr(torch, src))
    got = tmoe.to_combine_dtype(t, getattr(torch, dtype)).float().numpy()
    want = v.astype(getattr(ml_dtypes, dtype)).astype(np.float32)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), v[~same][:10]
    if dtype == "float8_e4m3fn":
        plain = t.to(torch.float8_e4m3fn).float().numpy()
        assert np.nanmax(np.abs(plain)) == 448.0     # saturates: not NaN
        assert np.isnan(got[np.abs(v.astype(np.float32)) > 464]).all()


def test_dense_oracle_against_reference():
    jcfg, tcfg, npw, tp = _setup(e=8, k=2, seed=3)
    x = _x((2, 12, 16), 12)
    want = np.asarray(jax.jit(
        lambda p, x: jmoe.moe_ffn_dense_oracle(p, x, jcfg)).lower(
        npw, x).compile(compiler_options=OPTS)(npw, x))
    got = tmoe.moe_ffn_dense_oracle(tp, torch.from_numpy(x), tcfg).numpy()
    assert np.max(np.abs(got - want)) <= Y_TOL * np.max(np.abs(want))


def test_top_k_ties_go_to_the_lower_expert_id():
    """Equal probabilities rank the lower id first, as jax.lax.top_k."""
    logits = np.array([[0.0, 1.0, 1.0, 0.5, 1.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    _, _, top_i = tmoe._route(torch.from_numpy(logits), 3)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 3)
    assert np.array_equal(top_i.numpy(), np.asarray(want))
    assert top_i.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_matches_reference_tree_and_spread(dtype):
    """Shapes and dtypes equal, the router float32 whatever the dtype, each
    leaf's std within 5% of the reference's and its mean near 0."""
    cfg = (32, 2, 64, 96)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jmoe.MoEConfig(*cfg),
                       getattr(jnp, dtype))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0),
                       tmoe.MoEConfig(*cfg), getattr(torch, dtype),
                       device="cpu")
    assert sorted(tp) == sorted(jp)
    assert tp["router"].dtype == torch.float32
    for name, leaf in jp.items():
        t = tp[name]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).endswith(jnp.dtype(leaf.dtype).name)
        want = np.asarray(leaf.astype(jnp.float32))
        got = t.float().numpy()
        assert abs(got.std() / want.std() - 1) <= 0.05, name
        assert abs(got.mean()) <= 5 * want.std() / np.sqrt(want.size)
