"""repro_torch's Mamba2 SSD (``nn/ssm.py``) against the JAX reference, on
the CPU.

The same numpy inputs go through both: ``segsum``; ``ssd_chunked`` at
several chunk sizes, with groups and an initial state, against the
reference's and against the port's own sequential ``ssd_reference``;
``ssd_decode_step`` stepped over a sequence (it must continue
``ssd_chunked``'s final state); ``causal_conv1d`` and
``causal_conv1d_step``.

The reference runs compiled with XLA's algebraic simplifier off and
without excess precision (see ``test_torch_attention.py``). Tolerances,
against the largest magnitude of the reference's output: float32 within
1e-5 (cumulative sums of the decay and einsums of up to Q terms in
another order; exp of a cumsum turns the sums' ulps into relative
errors); bfloat16 inputs within 1e-2 (the intra-chunk product is taken in
bf16). The port's chunked form against its sequential oracle: 1e-4, as
the reference's own test holds its two.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as JS
from repro_torch.nn import ssm as TS

OPTS = {"xla_disable_hlo_passes": "algsimp",
        "xla_allow_excess_precision": False}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)(*args)


def both(a: np.ndarray, dtype="float32"):
    j = jnp.asarray(a.astype(np.float32), getattr(jnp, dtype))
    return j, torch.tensor(np.asarray(j, np.float32)).to(getattr(torch, dtype))


def close(got: torch.Tensor, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


def ssd_inputs(seed, b, t, h, p, g, n, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = both(rng.standard_normal((b, t, h, p)), dtype)
    dt = both(np.log1p(np.exp(rng.standard_normal((b, t, h)) - 1.0)))
    a = both(-np.exp(rng.standard_normal(h) * 0.5))
    bm = both(rng.standard_normal((b, t, g, n)), dtype)
    cm = both(rng.standard_normal((b, t, g, n)), dtype)
    return x, dt, a, bm, cm


def test_segsum_against_reference():
    ja, ta = both(np.random.default_rng(0).standard_normal((2, 3, 16)))
    want = np.asarray(compiled(JS.segsum, ja))
    got = TS.segsum(ta).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.max(np.abs(got[fin] - want[fin])) <= 1e-5 * np.max(
        np.abs(want[fin]))
    # the diagonal is 0 and above it -inf
    assert np.all(np.diagonal(got, axis1=-2, axis2=-1) == 0)
    assert np.all(np.triu(np.isinf(got[0, 0]), 1) == np.triu(
        np.ones((16, 16), bool), 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [
    (2, 64, 4, 8, 1, 16, 16), (1, 48, 6, 16, 2, 8, 16),
    (2, 32, 4, 8, 1, 16, 32), (1, 8, 4, 16, 1, 16, 8)])
def test_ssd_chunked_against_reference(dtype, b, t, h, p, g, n, chunk):
    (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc) = ssd_inputs(
        t + h, b, t, h, p, g, n, dtype)
    rng = np.random.default_rng(t)
    js0, ts0 = both(rng.standard_normal((b, h, p, n)) * 0.5)
    for init in (None, (js0, ts0)):
        jy, jst = compiled(lambda x, dt, a, bb, cc, s0: JS.ssd_chunked(
            x, dt, a, bb, cc, chunk=chunk, initial_state=s0),
            jx, jdt, ja, jb, jc, None if init is None else init[0])
        ty, tst = TS.ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk,
                                 initial_state=None if init is None
                                 else init[1])
        assert ty.dtype == tx.dtype and tst.dtype == torch.float32
        close(ty, jy, TOL[dtype])
        close(tst, jst, TOL[dtype])


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_ssd_chunked_matches_sequential_oracle_in_the_port(chunk):
    (_, x), (_, dt), (_, a), (_, b), (_, c) = ssd_inputs(3, 2, 64, 4, 8, 2,
                                                         16)
    y, st = TS.ssd_chunked(x, dt, a, b, c, chunk=chunk)
    yr, str_ = TS.ssd_reference(x, dt, a, b, c)
    assert torch.allclose(y, yr, rtol=1e-4, atol=1e-4)
    assert torch.allclose(st, str_, rtol=1e-4, atol=1e-4)


def test_ssd_chunked_rejects_a_ragged_chunk():
    (_, x), (_, dt), (_, a), (_, b), (_, c) = ssd_inputs(3, 1, 12, 2, 4, 1,
                                                         4)
    with pytest.raises(ValueError, match="must divide"):
        TS.ssd_chunked(x, dt, a, b, c, chunk=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_against_reference_and_chunked(dtype):
    """Steps over 12 tokens from the chunked form's state after 16: each
    step equals the reference's; the stepped outputs continue the chunked
    form over all 28 tokens (float32: within 1e-4, as the port's oracle)."""
    (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc) = ssd_inputs(
        5, 2, 28, 4, 8, 2, 16, dtype)
    _, tst = TS.ssd_chunked(tx[:, :16], tdt[:, :16], ta, tb[:, :16],
                            tc[:, :16], chunk=8)
    jst = jnp.asarray(tst.numpy())
    step = jax.jit(JS.ssd_decode_step).lower(
        jst, jx[:, 0], jdt[:, 0], ja, jb[:, 0], jc[:, 0]).compile(
        compiler_options=OPTS)
    ys = []
    for i in range(16, 28):
        jy, jst = step(jst, jx[:, i], jdt[:, i], ja, jb[:, i], jc[:, i])
        ty, tst = TS.ssd_decode_step(tst, tx[:, i], tdt[:, i], ta, tb[:, i],
                                     tc[:, i])
        close(ty, jy, TOL[dtype])
        close(tst, jst, TOL[dtype])
        ys.append(ty)
    if dtype == "float32":
        y_all, _ = TS.ssd_chunked(tx, tdt, ta, tb, tc, chunk=4)
        assert torch.allclose(torch.stack(ys, 1), y_all[:, 16:], rtol=1e-4,
                              atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
def test_causal_conv_and_step_against_reference(dtype, k):
    rng = np.random.default_rng(k)
    jx, tx = both(rng.standard_normal((2, 10, 24)), dtype)
    jw, tw = both(rng.standard_normal((k, 24)) * 0.3)
    jb, tb = both(rng.standard_normal(24) * 0.1)
    for bias in ((jb, tb), (None, None)):
        close(TS.causal_conv1d(tx, tw, bias[1]),
              compiled(lambda x, w, bb: JS.causal_conv1d(x, w, bb), jx, jw,
                       bias[0]), TOL[dtype])
    full = TS.causal_conv1d(tx, tw, tb)
    jstate = jnp.zeros((2, k - 1, 24), getattr(jnp, dtype))
    tstate = torch.zeros((2, k - 1, 24), dtype=getattr(torch, dtype))
    step = jax.jit(JS.causal_conv1d_step).lower(
        jstate, jx[:, 0], jw, jb).compile(compiler_options=OPTS)
    for i in range(10):
        jy, jstate = step(jstate, jx[:, i], jw, jb)
        ty, tstate = TS.causal_conv1d_step(tstate, tx[:, i], tw, tb)
        close(ty, jy, TOL[dtype])
        assert torch.equal(tstate.float(), torch.tensor(
            np.asarray(jstate.astype(jnp.float32))))
        assert torch.equal(ty, full[:, i])
