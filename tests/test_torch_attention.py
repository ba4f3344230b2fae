"""repro_torch's attention (``nn/attention.py``) against the JAX reference,
on the CPU.

The same numpy inputs go through both: ``apply_rope``, ``attention_naive``
and the blockwise ``attention`` (several ``kv_block``s, a length that pads,
causal and not, sliding windows, ``q_offset``, GQA and MHA),
``cache_update`` (ring, non-ring, and the write past the end that
``dynamic_update_slice`` clamps onto the last slot) and
``decode_attention`` (full and windowed, ring caches).

The reference runs compiled with XLA's algebraic simplifier off and
without excess precision (``OPTS``): then it rounds where its code says
and divides where it divides. Tolerances, against the largest magnitude
of the reference's output: float32 within 1e-6 (the products and sums run
in another order); bfloat16 within 1e-2 (a product rounded to bf16 on one
side and not the other moves it by a bf16 ulp, 2^-8). Cache updates are
copies: bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro_torch.nn import attention as TA

OPTS = {"xla_disable_hlo_passes": "algsimp",
        "xla_allow_excess_precision": False}
TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def compiled(fn, *args):
    """``fn(*args)`` of the reference, compiled with ``OPTS``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)(*args)


def arrays(seed, *shapes, dtype="float32"):
    """Standard-normal numpy arrays, rounded to ``dtype`` once, as a JAX
    and a torch copy each."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                        getattr(jnp, dtype))
        out.append((j, torch.tensor(np.asarray(j, np.float32)).to(
            getattr(torch, dtype))))
    return out


def close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,theta", [(16, 10000.0), (80, 10000.0),
                                     (128, 5e6)])
def test_rope_against_reference(dtype, d, theta):
    (jx, tx), = arrays(d, (2, 9, 3, d), dtype=dtype)
    pos = np.random.default_rng(1).integers(0, 4000, (2, 9)).astype(np.int32)
    close(TA.apply_rope(tx, torch.from_numpy(pos), theta),
          compiled(lambda x, p: JA.apply_rope(x, p, theta), jx,
                   jnp.asarray(pos)), dtype)
    # 1-D positions broadcast over the batch
    p1 = np.arange(9, dtype=np.int32)
    close(TA.apply_rope(tx, torch.from_numpy(p1), theta),
          compiled(lambda x, p: JA.apply_rope(x, p, theta), jx,
                   jnp.asarray(p1)), dtype)


CASES = [  # t, h, kv, kv_block, causal, window, q_offset
    (64, 8, 8, 16, True, None, 0),
    (100, 8, 2, 32, True, None, 0),          # S pads to 128
    (96, 15, 5, 32, True, None, 0),
    (48, 4, 4, 16, False, None, 0),          # encoder
    (64, 4, 2, 16, True, 8, 0),
    (64, 4, 2, 16, True, 1000, 0),
    (40, 4, 2, 512, True, 12, 0),            # one padded block
    (16, 4, 2, 16, True, None, 24),          # queries after a prefix
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,h,kv,kv_block,causal,window,q_offset", CASES)
def test_attention_against_reference(dtype, t, h, kv, kv_block, causal,
                                     window, q_offset):
    s = t + q_offset
    (jq, tq), (jk, tk), (jv, tv) = arrays(
        t * h + kv, (2, t, h, 16), (2, s, kv, 16), (2, s, kv, 16),
        dtype=dtype)
    close(TA.attention(tq, tk, tv, causal=causal, window=window,
                       kv_block=kv_block, q_offset=q_offset),
          compiled(lambda q, k, v: JA.attention(
              q, k, v, causal=causal, window=window, kv_block=kv_block,
              q_offset=q_offset), jq, jk, jv), dtype)
    close(TA.attention_naive(tq, tk, tv, causal=causal, window=window,
                             q_offset=q_offset),
          compiled(lambda q, k, v: JA.attention_naive(
              q, k, v, causal=causal, window=window, q_offset=q_offset),
              jq, jk, jv), dtype)


def test_blockwise_equals_naive_in_the_port():
    (_, q), (_, k), (_, v) = arrays(3, (2, 70, 6, 16), (2, 70, 3, 16),
                                    (2, 70, 3, 16))
    for window in (None, 9):
        want = TA.attention_naive(q, k, v, window=window)
        got = TA.attention(q, k, v, window=window, kv_block=16)
        assert torch.allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("start", [0, 5, 7, 8, 11])
def test_cache_update_against_reference(ring, start):
    """An 8-slot cache written at ``start``: a ring wraps (11 -> slot 3),
    a non-ring cache writes its last slot from 7 on, as the reference's
    clamped ``dynamic_update_slice`` does; pos counts up either way; the
    cache passed in is left as it was."""
    (jk, tk), (jv, tv), (jn, tn), (jm, tm) = arrays(
        start, (2, 8, 2, 4), (2, 8, 2, 4), (2, 1, 2, 4), (2, 1, 2, 4),
        dtype="bfloat16")
    jc = JA.KVCache(jk, jv, jnp.asarray(start, jnp.int32))
    tc = TA.KVCache(tk, tv, torch.tensor(start, dtype=torch.int32))
    before = tk.clone()
    jout = JA.cache_update(jc, jn, jm, ring=ring)
    tout = TA.cache_update(tc, tn, tm, ring=ring)
    for got, want in ((tout.k, jout.k), (tout.v, jout.v)):
        assert torch.equal(got.float(), torch.tensor(
            np.asarray(want.astype(jnp.float32))))
    assert int(tout.pos) == int(jout.pos) == start + 1
    assert tout.pos.dtype == torch.int32
    assert torch.equal(tk, before)
    slot = start % 8 if ring else min(start, 7)
    assert torch.equal(tout.k[:, slot], tn[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,window,s_cache", [(1, None, 16), (9, None, 16),
                                                (16, None, 16), (9, 4, 16),
                                                (20, 8, 8), (5, 8, 8)])
def test_decode_attention_against_reference(dtype, pos, window, s_cache):
    """One query against a bf16 cache holding ``pos`` tokens (a ring of the
    window's size where ``s_cache`` == window)."""
    (jq, tq), (jk, tk), (jv, tv) = arrays(
        pos + s_cache, (2, 1, 8, 16), (2, s_cache, 2, 16),
        (2, s_cache, 2, 16), dtype=dtype)
    jc = JA.KVCache(jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16),
                    jnp.asarray(pos, jnp.int32))
    tc = TA.KVCache(tk.bfloat16(), tv.bfloat16(),
                    torch.tensor(pos, dtype=torch.int32))
    close(TA.decode_attention(tq, tc, window=window),
          compiled(lambda q, c: JA.decode_attention(q, c, window=window),
                   jq, jc), dtype)


def test_decode_steps_match_full_attention_in_the_port():
    """Prefill by cache_update + decode_attention one token at a time equals
    causal attention over the whole sequence (float32 cache)."""
    (_, q), (_, k), (_, v) = arrays(11, (1, 12, 4, 16), (1, 12, 2, 16),
                                    (1, 12, 2, 16))
    want = TA.attention_naive(q, k, v, causal=True)
    c = TA.KVCache.init(1, 12, 2, 16, dtype=torch.float32, device="cpu")
    for i in range(12):
        c = TA.cache_update(c, k[:, i:i + 1], v[:, i:i + 1])
        got = TA.decode_attention(q[:, i:i + 1], c)
        assert torch.allclose(got[:, 0], want[:, i], rtol=2e-5, atol=2e-5)


def test_cache_inits_default_to_the_card():
    """``KVCache.init`` and ``SSMState.init`` default to CUDA, as every
    entry point of the port does: with no GPU a call without a device
    raises, and ``device="cpu"`` is the caller's to ask for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.nn import ssm as TS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.KVCache.init(1, 4, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.SSMState.init(1, 4, 8, 2, 4, 8)
    assert TA.KVCache.init(1, 4, 2, 8, device="cpu").k.device.type == "cpu"
    assert TS.SSMState.init(1, 4, 8, 2, 4, 8,
                            device="cpu").ssm.device.type == "cpu"
