"""repro_torch photonic MVM: the plain version against both JAX oracles.

The same integer operands, made with numpy, go through the port's
``mvm_int_ref`` (its wrapper's CPU path), the reference package's
``mvm_int_ref`` and its Pallas kernel in interpret mode. All three must be
bitwise equal on ragged M/K/N, with and without a dequant scale.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.photonic_mvm.ops import photonic_mvm_prequant
from repro.kernels.photonic_mvm.ref import mvm_int_ref as jax_mvm_int_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import dispatch
from repro_torch.kernels.photonic_mvm.ops import mvm_int
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref

SHAPES = [(1, 1, 1), (7, 13, 5), (37, 101, 53), (130, 200, 129)]


def _operands(m, k, n, seed, signed=False):
    rng = np.random.default_rng(seed)
    lo = -15 if signed else 0
    a = rng.integers(lo, 16, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random(n) + 0.5).astype(np.float32)
    return a, w, ws


@pytest.mark.parametrize("act_scale", [1.0, 0.37])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ref_bitwise_equal_to_jax_ref(m, k, n, act_scale):
    a, w, ws = _operands(m, k, n, seed=m * 1000 + k, signed=True)
    want = np.asarray(jax_mvm_int_ref(jnp.asarray(a), jnp.asarray(w),
                                      jnp.asarray(ws), act_scale))
    got = mvm_int_ref(torch.from_numpy(a), torch.from_numpy(w),
                      torch.from_numpy(ws), act_scale).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ref_bitwise_equal_to_pallas_interpret(m, k, n):
    a, w, ws = _operands(m, k, n, seed=7 + m)
    want = np.asarray(photonic_mvm_prequant(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(ws), act_scale=1.0))
    got = mvm_int(torch.from_numpy(a), torch.from_numpy(w),
                  torch.from_numpy(ws), 1.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    a, w, ws = _operands(9, 33, 17, seed=3)
    reset_launch_counts()
    got = mvm_int(torch.from_numpy(a), torch.from_numpy(w),
                  torch.from_numpy(ws))
    want = mvm_int_ref(torch.from_numpy(a), torch.from_numpy(w),
                       torch.from_numpy(ws))
    assert torch.equal(got, want)
    assert launch_counts()["photonic_mvm"] == 0


def test_wrapper_rejects_shapes_that_do_not_chain():
    a, w, ws = _operands(4, 8, 3, seed=1)
    with pytest.raises(ValueError, match="do not chain"):
        mvm_int(torch.from_numpy(a), torch.from_numpy(w[:5]),
                torch.from_numpy(ws))
    with pytest.raises(ValueError, match="scales"):
        mvm_int(torch.from_numpy(a), torch.from_numpy(w),
                torch.from_numpy(ws[:2]))


@pytest.mark.parametrize("act_scale", [1.0, 0.37])
def test_without_scales_is_the_scaled_accumulate(act_scale):
    """No ws: ``acc * act_scale``; the same bits as ws = 1."""
    a, w, _ = _operands(21, 70, 9, seed=11)
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    got = mvm_int(at, wt, act_scale=act_scale)
    assert torch.equal(got, mvm_int_ref(at, wt, torch.ones(9), act_scale))
    assert torch.equal(got, mvm_int_ref(at, wt, None, act_scale))


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_matmul_int_is_the_raw_accumulate(backend):
    a, w, _ = _operands(11, 40, 6, seed=5)
    acc = dispatch.matmul_int(torch.from_numpy(a).float(),
                              torch.from_numpy(w), backend)
    np.testing.assert_array_equal(
        acc.numpy(), (a.astype(np.int64) @ w.astype(np.int64))
        .astype(np.float32))
