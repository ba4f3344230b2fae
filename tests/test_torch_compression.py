"""repro_torch's gradient compression (``optim/compression.py``) and
gradient buckets (``distributed/collectives.py``) on the CPU, against the
reference's ``repro.optim.compression`` and
``repro.distributed.collectives``.

``compress_int8`` is held bitwise (codes and scales) and
``decompress_int8`` bitwise on random leaves, on tie-heavy leaves (every
quotient on a .5, where ``torch.round`` and ``jnp.round`` both go to
even), on all-zero blocks (the 1e-12 scale floor) and on ragged sizes
(the padded last block). ``bucket_leaves`` gives the reference's buckets
(leaf order and sizes). The all-reduce itself is multi-rank:
``tests/test_torch_distributed.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcollectives
from repro.optim import compression as jcomp
from repro_torch.distributed import collectives
from repro_torch.optim import compression as comp


def _leaf(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 3, n)
                ).astype(np.float32)
    if kind == "ties":
        # a block's max is 127, so every scale is 1 and x / 1 lands on .5
        x = rng.integers(-126, 126, n).astype(np.float32) + 0.5
        x[::comp.BLOCK] = 127.0
        return x
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "tiny":
        return (rng.standard_normal(n) * 1e-30).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("n", [256, 1000, 257, 7])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "tiny"])
def test_compress_int8_is_bitwise_the_reference(kind, n):
    x = _leaf(kind, n, seed=n)
    codes, scales = comp.compress_int8(torch.from_numpy(x))
    jcodes, jscales = jcomp.compress_int8(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  np.asarray(jscales).view(np.uint32))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    back = comp.decompress_int8(codes, scales, (n,))
    jback = jcomp.decompress_int8(jcodes, jscales, (n,))
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.asarray(jback).view(np.uint32))


def test_ties_round_half_to_even():
    x = _leaf("ties", 512)
    codes, _ = comp.compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.round(x).astype(np.int8))
    assert (np.abs(x - np.round(x)) == 0.5).sum() > 400


def test_compress_int8_keeps_a_matrix_shape_through_decompress():
    x = np.random.default_rng(3).standard_normal((33, 17)).astype(
        np.float32)
    codes, scales = comp.compress_int8(torch.from_numpy(x))
    assert codes.shape == (3 * comp.BLOCK,) and scales.shape == (3,)
    back = comp.decompress_int8(codes, scales, x.shape)
    assert back.shape == x.shape
    # each entry within half a step of its block's scale
    step = np.repeat(scales.numpy(), comp.BLOCK)[:x.size].reshape(x.shape)
    assert (np.abs(back.numpy() - x) <= 0.5 * step * (1 + 1e-6)).all()


def test_error_state_starts_at_zero_in_float32():
    params = {"a": torch.ones(3, dtype=torch.bfloat16),
              "b": {"c": torch.ones(2, 2)}}
    err = comp.init_error_state(params)
    assert err["a"].dtype == torch.float32 and not err["a"].any()
    assert err["b"]["c"].shape == (2, 2)


@pytest.mark.parametrize("bucket_bytes", [64, 1000, 32 * 2**20])
def test_bucket_leaves_gives_the_reference_buckets(bucket_bytes):
    rng = np.random.default_rng(0)
    shapes = {"z": (40,), "a": {"w": (8, 8), "b": (8,)},
              "m": {"x": (100,), "y": (3, 5)}, "b16": (50,)}

    def make(tree, lib):
        if isinstance(tree, dict):
            return {k: make(v, lib) for k, v in tree.items()}
        arr = rng.standard_normal(tree).astype(np.float32)
        return lib(arr)
    rng = np.random.default_rng(0)
    ttree = make(shapes, torch.from_numpy)
    rng = np.random.default_rng(0)
    jtree = make(shapes, jnp.asarray)
    got = collectives.bucket_leaves(ttree, bucket_bytes)
    want = jcollectives.bucket_leaves(jtree, bucket_bytes)
    assert [[tuple(x.shape) for x in b] for b in got] == \
        [[tuple(x.shape) for x in b] for b in want]
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_optimization_barrier_is_the_identity():
    tree = {"a": torch.ones(2)}
    assert collectives.with_optimization_barrier(tree) is tree
