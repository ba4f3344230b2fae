"""repro_torch compressive acquisition and pooling against JAX.

Pinned here:

* ``compressive_acquire``'s fused mode is a float32 FMA chain over c, then
  di, then dj, from 0 — the order of the reference's jitted einsum, bit for
  bit, wherever XLA emits that dot as a sequential loop (p*p*C = 4, 12, 16
  taps: p = 2 with C = 1 or 3, p = 4 with C = 1). At p = 4, C = 3 XLA
  splits the 48 taps over the host's vector lanes and sums them as a tree,
  and the reference's Pallas kernel sums di, dj, c unfused: there the
  orders differ by a few ulps (up to 5 between the reference's own two
  backends), and the tolerance is the error bound of summing n positive
  terms in two orders, 2 (n - 1) 2^-24 of the sum.
* ``fma_f32`` is a correctly rounded fused multiply-add, midpoints
  included, checked against exact rational arithmetic.
* The avg pool sums its window row-major from 0 and divides once — what
  the reference's ``mean(axis=(2, 4))`` does on the pooled shapes of the
  serving path — while ``torch.mean`` does not.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressive import ca_coefficients as jax_coefficients
from repro.core.compressive import compressive_acquire as jax_acquire
from repro.kernels.ca_pool.ops import ca_pool as pallas_ca_pool
from repro_torch.core.accelerator import _pool
from repro_torch.core.compressive import (ca_coefficients,
                                          compressive_acquire, fma_f32)
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.ca_pool.ops import ca_pool


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _jitted(img, pool, rgb):
    return np.asarray(jax.jit(lambda x: jax_acquire(x, pool, rgb))(img))


def _within_sum_bound(got, want, n_terms):
    """|got - want| <= 2 (n - 1) u * want: two orders of a sum of n
    positive float32 terms each carry at most (n - 1) u relative error."""
    bound = 2 * (n_terms - 1) * 2.0 ** -24 * np.abs(want)
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("pool", [2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 5])
def test_coefficients_equal_reference(pool, channels):
    np.testing.assert_array_equal(
        ca_coefficients(pool, channels).numpy(),
        np.asarray(jax_coefficients(pool, channels)))


@pytest.mark.parametrize("shape,pool", [
    ((4, 32, 32, 3), 2),      # VGG9's CA: RGB -> gray, 2x2
    ((8, 32, 32, 3), 2),
    ((3, 16, 24, 3), 2),
    ((2, 32, 32, 1), 2),
    ((5, 28, 28, 1), 4),
])
def test_gray_bitwise_equal_to_jitted_reference(shape, pool):
    img = _img(shape, seed=shape[0])
    got = compressive_acquire(torch.from_numpy(img), pool, True).numpy()
    np.testing.assert_array_equal(got, _jitted(img, pool, True))


def test_gray_p4_rgb_within_sum_bound_of_jitted_reference():
    img = _img((4, 32, 32, 3), seed=11)
    got = compressive_acquire(torch.from_numpy(img), 4, True).numpy()
    _within_sum_bound(got, _jitted(img, 4, True), 48)


@pytest.mark.parametrize("shape,pool", [((4, 32, 32, 3), 2),
                                        ((5, 28, 28, 1), 4),
                                        ((2, 16, 16, 1), 2)])
def test_gray_within_sum_bound_of_pallas_kernel(shape, pool):
    img = _img(shape, seed=5)
    got = compressive_acquire(torch.from_numpy(img), pool, True).numpy()
    want = np.asarray(pallas_ca_pool(jnp.asarray(img), pool=pool,
                                     rgb_to_gray=True))
    _within_sum_bound(got, want, pool * pool * shape[-1])


@pytest.mark.parametrize("shape", [(5, 28, 28, 1), (2, 32, 32, 3)])
def test_per_channel_mean_bitwise_equal_to_jitted_reference(shape):
    img = _img(shape, seed=3)
    got = compressive_acquire(torch.from_numpy(img), 2, False).numpy()
    np.testing.assert_array_equal(got, _jitted(img, 2, False))


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (2, 28, 28, 1)])
@pytest.mark.parametrize("gray", [True, False])
def test_wrapper_and_dispatch_on_cpu_are_the_plain_version(shape, gray):
    img = torch.from_numpy(_img(shape, seed=9))
    want = compressive_acquire(img, 2, gray)
    reset_launch_counts()
    assert torch.equal(ca_pool(img, 2, gray), want)
    assert launch_counts()["ca_pool"] == 0
    for backend in dispatch.BACKENDS:
        assert torch.equal(dispatch.ca_acquire(img, 2, gray, backend), want)


def _round_f32(q: Fraction) -> np.float32:
    """Exact rational -> nearest float32, ties to even."""
    r = np.float32(float(q))
    best = None
    for cand in (np.nextafter(r, np.float32(-np.inf)), r,
                 np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - q)
        even = (int(np.asarray(cand).view(np.int32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return best[1]


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    x = rng.random(2000).astype(np.float32)
    c = (rng.random(2000) * 0.2).astype(np.float32)
    a = (rng.random(2000) * 4).astype(np.float32)
    # exact float32 midpoints: a + x*c lands halfway between two floats
    # when x*c is exactly half an ulp of a (c = 2^-24 * ulp scaling)
    a[:200] = np.float32(1.0) + np.arange(200, dtype=np.float32) * 2**-23
    x[:200] = np.float32(1.0)
    c[:200] = np.float32(2**-24)
    x[200:400] = np.float32(1.0) + np.float32(2**-23)   # just above half
    c[200:400] = np.float32(2**-24)
    got = fma_f32(torch.from_numpy(x), torch.from_numpy(c),
                  torch.from_numpy(a)).numpy()
    want = np.array([_round_f32(Fraction(float(xi)) * Fraction(float(ci))
                                + Fraction(float(ai)))
                     for xi, ci, ai in zip(x, c, a)], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 28, 28, 6), (8, 10, 10, 16),
                                   (1, 28, 28, 6), (3, 10, 10, 16)])
def test_avg_pool_bitwise_equal_to_reference_mean(shape):
    """LeNet's two avg pools, at serving and odd batch sizes. (XLA picks
    its reduce order by shape: with 64 channels, or a 16-wide single-
    channel row, it sums pairwise instead — not a shape on this path.)"""
    y = _img(shape, seed=1)

    def jax_pool(v):
        b, h, w, c = v.shape
        return v.reshape(b, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))

    want = np.asarray(jax.jit(jax_pool)(y))
    np.testing.assert_array_equal(
        _pool(torch.from_numpy(y), "avg", 2).numpy(), want)


def test_torch_mean_is_not_the_reference_pool_order():
    """Why ``window_mean`` exists: torch's mean sums in another order."""
    y = _img((8, 28, 28, 16), seed=1)
    b, h, w, c = y.shape
    naive = torch.from_numpy(y).reshape(b, h // 2, 2, w // 2, 2, c) \
        .mean(dim=(2, 4)).numpy()
    pooled = _pool(torch.from_numpy(y), "avg", 2).numpy()
    assert not np.array_equal(naive, pooled)
