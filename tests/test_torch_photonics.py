"""repro_torch's device-level photonic models (``core/photonics.py``) on
the CPU against the reference's ``repro.core.photonics``.

Every case of the reference's ``tests/test_photonics.py`` on the port,
and each deterministic function bitwise equal to the reference's on the
same float32 inputs, eager, and under ``jit`` but for
``transmission_with_drift`` (where XLA contracts ``half * sqrt(.) + drift``
into an FMA, the eager reference does not, and the port follows the eager
one). The square root is the correctly rounded one, as XLA's. The two noise draws take a
``torch.Generator`` where the reference takes a key, so they are held to
statistical parity only: over 200,000 draws the means within 0.01 and the
standard deviations within 2% of the reference's, and the drawn
transmissions in [0, 1].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import photonics as jph
from repro_torch.core import photonics as ph


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.numpy().tobytes() == want.tobytes()


def test_transmission_monotone_in_detuning():
    d = torch.linspace(0, 0.5, 50)
    t = ph.mr_through_transmission(d, fwhm_nm=0.1)
    assert float(t[0]) == 0.0                      # on resonance: full drop
    assert bool(torch.all(torch.diff(t) >= 0))     # monotone
    assert float(t[-1]) > 0.9                      # far off resonance
    _bitwise(t, jph.mr_through_transmission(jnp.asarray(d.numpy()), 0.1))


def test_weight_to_detuning_roundtrip():
    targets = torch.linspace(0.01, 0.95, 20)
    d = ph.weight_to_detuning(targets, fwhm_nm=0.1)
    realized = ph.mr_through_transmission(d, fwhm_nm=0.1)
    np.testing.assert_allclose(realized.numpy(), targets.numpy(), rtol=1e-5)
    _bitwise(d, jph.weight_to_detuning(jnp.asarray(targets.numpy()), 0.1))


def test_half_transmission_at_half_fwhm():
    t = ph.mr_through_transmission(torch.tensor(0.05), fwhm_nm=0.1)
    assert abs(float(t) - 0.5) < 1e-6
    _bitwise(t, jph.mr_through_transmission(jnp.asarray(0.05), 0.1))


def test_vcsel_li_curve():
    codes = torch.arange(16)
    p = ph.vcsel_intensity(codes)
    assert float(p[0]) == 0.0                      # below threshold
    assert bool(torch.all(torch.diff(p) >= 0))     # monotone in drive code
    assert float(p[15]) > 0
    _bitwise(p, jph.vcsel_intensity(jnp.arange(16)))


def test_bpd_differential_signed():
    pos = torch.tensor([1.0, 0.0, 2.0])
    neg = torch.tensor([0.0, 1.0, 2.0])
    i = ph.bpd_differential(pos, neg)
    assert float(i[0]) > 0 and float(i[1]) < 0 and abs(float(i[2])) < 1e-12
    _bitwise(i, jph.bpd_differential(jnp.asarray(pos.numpy()),
                                     jnp.asarray(neg.numpy())))


def test_q_factor():
    dev = ph.MRDevice(lambda_res_nm=1550.0, fwhm_nm=0.1)
    assert abs(dev.q_factor - 15500) < 1
    assert dev == ph.MRDevice(**{
        f: getattr(jph.MRDevice(lambda_res_nm=1550.0, fwhm_nm=0.1), f)
        for f in ph.MRDevice.__dataclass_fields__})


@pytest.mark.parametrize("fwhm", [0.1, 0.05, 0.2])
def test_deterministic_functions_bitwise_equal_to_reference(fwhm):
    rng = np.random.default_rng(int(fwhm * 100))
    d = rng.uniform(-0.5, 0.5, 20000).astype(np.float32)
    t = np.concatenate([rng.uniform(0, 1, 19996),
                        [0.0, 1.0, 1 - 1e-7, -0.5]]).astype(np.float32)
    drift = (0.02 * rng.standard_normal(20000)).astype(np.float32)
    jd, jt, jdrift = map(jnp.asarray, (d, t, drift))
    td, tt, tdrift = map(torch.from_numpy, (d, t, drift))
    dev = ph.MRDevice(fwhm_nm=fwhm, tuning_nm_per_mw=0.3)
    jdev = jph.MRDevice(fwhm_nm=fwhm, tuning_nm_per_mw=0.3)
    for fn, jit in (
            (lambda m, *a: m.mr_through_transmission(a[0], fwhm), True),
            (lambda m, *a: m.weight_to_detuning(a[1], fwhm), True),
            (lambda m, *a: m.transmission_with_drift(a[1], a[2], fwhm),
             False)):
        _bitwise(fn(ph, td, tt, tdrift), fn(jph, jd, jt, jdrift))
        if jit:      # under jit XLA contracts half * sqrt(.) + drift to an FMA
            _bitwise(fn(ph, td, tt, tdrift),
                     jax.jit(lambda *a: fn(jph, *a))(jd, jt, jdrift))
    _bitwise(ph.detuning_tuning_power_mw(td, dev),
             jph.detuning_tuning_power_mw(jd, jdev))
    codes = rng.integers(0, 16, 1000).astype(np.int32)
    _bitwise(ph.vcsel_intensity(torch.from_numpy(codes), 0.1, 0.35, 0.25),
             jph.vcsel_intensity(jnp.asarray(codes), 0.1, 0.35, 0.25))
    _bitwise(ph.bpd_differential(td, tt, 0.9),
             jph.bpd_differential(jd, jt, 0.9))


def test_drift_noise_changes_transmission():
    t = torch.full((128,), 0.5)
    g = torch.Generator().manual_seed(0)
    noisy = ph.photonic_noise(g, t, drift_std_nm=0.02)
    assert float(torch.std(noisy)) > 0.0
    assert bool(torch.all((noisy >= 0) & (noisy <= 1)))
    assert ph.photonic_noise(g, t) is t            # no drift: no draw


N_DRAWS = 200_000


def test_drift_noise_matches_reference_statistically():
    t = torch.full((N_DRAWS,), 0.5)
    got = ph.photonic_noise(torch.Generator().manual_seed(0), t, 0.02)
    want = np.asarray(jph.photonic_noise(jax.random.PRNGKey(0),
                                         jnp.full((N_DRAWS,), 0.5), 0.02))
    assert abs(float(got.mean()) - float(want.mean())) < 0.01
    assert abs(float(got.std()) / float(want.std()) - 1) < 0.02
    assert float(got.min()) >= 0 and float(got.max()) <= 1


def test_shot_noise_matches_reference_statistically():
    i = torch.full((N_DRAWS,), 1e-3)
    got = ph.shot_noise_current(torch.Generator().manual_seed(1), i)
    want = np.asarray(jph.shot_noise_current(jax.random.PRNGKey(1),
                                             jnp.full((N_DRAWS,), 1e-3)))
    sigma = np.sqrt(2 * 1.602e-19 * 1e-3 * 5e9)
    for x in (got.numpy().astype(np.float64), want.astype(np.float64)):
        assert abs(x.mean() - 1e-3) < 0.01 * sigma * 100
        assert abs(x.std() / sigma - 1) < 0.02
    assert abs(got.numpy().std() / want.std() - 1) < 0.02
