"""Device-level photonic models: microring resonators, VCSELs, photodetectors.

The device layer of the paper's bottom-up evaluation framework (Fig. 7),
as the reference package states it:

1. weight transfer — how a target transmission becomes an MR detuning, and
   what transmission error a thermal drift causes;
2. energy bookkeeping — tuning power scales with detuning, VCSEL power
   with its driver level.

The through-port transmission of an all-pass ring near resonance is
Lorentzian in the detuning, parameterized by its FWHM. Every function is
elementwise float32, op for op the reference's (Python constants rounded
to float32 where the reference's weak types round them; division through
``quant.true_div`` where the divisor is a constant; the square root taken
in float64 and rounded once, which is the correctly rounded float32 root
XLA gives, where PyTorch's vectorized CPU ``sqrt`` is up to 2 ulp off). The two noise draws
take a ``torch.Generator`` where the reference takes a ``jax.random`` key:
the same distribution, other numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import _clip, true_div


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root."""
    return torch.sqrt(x.double()).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class MRDevice:
    """An MR with the parameters the paper's device layer reports."""

    lambda_res_nm: float = 1550.0       # resonant wavelength
    fwhm_nm: float = 0.10               # full width at half maximum of the notch
    n_eff: float = 2.37                 # effective refractive index (SOI ring)
    circumference_um: float = 65.4      # L
    mode_order: int = 100               # m
    tuning_nm_per_mw: float = 0.25      # microheater tuning efficiency
    max_detuning_nm: float = 0.4        # tuning range

    @property
    def q_factor(self) -> float:
        return self.lambda_res_nm / self.fwhm_nm


def mr_through_transmission(detuning_nm: torch.Tensor,
                            fwhm_nm: float = 0.10) -> torch.Tensor:
    """Through-port power transmission vs detuning (Lorentzian notch):
    T(delta) = delta^2 / (delta^2 + (FWHM/2)^2); 0 on resonance, -> 1 far
    off it, monotone in |delta|."""
    half = fwhm_nm / 2.0
    d2 = torch.square(detuning_nm)
    return d2 / (d2 + half * half)


def weight_to_detuning(t_target: torch.Tensor,
                       fwhm_nm: float = 0.10) -> torch.Tensor:
    """The Lorentzian inverted: the detuning that realizes ``t_target``,
    t in [0, 1) -> (FWHM/2) * sqrt(t / (1 - t))."""
    half = fwhm_nm / 2.0
    t = _clip(t_target, 0.0, 1.0 - 1e-6)
    return half * _sqrt(t / (1.0 - t))


def detuning_tuning_power_mw(detuning_nm: torch.Tensor,
                             dev: MRDevice = MRDevice()) -> torch.Tensor:
    """Microheater power needed to hold a detuning (linear tuning model)."""
    return true_div(torch.abs(detuning_nm), dev.tuning_nm_per_mw)


def transmission_with_drift(t_target: torch.Tensor, drift_nm: torch.Tensor,
                            fwhm_nm: float = 0.10) -> torch.Tensor:
    """Realized transmission when the ring drifts by ``drift_nm``."""
    delta = weight_to_detuning(t_target, fwhm_nm)
    return mr_through_transmission(delta + drift_nm, fwhm_nm)


def photonic_noise(generator: torch.Generator, t_target: torch.Tensor,
                   drift_std_nm: float = 0.0,
                   fwhm_nm: float = 0.10) -> torch.Tensor:
    """Realized transmissions under Gaussian thermal drift, drawn from
    ``generator`` (on ``t_target``'s device)."""
    if drift_std_nm <= 0.0:
        return t_target
    drift = drift_std_nm * torch.randn(t_target.shape, generator=generator,
                                       dtype=torch.float32,
                                       device=t_target.device)
    return transmission_with_drift(t_target, drift, fwhm_nm)


# ---------------------------------------------------------------------------
# VCSEL / DMVA
# ---------------------------------------------------------------------------

def vcsel_intensity(code: torch.Tensor, i_unit_ma: float = 0.125,
                    slope_mw_per_ma: float = 0.3,
                    i_threshold_ma: float = 0.2) -> torch.Tensor:
    """Optical output power of a directly modulated VCSEL. ``code`` is the
    number of ON driver transistors (0..15); the drive current is code *
    i_unit, the power follows the L-I curve above threshold."""
    current = code.to(torch.float32) * i_unit_ma
    zero = torch.zeros((), dtype=torch.float32, device=current.device)
    return torch.maximum(current - i_threshold_ma, zero) * slope_mw_per_ma


def bpd_differential(pos_mw: torch.Tensor, neg_mw: torch.Tensor,
                     responsivity_a_per_w: float = 1.1) -> torch.Tensor:
    """Balanced photodetector: signed accumulate of two optical rails."""
    return (pos_mw - neg_mw) * 1e-3 * responsivity_a_per_w


def shot_noise_current(generator: torch.Generator,
                       photocurrent_a: torch.Tensor,
                       bandwidth_hz: float = 5e9) -> torch.Tensor:
    """Shot noise, sigma_i = sqrt(2 q I B): the photocurrent plus a
    Gaussian draw from ``generator``."""
    q = 1.602e-19
    sigma = _sqrt(2.0 * q * torch.abs(photocurrent_a) * bandwidth_hz)
    return photocurrent_a + sigma * torch.randn(
        photocurrent_a.shape, generator=generator,
        dtype=photocurrent_a.dtype, device=photocurrent_a.device)
