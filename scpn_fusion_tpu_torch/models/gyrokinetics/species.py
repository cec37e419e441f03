"""GK species, velocity-space quadrature, Bessel J0, collision frequencies
(port of ``scpn_fusion_tpu/models/gyrokinetics/species.py``).

The velocity grid builds its Gauss-Legendre nodes with numpy at construction
(the quadrature layout is static) and hands them out as tensors of the
caller's dtype and device.  ``bessel_j0`` uses the Abramowitz & Stegun
9.4.1 / 9.4.3 polynomial approximations (|err| < 1e-7) with the same
coefficients, so the FLR factors match the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

E_CHARGE = 1.602176634e-19
M_PROTON = 1.67262192369e-27
M_ELECTRON = 9.1093837015e-31
EPS_0 = 8.8541878128e-12


@dataclasses.dataclass(frozen=True)
class GKSpecies:
    """Single plasma species (reference semantics incl. validation)."""

    mass_amu: float
    charge_e: float
    temperature_kev: float
    density_19: float
    r_l_t: float
    r_l_n: float
    is_adiabatic: bool = False

    def __post_init__(self) -> None:
        for name in ("mass_amu", "temperature_kev", "density_19"):
            v = getattr(self, name)
            if not np.isfinite(v) or v <= 0:
                raise ValueError(f"{name} must be finite and positive")
        if not np.isfinite(self.charge_e) or self.charge_e == 0.0:
            raise ValueError("charge_e must be finite and non-zero")

    @property
    def mass_kg(self) -> float:
        return self.mass_amu * M_PROTON

    @property
    def thermal_speed(self) -> float:
        """v_th = sqrt(2 T / m) [m/s]."""
        return float(np.sqrt(2.0 * self.temperature_kev * 1e3 * E_CHARGE / self.mass_kg))


def deuterium_ion(t_kev: float = 8.0, n_19: float = 10.0,
                  r_l_t: float = 6.9, r_l_n: float = 2.2) -> GKSpecies:
    """Cyclone-base-case-like deuterium ions."""
    return GKSpecies(2.0, 1.0, t_kev, n_19, r_l_t, r_l_n)


def electron(t_kev: float = 8.0, n_19: float = 10.0, r_l_t: float = 6.9,
             r_l_n: float = 2.2, adiabatic: bool = True) -> GKSpecies:
    return GKSpecies(M_ELECTRON / M_PROTON, -1.0, t_kev, n_19,
                     r_l_t, r_l_n, is_adiabatic=adiabatic)


@dataclasses.dataclass(frozen=True)
class VelocityGrid:
    """Energy-lambda Gauss-Legendre quadrature (E in [0, 6T], lambda in [0,1])."""

    n_energy: int = 16
    n_lambda: int = 24
    e_max: float = 6.0

    def __post_init__(self) -> None:
        if self.n_energy < 2:
            raise ValueError("n_energy must be at least 2")
        if self.n_lambda < 3:
            raise ValueError("n_lambda must be at least 3")

    def nodes(self, dtype: torch.dtype = torch.float64, device: torch.device | str = "cuda"):
        """Return (energy, energy_weights, lam, lambda_weights) as tensors."""
        e_nodes, e_w = np.polynomial.legendre.leggauss(self.n_energy)
        l_nodes, l_w = np.polynomial.legendre.leggauss(self.n_lambda)
        energy = 0.5 * self.e_max * (e_nodes + 1.0)
        energy_w = 0.5 * self.e_max * e_w
        lam = 0.5 * (l_nodes + 1.0)
        lam_w = 0.5 * l_w
        return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in (energy, energy_w, lam, lam_w))


# A&S 9.4.1 / 9.4.3 coefficients for J0.
_J0_SMALL = (1.0, -2.2499997, 1.2656208, -0.3163866,
             0.0444479, -0.0039444, 0.0002100)
_J0_F = (0.79788456, -0.00000077, -0.00552740, -0.00009512,
         0.00137237, -0.00072805, 0.00014476)
_J0_THETA = (-0.78539816, -0.04166397, -0.00003954, 0.00262573,
             -0.00054125, -0.00029333, 0.00013558)


def _poly(coeffs, x):
    out = coeffs[-1]
    for c in coeffs[-2::-1]:
        out = out * x + c
    return out


def bessel_j0(x: torch.Tensor) -> torch.Tensor:
    """J0(x) via A&S polynomial approximations (|err| < 1e-7)."""
    ax = torch.abs(x)
    small = (ax / 3.0) ** 2
    j0_small = _poly(_J0_SMALL, small)
    big = torch.clamp(ax, min=3.0)
    inv = 3.0 / big
    f0 = _poly(_J0_F, inv)
    th0 = big + _poly(_J0_THETA, inv)
    j0_large = f0 * torch.cos(th0) / torch.sqrt(big)
    return torch.where(ax <= 3.0, j0_small, j0_large)


def collision_frequencies(
    species: GKSpecies,
    n_e_19: float,
    t_e_kev: float,
    z_eff: float = 1.0,
    ln_lambda: float = 17.0,
):
    """(nu_D, nu_E): deflection / energy-diffusion rates (reference
    Braginskii-Sugama diagonal closure, ``gk_species.py:171-220``)."""
    n_e = n_e_19 * 1e19
    t_e_j = t_e_kev * 1e3 * E_CHARGE
    t_s_j = species.temperature_kev * 1e3 * E_CHARGE

    q_s = abs(species.charge_e) * E_CHARGE
    prefactor = 4.0 * np.sqrt(np.pi) / (3.0 * (4.0 * np.pi * EPS_0) ** 2)
    field_mass = M_ELECTRON if species.charge_e > 0 else M_PROTON
    field_t_j = t_e_j if species.charge_e > 0 else t_s_j
    reduced_mass = species.mass_kg * field_mass / (species.mass_kg + field_mass)
    thermal_sum = t_s_j / species.mass_kg + field_t_j / field_mass

    nu_ref = (prefactor * n_e * q_s**4 * ln_lambda * z_eff
              / (reduced_mass**2 * thermal_sum**1.5))
    mass_relax = 2.0 * reduced_mass / (species.mass_kg + field_mass)
    nu_d = float(nu_ref)
    nu_e = float(nu_d * mass_relax * np.sqrt(t_s_j / field_t_j))
    return nu_d, nu_e
