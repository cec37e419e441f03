"""Reduced ECCD / NBI / LHCD current-drive source models (port of
``scpn_fusion_tpu/models/physics/current_drive.py``).

Gaussian absorbed-power profiles, efficiency-scaled driven current for
ECCD/LHCD (j = eta P_abs / (n_e T_e)), and the NBI fast-ion slowing-down
closure as one vectorised expression, with the e^4 Coulomb prefactor
hoisted to a host double so float32 arithmetic never sees ~1e-76
intermediates.

Sources are frozen dataclasses; :class:`CurrentDriveMix` is a
tuple-of-sources aggregate.  Plain PyTorch ops on the profile tensors: the
results follow their device and dtype.  ``jnp.gradient`` of a kappa(rho)
profile is :func:`frc_stability.gradient` (its rounding, not
``torch.gradient``'s).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

from scpn_fusion_tpu_torch.models.physics.frc_stability import gradient

E_CHARGE = 1.602176634e-19
M_E = 9.1093837e-31
M_P = 1.6726219e-27
EPS_0 = 8.8541878e-12

# Spitzer electron slowing time prefactor in (keV, 1e19 m^-3) units,
# host-double (f32-safe): tau_e = C * T_e[keV]^1.5 / (n_19 Z_eff lnLambda).
_C_TAU_KEV19 = ((12.0 * math.pi**1.5 * EPS_0**2 * math.sqrt(M_E))
                / E_CHARGE**4 * (1e3 * E_CHARGE) ** 1.5 / 1e19)


def _gaussian_profile(rho, p_mw: float, rho_dep: float, sigma: float):
    """P [W/m^3] with unit integral shape (reference ``P_absorbed``)."""
    if sigma <= 0.0:
        return torch.zeros_like(rho)
    return (p_mw * 1e6 / (math.sqrt(2.0 * math.pi) * sigma)
            * torch.exp(-((rho - rho_dep) ** 2) / (2.0 * sigma**2)))


@dataclasses.dataclass(frozen=True)
class ECCDSource:
    """Electron cyclotron current drive."""

    p_mw: float
    rho_dep: float
    sigma_rho: float
    eta_cd: float = 0.03

    def p_absorbed(self, rho):
        return _gaussian_profile(rho, self.p_mw, self.rho_dep, self.sigma_rho)

    def j_cd(self, rho, ne_19, te_kev, ti_kev=None):
        """j = eta P_abs / max(n_e T_e) [A/m^2]."""
        denom = torch.clamp(ne_19 * te_kev, min=1e-3)
        return self.eta_cd * self.p_absorbed(rho) / denom


@dataclasses.dataclass(frozen=True)
class LHCDSource:
    """Lower-hybrid current drive (same closure, higher efficiency)."""

    p_mw: float
    rho_dep: float
    sigma_rho: float
    eta_cd: float = 0.15

    def p_absorbed(self, rho):
        return _gaussian_profile(rho, self.p_mw, self.rho_dep, self.sigma_rho)

    def j_cd(self, rho, ne_19, te_kev, ti_kev=None):
        denom = torch.clamp(ne_19 * te_kev, min=1e-3)
        return self.eta_cd * self.p_absorbed(rho) / denom


@dataclasses.dataclass(frozen=True)
class NBISource:
    """Neutral-beam injection: fast-ion slowing-down current.

    j = e n_fast v_par / Z_b with n_fast = P tau_s / E_beam and the Spitzer
    slowing time tau_s built from tau_e (vectorised over radius).
    """

    p_mw: float
    e_beam_kev: float
    rho_tangency: float
    sigma_rho: float = 0.15
    a_beam: float = 2.0
    z_beam: float = 1.0
    z_eff: float = 1.5
    ln_lambda: float = 17.0

    def p_heating(self, rho):
        return _gaussian_profile(rho, self.p_mw, self.rho_tangency, self.sigma_rho)

    def j_cd(self, rho, ne_19, te_kev, ti_kev=None):
        p_heat = self.p_heating(rho)
        m_beam = self.a_beam * M_P
        e_beam_j = self.e_beam_kev * 1e3 * E_CHARGE
        v_par = math.sqrt(2.0 * e_beam_j / m_beam)
        m_crit = m_beam * (0.75 * math.sqrt(math.pi) * M_E / m_beam) ** (2. / 3.)

        te = torch.clamp(te_kev, min=1e-3)
        n19 = torch.clamp(ne_19, min=1e-3)
        tau_e = _C_TAU_KEV19 * te**1.5 / (n19 * self.z_eff * self.ln_lambda)
        denom = (1.0 + m_beam / (m_crit * self.z_eff)) ** 1.5
        tau_s = 0.75 * math.sqrt(math.pi) * (m_beam / M_E) * tau_e / denom
        n_fast = p_heat * tau_s / e_beam_j
        return E_CHARGE * n_fast * v_par / self.z_beam


Source = Union[ECCDSource, LHCDSource, NBISource]


@dataclasses.dataclass(frozen=True)
class CurrentDriveMix:
    """Aggregate of CD sources over one minor radius (hashable)."""

    sources: tuple = ()
    a_minor: float = 1.0

    def with_source(self, src: Source) -> "CurrentDriveMix":
        return dataclasses.replace(self, sources=self.sources + (src,))

    def total_j_cd(self, rho, ne_19, te_kev, ti_kev):
        j = torch.zeros_like(rho)
        for src in self.sources:
            j = j + src.j_cd(rho, ne_19, te_kev, ti_kev)
        return j

    def total_heating_power(self, rho):
        p = torch.zeros_like(rho)
        for src in self.sources:
            p = p + (src.p_heating(rho) if isinstance(src, NBISource)
                     else src.p_absorbed(rho))
        return p

    def total_driven_current(self, rho, ne_19, te_kev, ti_kev, elongation=1.0):
        """Integrated driven current [A] over the (elongated) cross-section."""
        j = self.total_j_cd(rho, ne_19, te_kev, ti_kev)
        drho = rho[1] - rho[0] if rho.shape[0] > 1 else torch.zeros((), dtype=rho.dtype,
                                                                      device=rho.device)
        kappa = torch.as_tensor(elongation, dtype=rho.dtype, device=rho.device)
        if kappa.dim() > 0:       # kappa(rho) profile: dA = d(pi a^2 kappa rho^2)
            area = math.pi * self.a_minor**2 * kappa * rho**2
            da = gradient(area, torch.ones_like(drho)) / torch.clamp(drho, min=1e-12) * drho
        else:
            da = 2.0 * math.pi * kappa * rho * self.a_minor**2 * drho
        return torch.sum(j * da)
