"""Quasilinear transport fluxes from the linear GK spectrum.

JAX port of ``core/gk_quasilinear.py:32-133``: mixing-length saturation
``|phi_k|^2 = gamma / (k_perp^2 |omega_r|)`` and the quasilinear weights
summed over the unstable spectrum, gyro-Bohm normalised
(``chi_gB = rho_s^2 c_s / a``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from scpn_fusion_tpu_torch.models.gyrokinetics.linear import LinearGKResult
from scpn_fusion_tpu_torch.models.gyrokinetics.species import E_CHARGE, GKSpecies, M_PROTON


class GKOutput(NamedTuple):
    chi_i: float
    chi_e: float
    d_e: float
    converged: bool
    dominant_mode: str


def mixing_length_saturation(gamma, omega_r, k_y, gamma_floor: float = 1e-6):
    """|phi_k|^2 = gamma / (k_perp^2 |omega_r|) for unstable modes."""
    gamma = np.asarray(gamma)
    omega_r = np.asarray(omega_r)
    k_y = np.asarray(k_y)
    abs_omega = np.maximum(np.abs(omega_r), gamma_floor)
    return np.where(gamma > 0, gamma / (k_y**2 * abs_omega), 0.0)


def quasilinear_fluxes_from_spectrum(
    result: LinearGKResult,
    ion: GKSpecies,
    r0: float = 2.78,
    a: float = 1.0,
    b0: float = 2.0,
) -> GKOutput:
    """Convert the linear spectrum to (chi_i, chi_e, D_e) [m^2/s]."""
    if len(result.k_y) == 0:
        return GKOutput(0.0, 0.0, 0.0, True, "stable")

    phi_sq = mixing_length_saturation(result.gamma, result.omega_r, result.k_y)
    chi_i_n = chi_e_n = d_e_n = 0.0
    for i in range(len(result.k_y)):
        if result.gamma[i] <= 0 or abs(result.omega_r[i]) < 1e-10:
            continue
        ky = result.k_y[i]
        amp = result.gamma[i] * phi_sq[i]
        mt = result.mode_type[i]
        if mt == "ITG":
            omega_star_i = -ky * ion.r_l_t
            chi_i_n += amp * abs(omega_star_i / result.omega_r[i])
        elif mt == "TEM":
            chi_e_n += amp * abs(ky * ion.r_l_t / result.omega_r[i])
            d_e_n += amp * abs(ky * ion.r_l_n / result.omega_r[i])
        elif mt == "ETG":
            chi_e_n += amp * abs(ky * ion.r_l_t / result.omega_r[i]) / 60.0**2

    m_i = ion.mass_amu * M_PROTON
    t_i_j = ion.temperature_kev * 1e3 * E_CHARGE
    c_s = np.sqrt(t_i_j / m_i)
    rho_s = m_i * c_s / (E_CHARGE * b0)
    chi_gb = rho_s**2 * c_s / a

    dominant = "stable"
    if result.gamma_max > 0:
        dominant = result.mode_type[int(np.argmax(result.gamma))]
    return GKOutput(
        chi_i=float(chi_i_n * chi_gb),
        chi_e=float(chi_e_n * chi_gb),
        d_e=float(d_e_n * chi_gb),
        converged=True,
        dominant_mode=dominant,
    )
