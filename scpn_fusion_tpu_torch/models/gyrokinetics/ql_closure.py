"""Closure-based quasilinear gyrokinetic transport model, profile-level
(port of ``scpn_fusion_tpu/models/gyrokinetics/ql_closure.py``).

The compact closure workflow between the analytic gyro-Bohm scaling and the
full TGLF lane (the reference's ``core/gyrokinetic_transport.py``): map
normalized profiles into local TGLF-10-style parameters, scan
``k_theta rho_s`` for the ITG/TEM/ETG branches (Dimits-shifted ITG
threshold, Romanelli-Zonca TEM, Jenko ETG), saturate
(``gamma_sat = gamma/(1+gamma q)``, ``|phi|^2 = 1/ky^2``), sum the
quasilinear weights into ``chi_i, chi_e, D_e`` and convert with gyro-Bohm
scaling.  Branchless tensor code: the fields of :class:`QLLocalParams` may
carry a batch shape (radius), and the spectrum adds a trailing k_y axis, so
the whole profile is one call (JAX's ``vmap`` over radius).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

M_DEUTERON = 2.0 * 1.6726219e-27
E_CHARGE = 1.602176634e-19
SQRT_MASS_RATIO = 60.6          # sqrt(m_D / m_e), reference :186


class QLLocalParams(NamedTuple):
    """TGLF-10 style local input vector (reference ``GyrokineticsParams``);
    every field a tensor of one batch shape (or 0-d)."""

    r_l_ti: torch.Tensor
    r_l_te: torch.Tensor
    r_l_ne: torch.Tensor
    q: torch.Tensor
    s_hat: torch.Tensor
    te_ti: torch.Tensor
    z_eff: torch.Tensor
    nu_star: torch.Tensor
    epsilon: torch.Tensor


class QLSpectrum(NamedTuple):
    k_y: torch.Tensor          # (n_modes,)
    gamma: torch.Tensor        # (..., n_modes) growth rate [c_s/R]
    omega_r: torch.Tensor      # real frequency [c_s/R]
    mode_type: torch.Tensor    # 0 stable, 1 ITG, 2 TEM, 3 ETG


class QLFluxes(NamedTuple):
    chi_i: torch.Tensor
    chi_e: torch.Tensor
    d_e: torch.Tensor


def _per_mode(p: QLLocalParams) -> QLLocalParams:
    """``p`` with a trailing axis against the spectrum's k_y."""
    return QLLocalParams(*(torch.as_tensor(x, dtype=torch.float64)[..., None] for x in p))


def ion_scale_dispersion(p: QLLocalParams, k_y: torch.Tensor):
    """ITG/TEM branch competition (reference ``solve_dispersion``
    :108-147), branchless; ``p``'s fields broadcast against ``k_y``."""
    zero = torch.zeros_like(k_y * p.r_l_ti)
    # ITG: Dimits-shifted critical gradient.
    r_l_ti_crit = torch.clamp(
        (4.0 / 3.0) * (1.0 + 1.0 / p.te_ti) * (1.0 + 2.0 * p.s_hat / p.q), min=0.0)
    drive_itg = p.r_l_ti - r_l_ti_crit
    # Safe sqrt: evaluate the unstable branch on a clamped argument.
    sqrt_itg = torch.sqrt(torch.where(drive_itg > 0.0, drive_itg, torch.ones_like(drive_itg)))
    gamma_itg = torch.where(
        drive_itg > 0.0,
        k_y * p.r_l_ti * sqrt_itg / (1.0 + k_y ** 2),
        zero)
    omega_itg = torch.where(drive_itg > 0.0, -k_y * p.r_l_ti / p.te_ti, zero)

    # TEM: Romanelli-Zonca with collisional detrapping via nu_star.
    f_t = torch.sqrt(2.0 * p.epsilon / (1.0 + p.epsilon))
    omega_star_e = k_y * p.r_l_ne
    gamma_tem = torch.where(
        omega_star_e > 0.0,
        f_t * omega_star_e / (1.0 + k_y ** 2 * (1.0 + p.nu_star)),
        zero)
    omega_tem = omega_star_e

    itg_wins = (gamma_itg > gamma_tem) & (gamma_itg > 0.0)
    tem_wins = (gamma_tem > gamma_itg) & (gamma_tem > 0.0)
    gamma = torch.where(itg_wins, gamma_itg, torch.where(tem_wins, gamma_tem, zero))
    omega = torch.where(itg_wins, omega_itg, torch.where(tem_wins, omega_tem, zero))
    mode = torch.where(itg_wins, 1, torch.where(tem_wins, 2, 0))
    return gamma, omega, mode


def etg_dispersion(p: QLLocalParams, k_y: torch.Tensor):
    """Jenko ETG branch (reference :97-106), scaled to c_s/R units."""
    zero = torch.zeros_like(k_y * p.r_l_te)
    r_l_te_crit = (1.0 + p.z_eff) * torch.clamp(1.33 + 1.91 * p.s_hat / p.q, min=0.0)
    drive = p.r_l_te - r_l_te_crit
    sqrt_etg = torch.sqrt(torch.where(drive > 0.0, drive, torch.ones_like(drive)))
    gamma = torch.where(
        drive > 0.0,
        k_y * p.r_l_te * sqrt_etg / (1.0 + k_y ** 2),
        zero) * SQRT_MASS_RATIO
    omega = torch.where(drive > 0.0, k_y * p.r_l_te, zero) * SQRT_MASS_RATIO
    mode = torch.where(gamma > 0.0, 3, 0)   # k_y-shaped, matches ion branch
    return gamma, omega, mode


def _linspace(a: float, b: float, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.linspace(a, b, n), dtype=torch.float64, device=like.device)


def compute_spectrum(p: QLLocalParams, n_modes: int = 16,
                     include_etg: bool = False) -> QLSpectrum:
    """Ion-scale (+ optional electron-scale) ``k_y`` scan as pure tensor ops
    (reference ``compute_spectrum`` :148-205); ``p``'s batch shape leads."""
    pm = _per_mode(p)
    k_ion = _linspace(0.1, 2.0, n_modes, pm.r_l_ti)
    g_i, w_i, m_i = ion_scale_dispersion(pm, k_ion)
    if not include_etg:
        return QLSpectrum(k_ion, g_i, w_i, m_i)
    k_etg = _linspace(2.0, 30.0, n_modes, pm.r_l_ti)
    g_e, w_e, m_e = etg_dispersion(pm, k_etg)
    return QLSpectrum(torch.cat([k_ion, k_etg]),
                      torch.cat([g_i, g_e], dim=-1),
                      torch.cat([w_i, w_e], dim=-1),
                      torch.cat([m_i, m_e], dim=-1))


def quasilinear_fluxes(p: QLLocalParams, spec: QLSpectrum) -> QLFluxes:
    """Saturation + quasilinear weights summed over the unstable spectrum
    (reference ``quasilinear_fluxes`` :205-283), fully vectorised."""
    p = _per_mode(p)
    zero = torch.zeros_like(spec.gamma)
    gamma_max = 1.0 / torch.clamp(p.q, min=0.1)
    active = (spec.gamma > 0.0) & (spec.mode_type != 0)
    gamma_sat = spec.gamma / (1.0 + spec.gamma / gamma_max)
    phi_sq = 1.0 / spec.k_y ** 2
    omega_safe = torch.where(spec.omega_r == 0.0, torch.ones_like(spec.omega_r), spec.omega_r)

    # ITG channel -> chi_i
    omega_star_ti = -spec.k_y * p.r_l_ti / p.te_ti
    w_itg = torch.where(active & (spec.mode_type == 1) & (p.r_l_ti > 0.0),
                        omega_star_ti / omega_safe, zero)
    chi_i = torch.sum(gamma_sat * phi_sq * w_itg, dim=-1)

    # TEM channel -> chi_e, D_e
    omega_star_te = spec.k_y * p.r_l_te
    omega_star_n = spec.k_y * p.r_l_ne
    tem = active & (spec.mode_type == 2)
    w_te = torch.where(tem & (p.r_l_te > 0.0), omega_star_te / omega_safe, zero)
    w_n = torch.where(tem & (p.r_l_ne > 0.0), omega_star_n / omega_safe, zero)
    chi_e = torch.sum(gamma_sat * phi_sq * w_te, dim=-1)
    d_e = torch.sum(gamma_sat * phi_sq * w_n, dim=-1)

    # ETG channel -> chi_e, rho_e^2/rho_s^2 demotion (reference :268-277)
    etg = active & (spec.mode_type == 3)
    w_etg = torch.where(etg & (p.r_l_te > 0.0), omega_star_te / omega_safe, zero)
    chi_e = chi_e + torch.sum(gamma_sat * phi_sq * w_etg, dim=-1) / SQRT_MASS_RATIO ** 2

    return QLFluxes(torch.clamp(chi_i, min=0.0), torch.clamp(chi_e, min=0.0),
                    torch.clamp(d_e, min=0.0))


def infer_nu_star(r0, q, te_kev, ne_1e19, epsilon, z_eff=1.5,
                  ln_lambda=17.0):
    """Normalised electron collisionality
    ``nu_* = C R q n_e Z_eff lnLambda / (Te^2 eps^1.5)``
    (reference ``_infer_nu_star`` :296-333, coeff 6.921e-5)."""
    nu = (6.921e-5 * r0 * q * ne_1e19 * z_eff * ln_lambda
          / torch.clamp(te_kev, min=1e-9) ** 2)
    return torch.clamp(nu / torch.clamp(epsilon ** 1.5, min=1e-12), min=0.0)


@dataclasses.dataclass(frozen=True)
class QLTransportModel:
    """Drop-in quasilinear replacement for gyro-Bohm scaling (reference
    ``GyrokineticTransportModel`` :286-495)."""

    n_modes: int = 16
    include_etg: bool = False
    c_tune: float = 0.5          # macroscopic tuning constant
    axis_rho: float = 0.05
    axis_chi: float = 0.01

    def local_params(self, rho, te_kev, ti_kev, ne_1e19, q, s_hat,
                     dte_dr, dti_dr, dne_dr, r0, a, z_eff=1.5,
                     nu_star=None) -> QLLocalParams:
        """Profiles -> gradient-normalised local parameters
        (reference ``evaluate`` :358-408)."""
        r_l_te = torch.clamp(-r0 / torch.clamp(te_kev, min=1e-3) * dte_dr, min=0.0)
        r_l_ti = torch.clamp(-r0 / torch.clamp(ti_kev, min=1e-3) * dti_dr, min=0.0)
        r_l_ne = torch.clamp(-r0 / torch.clamp(ne_1e19, min=1e-3) * dne_dr, min=0.0)
        te_ti = torch.clamp(te_kev / torch.clamp(ti_kev, min=1e-3), min=0.1)
        epsilon = torch.clamp(rho * a / r0, min=1e-3)
        q_c = torch.clamp(q, min=0.5)
        if nu_star is None:
            nu_star = infer_nu_star(r0, q_c, te_kev, ne_1e19, epsilon,
                                    z_eff)
        dev = te_kev.device
        return QLLocalParams(
            r_l_ti=r_l_ti, r_l_te=r_l_te, r_l_ne=r_l_ne, q=q_c,
            s_hat=torch.as_tensor(s_hat, dtype=torch.float64, device=dev),
            te_ti=te_ti, z_eff=torch.as_tensor(z_eff, dtype=torch.float64, device=dev),
            nu_star=nu_star, epsilon=epsilon)

    def evaluate_point(self, rho, p: QLLocalParams, te_kev, b0, r0):
        """(chi_i, chi_e, D_e) in m^2/s at one radius (or a batch of them),
        branchless axis guard (reference :356 returns 0.01 inside
        rho<=0.05)."""
        spec = compute_spectrum(p, self.n_modes, self.include_etg)
        flux = quasilinear_fluxes(p, spec)
        te_j = te_kev * 1e3 * E_CHARGE
        c_s = torch.sqrt(torch.clamp(te_j, min=1e-30) / M_DEUTERON)
        rho_s = M_DEUTERON * c_s / (E_CHARGE * b0)
        chi_gb = rho_s ** 2 * c_s / r0
        on_axis = rho <= self.axis_rho
        axis = torch.full_like(chi_gb, self.axis_chi)
        chi_i = torch.where(on_axis, axis, flux.chi_i * chi_gb * self.c_tune)
        chi_e = torch.where(on_axis, axis, flux.chi_e * chi_gb * self.c_tune)
        d_e = torch.where(on_axis, axis, flux.d_e * chi_gb * self.c_tune)
        return chi_i, chi_e, d_e

    def evaluate_profile(self, rho, te_kev, ti_kev, ne_1e19, q, s_hat,
                         dte_dr, dti_dr, dne_dr, r0, a, b0,
                         z_eff=1.5):
        """Whole-profile closure: the (n_rho,) profiles in one batched call
        (replaces the reference's per-point host loop :430-495)."""
        p = self.local_params(rho, te_kev, ti_kev, ne_1e19, q, s_hat,
                              dte_dr, dti_dr, dne_dr, r0, a, z_eff)
        return self.evaluate_point(rho, p, te_kev, b0, r0)
