"""Edge physics: SOL two-point model, Eich width, EPED-like pedestal (port of
``scpn_fusion_tpu/models/physics/edge.py``).

* Eich scaling lambda_q [mm] = 1.35 P^-0.02 R^0.04 Bpol^-0.92 eps^0.42;
* the Spitzer-Harm two-point SOL model with a sheath-limited target;
* the EPED-like pedestal: Snyder width Delta = 0.076 beta_p^0.5 nu*^-0.2 with
  the density broadening, and the KBM/ballooning-limited T_ped fixed point
  (20 iterations: the JAX ``fori_loop`` is a Python loop of 0-d ops here);
* the shaped tier: the Miller ballooning boundary along the bootstrap path
  (``ballooning.bootstrap_path_alpha_crit``, one launch of row B on the card)
  and a one-constant peeling proxy.

The SOL functions take numbers or tensors: a tensor among the inputs sets the
dtype and device, else ``dtype`` (float32) and ``device`` (``"cuda"``) do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import as_tensors  # noqa: F401

E_CHARGE = 1.602176634e-19
M_E = 9.109e-31
EPS0 = 8.8541878128e-12
MU0 = 4.0e-7 * math.pi

# f32-safe electron Coulomb prefactor: nu_ei = K_E * n_19 * Z_eff * ln_lambda / T_keV^1.5
_K_NU_E = float(1e19 * E_CHARGE**4
                / (12.0 * np.pi**1.5 * EPS0**2 * np.sqrt(M_E) * (1e3 * E_CHARGE) ** 1.5))


def eich_heat_flux_width(p_sol_mw, r0, b_pol, epsilon, *, dtype=None, device="cuda"):
    """Eich #14 scaling, lambda_q in mm (1.0 on degenerate input)."""
    p_sol_mw, r0, b_pol, epsilon = as_tensors(p_sol_mw, r0, b_pol, epsilon, dtype=dtype,
                                            device=device)
    ok = (p_sol_mw > 0) & (b_pol > 0) & (r0 > 0) & (epsilon > 0)
    lam = (1.35 * (torch.clamp(p_sol_mw, min=1e-9) ** -0.02)
           * (torch.clamp(r0, min=1e-9) ** 0.04)
           * (torch.clamp(b_pol, min=1e-9) ** -0.92)
           * (torch.clamp(epsilon, min=1e-9) ** 0.42))
    return torch.where(ok, lam, torch.ones_like(lam))


def peak_target_heat_flux(p_sol_mw, r0, lambda_q_m, f_expansion=5.0, alpha_deg=3.0, *,
                          dtype=None, device="cuda"):
    """Peak target heat flux [MW/m^2] with flux expansion and tilt."""
    p_sol_mw, r0, lambda_q_m, f_expansion, alpha_deg = as_tensors(
        p_sol_mw, r0, lambda_q_m, f_expansion, alpha_deg, dtype=dtype, device=device)
    area = 2.0 * math.pi * r0 * lambda_q_m * f_expansion / torch.sin(torch.deg2rad(alpha_deg))
    q = p_sol_mw / torch.clamp(area, min=1e-12)
    return torch.where(lambda_q_m > 0, q, torch.zeros_like(q))


class SOLSolution(NamedTuple):
    t_upstream_ev: torch.Tensor
    t_target_ev: torch.Tensor
    n_target_19: torch.Tensor
    q_parallel_mw_m2: torch.Tensor
    lambda_q_mm: torch.Tensor


def two_point_sol(*, p_sol_mw, n_u_19, r0, a, q95, b_pol, f_rad=0.0, dtype=None,
                  device="cuda") -> SOLSolution:
    """Spitzer-Harm two-point model (reference ``TwoPointSOL.solve``)."""
    p_sol_mw, n_u_19, r0, a, q95, b_pol, f_rad = as_tensors(
        p_sol_mw, n_u_19, r0, a, q95, b_pol, f_rad, dtype=dtype, device=device)
    epsilon = a / r0
    l_par = math.pi * q95 * r0
    lambda_q_mm = eich_heat_flux_width(p_sol_mw, r0, b_pol, epsilon)
    lambda_q_m = lambda_q_mm * 1e-3

    b_ratio = q95 / epsilon
    q_par_u = (p_sol_mw * 1e6) / (4.0 * math.pi * r0 * lambda_q_m) * b_ratio

    kappa_0 = 2000.0
    t_u = ((3.5 * l_par * q_par_u) / kappa_0) ** (2.0 / 7.0)
    q_par_t = torch.clamp(q_par_u * (1.0 - f_rad), min=1e3)

    gamma_sh = 7.0
    m_i = 2.0 * 1.6726e-27
    n_u = n_u_19 * 1e19
    denom = n_u * t_u * gamma_sh * E_CHARGE * math.sqrt(2.0 * E_CHARGE / m_i)
    sqrt_tt = 2.0 * q_par_t / torch.clamp(denom, min=1e-30)
    t_t = torch.where(denom > 0, sqrt_tt**2, torch.full_like(sqrt_tt, 0.1))
    t_t = torch.minimum(t_t, t_u)
    n_t = n_u * t_u / (2.0 * torch.clamp(t_t, min=0.1))
    return SOLSolution(t_u, t_t, n_t / 1e19, q_par_u / 1e6, lambda_q_mm)


class PedestalResult(NamedTuple):
    p_ped_kpa: torch.Tensor
    t_ped_kev: torch.Tensor
    n_ped_1e19: torch.Tensor
    delta_ped: torch.Tensor
    beta_p_ped: torch.Tensor
    nu_star_ped: torch.Tensor


def _pedestal_point(t_ped, *, n_ped_1e19, n_e, b_pol, z_eff, q_ped, r0, epsilon,
                    nu_star_width_exp):
    """(p_ped, beta_p, nu*, width) at the pedestal temperature ``t_ped``."""
    t_j = t_ped * 1e3 * E_CHARGE
    p_ped = n_e * 2.0 * t_j
    beta_p = 2.0 * MU0 * p_ped / b_pol**2
    v_te = torch.sqrt(2.0 * t_j / M_E)
    t_ev = torch.clamp(t_ped, min=0.01) * 1e3
    ln_l = torch.clamp(17.7 + torch.log(t_ev / 1e4)
                       - 0.5 * torch.log(torch.clamp(n_e, min=1e10) / 1e20), min=10.0)
    nu_ei = _K_NU_E * n_ped_1e19 * z_eff * ln_l / torch.clamp(t_ped, min=0.01) ** 1.5
    eps_ped = torch.clamp(0.95 * epsilon, min=0.01)
    nu_star = nu_ei * q_ped * r0 / (eps_ped**1.5 * torch.clamp(v_te, min=1.0))
    delta = (0.076 * torch.sqrt(torch.clamp(beta_p, min=0.001))
             * torch.clamp(nu_star, min=0.001) ** nu_star_width_exp)
    delta = torch.clamp(delta * (1.0 + 0.25 * (n_ped_1e19 / 10.0)), 0.01, 0.15)
    return p_ped, beta_p, nu_star, delta


def eped_pedestal(*, n_ped_1e19, r0, a, b0, ip_ma, kappa=1.7, z_eff=1.5, t_ped_guess_kev=3.0,
                  n_iter: int = 20, alpha_crit=None, nu_star_width_exp=-0.2,
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> PedestalResult:
    """EPED-like pedestal prediction (Snyder width + KBM-limited height).

    ``alpha_crit``: optional override of the analytic s-alpha critical
    pressure gradient (the shaped tier passes the Miller boundary)."""
    n_ped_1e19, r0, a, b0, ip_ma, kappa, z_eff, t_ped, nu_star_width_exp = as_tensors(
        n_ped_1e19, r0, a, b0, ip_ma, kappa, z_eff, t_ped_guess_kev, nu_star_width_exp,
        dtype=dtype, device=device)
    epsilon = a / r0
    b_pol = MU0 * ip_ma * 1e6 / (2.0 * math.pi * a * torch.sqrt((1.0 + kappa**2) / 2.0))
    n_e = n_ped_1e19 * 1e19

    q_ped = torch.clamp((b0 / r0) * (a**2 / (0.2 * ip_ma)) * ((1.0 + kappa**2) / 2.0), min=2.0)
    s_ped = 2.0 * (1.0 + 0.5 * (kappa - 1.7))
    if alpha_crit is None:
        alpha_crit = torch.where(s_ped < 1.0, s_ped * (1.0 - s_ped / 2.0),
                                 0.6 * s_ped) * (1.0 + 0.3 * (kappa - 1.0))
    else:
        alpha_crit = torch.as_tensor(alpha_crit, dtype=dtype, device=device)
    point = dict(n_ped_1e19=n_ped_1e19, n_e=n_e, b_pol=b_pol, z_eff=z_eff, q_ped=q_ped, r0=r0,
                 epsilon=epsilon, nu_star_width_exp=nu_star_width_exp)

    for _ in range(n_iter):
        delta = _pedestal_point(t_ped, **point)[3]
        t_max = (alpha_crit * b0**2 * delta * a) / (4.0 * MU0 * r0 * q_ped**2 * n_e)
        t_ped = torch.clamp(t_max / E_CHARGE / 1e3, min=0.1)

    p_ped, beta_p, nu_star, delta = _pedestal_point(t_ped, **point)
    return PedestalResult(p_ped_kpa=p_ped / 1e3, t_ped_kev=t_ped, n_ped_1e19=n_ped_1e19,
                          delta_ped=delta, beta_p_ped=beta_p, nu_star_ped=nu_star)


class ShapedPedestalResult(NamedTuple):
    pedestal: PedestalResult
    alpha_crit: torch.Tensor
    alpha_ballooning: torch.Tensor
    alpha_peeling: torch.Tensor
    second_access: torch.Tensor      # bool: the path dodges the unstable band


def eped_pedestal_shaped(*, n_ped_1e19, r0, a, b0, ip_ma, kappa=1.7, delta_shape=0.3,
                         rho_ped=0.95, z_eff=1.5, c_bootstrap: float = 3.0,
                         c_peel: float = 1.34, alpha_hi: float = 16.0,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda") -> ShapedPedestalResult:
    """Shaped-geometry pedestal tier: Miller ballooning along the
    bootstrap-consistent shear path ``s_eff = s_ped - c_bootstrap alpha``
    (2000 RK4 steps, one launch of row B on the card) + the one-constant
    peeling proxy ``alpha_peel = c_peel s_ped sqrt(q_ped)``; the height is
    the pure-Snyder-width fixed point at the smaller of the two alphas."""
    # imported here, as in JAX: ballooning imports control.scenario, whose
    # package imports plasma_controllers, which imports this module
    from scpn_fusion_tpu_torch.models.physics.ballooning import bootstrap_path_alpha_crit

    q_ped = max(float((b0 / r0) * (a**2 / (0.2 * ip_ma)) * ((1.0 + kappa**2) / 2.0)), 2.0)
    s_ped = 2.0 * (1.0 + 0.5 * (kappa - 1.7))
    path = bootstrap_path_alpha_crit(
        s_ped, c_bootstrap, alpha_hi=alpha_hi, r0=float(r0), a=float(a), rho=float(rho_ped),
        kappa=float(kappa), delta=float(delta_shape), q=q_ped, n_steps=2000, dtype=dtype,
        device=device)
    alpha_peel = torch.tensor(c_peel * s_ped * np.sqrt(q_ped), dtype=dtype, device=device)
    alpha_crit = torch.minimum(path.alpha_crit, alpha_peel)
    res = eped_pedestal(n_ped_1e19=n_ped_1e19, r0=r0, a=a, b0=b0, ip_ma=ip_ma, kappa=kappa,
                        z_eff=z_eff, alpha_crit=alpha_crit, nu_star_width_exp=0.0, dtype=dtype,
                        device=device)
    return ShapedPedestalResult(pedestal=res, alpha_crit=alpha_crit,
                                alpha_ballooning=path.alpha_crit, alpha_peeling=alpha_peel,
                                second_access=path.second_access)
