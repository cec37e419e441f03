"""MHD stability criteria suite (port of
``scpn_fusion_tpu/models/physics/stability_mhd.py``).

Same reduced-order formulas as the JAX package:

* q-profile from a parabolic current profile with Uckan-style shape
  corrections, magnetic shear, normalised pressure gradient alpha_MHD
* Mercier/Suydam interchange proxy  D_M = s^2/4 - alpha  (stable >= 0)
* first ballooning boundary (Connor-Hastie-Taylor 1978):
  alpha_crit = s(1 - s/2) for s < 1, 0.6 s otherwise; and the eigenvalue
  lane with second-stability access (:func:`ballooning_stability_eigen`:
  the port's ``ballooning`` module, row B on the card)
* Kruskal-Shafranov external kink: q_edge > 1
* Troyon beta_N limit (g = 2.8 no-wall / 3.5 ideal-wall)
* reduced Rutherford NTM seeding: w_marg = -(j_bs/j) a / (r_s Delta')
* resistive wall mode: gamma tau_w ~ (beta_N - g_nw)/(g_w - beta_N)
* peeling-ballooning elliptical boundary (Snyder 2002/2011 calibration)

Functions of profiles follow the tensors' device and dtype; the scalar ones
(:func:`troyon_beta_limit`, :func:`rwm_stability`) take ``dtype`` and
``device`` as well.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

MU0 = 4.0e-7 * math.pi
E_KEV_J = 1.602176634e-16


class QProfile(NamedTuple):
    rho: torch.Tensor
    q: torch.Tensor
    shear: torch.Tensor
    alpha_mhd: torch.Tensor
    q_min: torch.Tensor
    q_min_rho: torch.Tensor
    q_edge: torch.Tensor


def _gradient(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h = x[1] - x[0]
    interior = (y[2:] - y[:-2]) / (2.0 * h)
    left = (y[1] - y[0]) / h
    right = (y[-1] - y[-2]) / h
    return torch.cat([left[None], interior, right[None]])


def compute_q_profile(rho: torch.Tensor, ne: torch.Tensor, ti: torch.Tensor, te: torch.Tensor,
                      r0: float, a: float, b0: float, ip_ma: float, kappa: float = 1.0,
                      delta: float = 0.0) -> QProfile:
    """Shape-aware approximate safety-factor profile."""
    ip = ip_ma * 1e6
    epsilon = a / r0
    f_shape = (1.0 + kappa**2 * (1.0 + 2.0 * delta**2 - 1.2 * delta**3)) / 2.0
    f_aspect = (1.17 - 0.65 * epsilon) / (1.0 - epsilon**2)
    f_total = f_shape * f_aspect

    rho_safe = torch.clamp(rho, min=1e-10)
    i_enc = ip * (2.0 * rho_safe**2 - rho_safe**4)
    b_theta = torch.clamp(MU0 * i_enc / (2.0 * math.pi * rho_safe * a), min=1e-12)
    q = rho_safe * a * b0 / (r0 * b_theta) * f_total
    q0 = f_total * math.pi * a**2 * b0 / (MU0 * r0 * ip)
    q = torch.cat([torch.full_like(q[:1], q0), q[1:]])

    dq = _gradient(q, rho_safe)
    shear = (rho_safe / q) * dq
    shear = torch.cat([torch.zeros_like(shear[:1]), shear[1:]])

    p_pa = ne * 1e19 * (ti + te) * E_KEV_J
    dp_dr = _gradient(p_pa, rho_safe) / a
    alpha_mhd = -2.0 * MU0 * r0 * q**2 / b0**2 * dp_dr

    idx = torch.argmin(q)
    return QProfile(rho=rho, q=q, shear=shear, alpha_mhd=alpha_mhd,
                    q_min=q[idx], q_min_rho=rho[idx], q_edge=q[-1])


class MercierResult(NamedTuple):
    rho: torch.Tensor
    d_m: torch.Tensor
    stable: torch.Tensor
    all_stable: torch.Tensor


def mercier_stability(qp: QProfile) -> MercierResult:
    """Suydam interchange proxy: D_M = s^2/4 - alpha, stable where >= 0
    (axis region, first 5 points, excluded as in the reference)."""
    d_m = qp.shear**2 / 4.0 - qp.alpha_mhd
    stable = d_m >= 0.0
    checked = torch.arange(qp.rho.shape[0], device=qp.rho.device) >= 5
    return MercierResult(qp.rho, d_m, stable, torch.all(stable | ~checked))


class BallooningResult(NamedTuple):
    rho: torch.Tensor
    s: torch.Tensor
    alpha: torch.Tensor
    alpha_crit: torch.Tensor
    stable: torch.Tensor
    margin: torch.Tensor


def ballooning_stability(qp: QProfile) -> BallooningResult:
    """First ballooning boundary (Connor-Hastie-Taylor 1978)."""
    s, alpha = qp.shear, qp.alpha_mhd
    alpha_crit = torch.clamp(torch.where(s < 1.0, s * (1.0 - s / 2.0), 0.6 * s), min=0.0)
    stable = alpha <= alpha_crit
    return BallooningResult(qp.rho, s, alpha, alpha_crit, stable, alpha_crit - alpha)


def ballooning_stability_eigen(qp: QProfile, *, alpha_max: float = 5.0,
                               n_alpha: int = 64) -> BallooningResult:
    """Eigenvalue-based ballooning boundary WITH second-stability access:
    the full s-alpha ballooning-equation scan (``physics/ballooning``, two
    launches of row B on the card); a point is stable below the first
    boundary OR above the second.  ``alpha_crit`` reports the first
    boundary (scan ceiling on full-access rows)."""
    from scpn_fusion_tpu_torch.models.physics.ballooning import (
        ballooning_stable, second_stability_scan,
    )

    s, alpha = qp.shear, qp.alpha_mhd
    stable = ballooning_stable(torch.clamp(s, min=0.0), torch.clamp(alpha, min=0.0))
    scan = second_stability_scan(torch.clamp(s, min=0.0), alpha_max=alpha_max,
                                 n_alpha=n_alpha)
    return BallooningResult(qp.rho, s, alpha, scan.alpha_crit_first, stable,
                            scan.alpha_crit_first - alpha)


class KruskalShafranovResult(NamedTuple):
    q_edge: torch.Tensor
    stable: torch.Tensor
    margin: torch.Tensor


def kruskal_shafranov_stability(qp: QProfile) -> KruskalShafranovResult:
    """External kink (m=1, n=1): stable when q_edge > 1."""
    return KruskalShafranovResult(qp.q_edge, qp.q_edge > 1.0, qp.q_edge - 1.0)


class TroyonResult(NamedTuple):
    beta_n: torch.Tensor
    beta_n_crit_nowall: torch.Tensor
    beta_n_crit_wall: torch.Tensor
    stable_nowall: torch.Tensor
    stable_wall: torch.Tensor
    margin_nowall: torch.Tensor


def troyon_beta_limit(beta_t, ip_ma, a, b0, g_nowall: float = 2.8, g_wall: float = 3.5, *,
                      dtype=None, device="cuda") -> TroyonResult:
    """Troyon normalised-beta limit: beta_N = 100 beta_t a B0 / Ip[MA]."""
    beta_t, ip_ma, g_nw, g_w = as_tensors(beta_t, ip_ma, g_nowall, g_wall, dtype=dtype,
                                          device=device)
    i_n = ip_ma / (a * b0)
    beta_n = 100.0 * beta_t / i_n
    return TroyonResult(beta_n, g_nw, g_w, beta_n < g_nw, beta_n < g_w, g_nw - beta_n)


class NTMResult(NamedTuple):
    rho: torch.Tensor
    delta_prime: torch.Tensor
    j_bs_drive: torch.Tensor
    w_marginal: torch.Tensor
    ntm_unstable: torch.Tensor
    most_unstable_rho: torch.Tensor


def ntm_stability(qp: QProfile, j_bs: torch.Tensor, j_total: torch.Tensor, a: float,
                  r_s_delta_prime: float = -2.0) -> NTMResult:
    """Reduced modified-Rutherford NTM triggerability analysis."""
    j_total_safe = torch.where(torch.abs(j_total) > 1e-6, j_total,
                               torch.full_like(j_total, 1e-6))
    j_bs_frac = j_bs / j_total_safe
    delta_prime = torch.full_like(qp.rho, r_s_delta_prime)
    denom = torch.where(torch.abs(delta_prime) > 1e-10, delta_prime,
                        torch.full_like(delta_prime, -1e-10))
    w_marg = torch.clamp(-j_bs_frac * a / denom, min=0.0)
    unstable = (w_marg > 0.0) & (j_bs_frac > 0.0) & (delta_prime < 0.0)
    idx = torch.argmax(torch.where(unstable, w_marg, torch.zeros_like(w_marg)))
    most = torch.where(torch.any(unstable), qp.rho[idx], torch.full_like(qp.rho[0], math.nan))
    return NTMResult(qp.rho, delta_prime, j_bs_frac, w_marg, unstable, most)


class RWMResult(NamedTuple):
    beta_n: torch.Tensor
    stable: torch.Tensor
    mode_growth_rate: torch.Tensor


def rwm_stability(beta_n, g_nowall: float = 2.8, g_wall: float = 3.5, *, dtype=None,
                  device="cuda") -> RWMResult:
    """Resistive wall mode: grows on the wall time between the limits."""
    (beta_n,) = as_tensors(beta_n, dtype=dtype, device=device)
    growth = torch.where(beta_n > g_nowall,
                         (beta_n - g_nowall) / torch.clamp(g_wall - beta_n, min=0.01),
                         torch.zeros_like(beta_n))
    return RWMResult(beta_n, beta_n < g_nowall, growth)


class PeelingBallooningResult(NamedTuple):
    j_edge_norm: torch.Tensor
    alpha_edge_norm: torch.Tensor
    stability_distance: torch.Tensor
    stable: torch.Tensor
    type_i_elm: torch.Tensor   # deep in unstable territory (pb_radius > 1.2)


def peeling_ballooning_stability(qp: QProfile, j_edge, p_ped_pa, r0: float, a: float, b0: float,
                                 kappa: float = 1.7, delta: float = 0.3
                                 ) -> PeelingBallooningResult:
    """Elliptical peeling-ballooning boundary (Snyder 2002/2011)."""
    j_edge, p_ped_pa = as_tensors(j_edge, p_ped_pa, dtype=qp.q.dtype, device=qp.q.device)
    q_edge = torch.clamp(qp.q_edge, min=1.01)
    f_shape = (1.0 + 0.5 * (kappa - 1.0)) * (1.0 + 0.8 * delta)
    b_pol_denom = 2.0 * math.pi * a * math.sqrt((1.0 + kappa**2) / 2.0)
    ip_approx = 2.0 * math.pi * a * b0 / (MU0 * q_edge * r0)
    b_pol = MU0 * ip_approx / b_pol_denom
    j_crit = torch.clamp(2.0 * b_pol * f_shape / (MU0 * q_edge**2 * r0), min=1e-6)

    s_edge = torch.clamp(qp.shear[-1], min=0.1)
    alpha_crit_base = torch.where(s_edge < 1.0, s_edge * (1.0 - s_edge / 2.0), 0.6 * s_edge)
    alpha_crit = torch.clamp(alpha_crit_base * (1.0 + 0.3 * (kappa - 1.0)), min=0.01)

    delta_ped = 0.05
    dp_dr = p_ped_pa / max(delta_ped * a, 1e-3)
    alpha_ped = 2.0 * MU0 * r0 * q_edge**2 / b0**2 * dp_dr

    j_norm = torch.abs(j_edge) / j_crit
    alpha_norm = alpha_ped / alpha_crit
    pb_radius = torch.sqrt(j_norm**2 + alpha_norm**2)
    dist = 1.0 - pb_radius
    return PeelingBallooningResult(j_norm, alpha_norm, dist, dist > 0.0, pb_radius > 1.2)


class StabilitySummary(NamedTuple):
    mercier: MercierResult
    ballooning: BallooningResult
    kruskal_shafranov: KruskalShafranovResult
    troyon: TroyonResult
    ntm: NTMResult
    rwm: RWMResult
    peeling_ballooning: PeelingBallooningResult
    overall_stable: torch.Tensor


def run_full_stability_check(rho: torch.Tensor, ne: torch.Tensor, ti: torch.Tensor,
                             te: torch.Tensor, j_bs: torch.Tensor, j_total: torch.Tensor, *,
                             r0: float, a: float, b0: float, ip_ma: float, beta_t, j_edge,
                             p_ped_pa, kappa: float = 1.7,
                             delta: float = 0.3) -> StabilitySummary:
    """All seven criteria in one pass (reference ``:434-500``)."""
    qp = compute_q_profile(rho, ne, ti, te, r0, a, b0, ip_ma, kappa, delta)
    mer = mercier_stability(qp)
    bal = ballooning_stability(qp)
    ks = kruskal_shafranov_stability(qp)
    troy = troyon_beta_limit(beta_t, ip_ma, a, b0, dtype=rho.dtype, device=rho.device)
    ntm = ntm_stability(qp, j_bs, j_total, a)
    rwm = rwm_stability(troy.beta_n)
    pb = peeling_ballooning_stability(qp, j_edge, p_ped_pa, r0, a, b0, kappa, delta)
    checked = torch.arange(rho.shape[0], device=rho.device) >= 5
    overall = (mer.all_stable & torch.all(bal.stable | ~checked)
               & ks.stable & troy.stable_nowall & rwm.stable & pb.stable)
    return StabilitySummary(mer, bal, ks, troy, ntm, rwm, pb, overall)
