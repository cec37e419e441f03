"""Local kinetic ITG/TEM dispersion relation, resonant, complex root-find
(port of ``scpn_fusion_tpu/models/gyrokinetics/local_dispersion.py``).

The electrostatic gyrokinetic dispersion relation in the strong-ballooning
(outboard-midplane) limit with adiabatic electrons,

    eps(omega) = 1 + tau - I(omega) = 0,
    I(omega) = int d^3v F_M J0^2(k_perp rho)
               * (omega - omega_*n [1 + eta (E - 3/2)])
               / (omega - omega_D(E, lambda) - k_par v_par),

(Romanelli 1989 / Beer-Hammett family) on the (E, lambda) Gauss-Legendre
grid, solved for complex omega by damped Newton from every candidate of a
coarse (omega_r, gamma) grid at once, keeping the converged root of largest
growth rate.  Optional kinetic trapped electrons (bounce-averaged precession
with the Connor-Hastie-Taylor factor and a collisional boundary layer) and a
passing-electron Landau response, as in the JAX module, whose docstrings
give the physics.

Batching: every parameter may be a number or a tensor; they broadcast to
one batch shape (JAX ``vmap``s the function over k_y and over flux surfaces;
here a batch of k_y and surfaces is one call).  The Newton step's derivative
is the holomorphic derivative by forward-mode AD (``torch.func.jvp`` with a
unit tangent), where JAX takes ``jax.grad(holomorphic=True)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.special import ellipe, ellipk
from scpn_fusion_tpu_torch.models.gyrokinetics.species import VelocityGrid, bessel_j0


class LocalDispersionResult(NamedTuple):
    omega_r: torch.Tensor
    gamma: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor


# the coarse candidate grid of the root polish: 31 omega_r x 9 gamma
_WR_GRID = np.linspace(-6.0, 3.0, 31)
_GI_GRID = np.linspace(0.02, 1.2, 9)


def solve_local_kinetic_dispersion(
    k_y_rho_s,
    *,
    r_l_t,
    r_l_n,
    tau=1.0,           # T_i / T_e
    q=1.4,
    epsilon_r=0.18,    # r / R
    vgrid: VelocityGrid = VelocityGrid(n_energy=24, n_lambda=16),
    omega_guess=complex(-0.5, 0.3),
    n_iter: int = 60,
    kinetic_electrons: bool = False,
    r_l_te=0.0,
    nu_detrap=0.0,
    s_hat=0.8,
    n_kappa: int = 16,
    drift_envelope=1.0,
    omega_bl=None,
    passing_landau: bool = False,
    mass_ratio: float = 3670.5,   # m_D / m_e (deuterium plasma)
    device: torch.device | str = "cuda",
) -> LocalDispersionResult:
    """Solve eps(omega) = 0 for the most-unstable local mode (float64).

    Conventions: omega in c_s/R units; ion diamagnetic direction is
    negative omega_r (ITG), electron direction positive (TEM).  Tensor
    arguments set the device (``device`` where all are numbers) and, with
    their shapes, the batch shape of the result.
    """
    del omega_guess  # the candidate grid replaces a single guess, as in JAX
    params = [k_y_rho_s, r_l_t, r_l_n, tau, q, epsilon_r, r_l_te, nu_detrap, s_hat,
              drift_envelope] + ([] if omega_bl is None else [omega_bl])
    like = next((p for p in params if isinstance(p, torch.Tensor)), None)
    dev = like.device if like is not None else torch.device(device)
    f64 = torch.float64
    vals = torch.broadcast_tensors(*[torch.as_tensor(p, dtype=f64, device=dev)
                                     for p in params])
    (k_y, r_l_t, r_l_n, tau, q, epsilon_r, r_l_te, nu_detrap, s_hat,
     drift_envelope) = vals[:10]
    omega_bl = vals[10] if omega_bl is not None else None

    def b(x):   # a batch value against the grid's trailing dims
        return x[..., None]

    energy, e_w, lam, l_w = vgrid.nodes(f64, dev)
    ee = energy[:, None].expand(-1, lam.shape[0]).reshape(-1)
    ll = lam[None, :].expand(energy.shape[0], -1).reshape(-1)
    w = (e_w[:, None] * l_w[None, :]).reshape(-1)

    # Maxwellian weight over the (E, lambda) grid (pitch measure uniform).
    fm = (2.0 / math.sqrt(math.pi)) * torch.sqrt(ee) * torch.exp(-ee) * w

    # Outboard-midplane quantities (s-alpha, theta = 0):
    xi_sq = torch.clamp(1.0 - ll, min=0.0)              # B ~ B0 at theta=0
    v_par = torch.sqrt(2.0 * ee * xi_sq)
    e_perp = ee * ll
    omega_d = -b(k_y) * (v_par**2 / 2.0 + e_perp) * b(drift_envelope)
    k_par = 1.0 / q
    j0 = bessel_j0(b(k_y) * torch.sqrt(2.0 * torch.clamp(e_perp, min=0.0)))

    # Ion diamagnetic frequencies (ion direction negative).
    omega_star_n = -k_y * r_l_n
    eta_i = torch.where(torch.abs(r_l_n) > 1e-10,
                        r_l_t / torch.clamp(r_l_n, min=1e-10), torch.zeros_like(r_l_n))
    omega_star = b(omega_star_n) * (1.0 + b(eta_i) * (ee - 1.5))

    # Trapped-electron kinetic response pieces (only used when enabled).
    f_t = torch.sqrt(2.0 * epsilon_r / (1.0 + epsilon_r))
    if omega_bl is None:
        omega_bl_v = (k_y / tau) * torch.abs(r_l_n)
    else:
        omega_bl_v = torch.abs(omega_bl)
    bl = torch.sqrt(nu_detrap / torch.clamp(omega_bl_v, min=1e-10))
    f_t = f_t * torch.clamp(1.0 - bl, 0.0, 1.0)
    omega_star_e = b(k_y / tau) * (b(r_l_n) + b(r_l_te) * (ee - 1.5))

    x_np, w_np = np.polynomial.legendre.leggauss(n_kappa)
    x_k = torch.as_tensor(x_np, dtype=f64, device=dev)
    w_k = torch.as_tensor(w_np, dtype=f64, device=dev)
    kap2 = 0.5 * (x_k + 1.0) * 0.994 + 0.003      # kappa^2 in (0, 1)
    ek_ratio = ellipe(kap2) / ellipk(kap2)
    g_prec = 2.0 * ek_ratio - 1.0 + 4.0 * b(s_hat) * (kap2 - 1.0 + ek_ratio)
    w_pitch = w_k * ellipk(kap2)
    w_pitch = w_pitch / torch.sum(w_pitch)

    # (E, kappa) precession resonance grid: omega_De = (ky/2 tau) E G.
    omega_de = (b(b(0.5 * (k_y / tau) * drift_envelope))
                * ee[:, None] * g_prec[..., None, :])

    # omega: (*batch, C); the grid terms gain a candidate axis
    def c(x):
        return x.unsqueeze(-2)

    # fm J0^2, the integrand's weight (the same product JAX forms first)
    weight_c, omega_d_c, omega_star_c = c(fm * j0**2), c(omega_d), c(omega_star)
    k_par_c = k_par[..., None, None]
    tau_c = tau[..., None]
    f_t_c = f_t[..., None]

    def epsilon_fn(omega):
        om = omega[..., None]
        denom = om - omega_d_c - k_par_c * v_par
        # Landau-safe: omega carries Im > 0 during iteration; add tiny +i0.
        denom = denom + 1e-12j
        num = weight_c * (om - omega_star_c)
        integrand = num / denom
        # Both v_par signs: average over +v_par and -v_par transit.
        denom_m = om - omega_d_c + k_par_c * v_par + 1e-12j
        integrand_m = num / denom_m
        i_val = 0.5 * torch.sum(integrand + integrand_m, dim=-1)
        if not kinetic_electrons:
            return 1.0 + 1.0 / tau_c - i_val
        om2 = omega[..., None, None]
        k_e = torch.sum(
            (fm[:, None] * w_pitch[None, :])
            * (om2 - omega_star_e[..., None, :, None])
            / (om2 - omega_de[..., None, :, :] + 1j * (nu_detrap[..., None, None, None] + 1e-12)),
            dim=(-2, -1))
        if not passing_landau:
            return (1.0 + (1.0 - f_t_c) / tau_c + (f_t_c / tau_c) * (1.0 - k_e)
                    - i_val)
        v_par_e = v_par * math.sqrt(mass_ratio)
        num_p = om - omega_star_e[..., None, :]
        k_p = 0.5 * torch.sum(
            fm * num_p * (1.0 / (om - k_par_c * v_par_e + 1e-12j)
                          + 1.0 / (om + k_par_c * v_par_e + 1e-12j)), dim=-1)
        return (1.0 + ((1.0 - f_t_c) / tau_c) * (1.0 - k_p)
                + (f_t_c / tau_c) * (1.0 - k_e) - i_val)

    # Robust MOST-UNSTABLE root find: polish EVERY coarse-grid candidate
    # with damped Newton (exact holomorphic derivative, all candidates in one
    # batch) and select the converged root with the LARGEST growth rate.
    wrg, gig = np.meshgrid(_WR_GRID, _GI_GRID, indexing="ij")
    cand = torch.as_tensor((wrg + 1j * gig).reshape(-1), dtype=torch.complex128, device=dev)
    z = cand.expand(*k_y.shape, -1).clone()
    ones = torch.ones_like(z)
    for _ in range(n_iter):
        f, df = torch.func.jvp(epsilon_fn, (z,), (ones,))
        big = torch.abs(df) > 1e-14
        step = torch.where(big, f / torch.where(big, df, torch.ones_like(df)),
                           torch.zeros_like(f))
        # Damped, bounded update.
        step = torch.where(torch.abs(step) < 1.0, step, step / torch.abs(step))
        z_new = z - 0.8 * step
        z = torch.where(torch.abs(z_new) < 50.0, z_new, z)
    resids = torch.abs(epsilon_fn(z))
    ok = (resids < 1e-6) & (z.imag > 1e-4) & (torch.abs(z) < 20.0)
    score = torch.where(ok, z.imag, torch.full_like(z.imag, -math.inf))
    best = torch.argmax(score, dim=-1)
    any_ok = torch.any(ok, dim=-1)
    # Fall back to the overall min-residual root when nothing grows.
    fallback = torch.argmin(resids, dim=-1)
    idx = torch.where(any_ok, best, fallback)[..., None]
    omega = torch.gather(z, -1, idx)[..., 0]
    resid = torch.gather(resids, -1, idx)[..., 0]
    return LocalDispersionResult(
        omega_r=omega.real, gamma=torch.where(any_ok, omega.imag, torch.zeros_like(omega.imag)),
        residual=resid, converged=resid < 1e-6)


def growth_rate_spectrum(
    k_y_values,
    *,
    r_l_t,
    r_l_n,
    tau=1.0,
    q: float = 1.4,
    vgrid: VelocityGrid = VelocityGrid(n_energy=24, n_lambda=16),
    device: torch.device | str = "cuda",
):
    """Scan k_y: returns (omega_r, gamma), every k_y in one batch."""
    out = solve_local_kinetic_dispersion(
        torch.as_tensor(k_y_values, dtype=torch.float64,
                        device=k_y_values.device if isinstance(k_y_values, torch.Tensor)
                        else device),
        r_l_t=r_l_t, r_l_n=r_l_n, tau=tau, q=q, vgrid=vgrid, device=device)
    return out.omega_r, out.gamma
