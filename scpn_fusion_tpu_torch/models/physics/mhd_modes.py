"""Discrete MHD mode models: TAE, tearing/Rutherford, locked mode, MRTI
(port of ``scpn_fusion_tpu/models/physics/mhd_modes.py``).

Role-parity with the reference's mode-physics modules (TAE gap frequencies
and a fast-ion drive screen, cylindrical Delta' and Rutherford island
evolution, the locked-mode torque-balance bifurcation, magneto-Rayleigh-
Taylor growth).  The island and torque evolutions are Python loops of a few
0-d ops a step on plain PyTorch ops (the JAX package's ``lax.scan``).

The functions take numbers or tensors: a tensor among the inputs sets the
device (and dtype), else ``dtype`` (float32; JAX takes its float from the
x64 flag) and ``device`` (``"cuda"``) do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

MU0 = 4.0e-7 * math.pi
M_D = 3.3436e-27


# ---------------------------------------------------------------------------
# Toroidal Alfven eigenmodes
# ---------------------------------------------------------------------------

class TAEResult(NamedTuple):
    f_tae_hz: torch.Tensor        # gap-centre frequency
    gap_width_hz: torch.Tensor
    v_alfven_m_s: torch.Tensor
    drive_ratio: torch.Tensor     # fast-ion drive / total damping
    unstable: torch.Tensor


def alfven_speed(b_t, n_i_19, m_ion_kg: float = M_D, *, dtype=None, device="cuda"):
    b_t, n_i_19 = as_tensors(b_t, n_i_19, dtype=dtype, device=device)
    rho = torch.clamp(n_i_19, min=1e-6) * 1e19 * m_ion_kg
    return b_t / torch.sqrt(MU0 * rho)


def tae_frequency(b_t, n_i_19, q, r0_m, *, dtype=None, device="cuda"):
    """TAE gap centre f = v_A / (4 pi q R)."""
    b_t, n_i_19, q, r0_m = as_tensors(b_t, n_i_19, q, r0_m, dtype=dtype, device=device)
    return alfven_speed(b_t, n_i_19) / (4.0 * math.pi * torch.clamp(q, min=0.1) * r0_m)


def tae_stability(*, b_t, n_i_19, q, r0_m, a_m, beta_fast_pct, v_fast_over_va,
                  damping_rate: float = 0.01, dtype=None, device="cuda") -> TAEResult:
    """Reduced TAE drive/damping screen: unstable when the fast-ion drive
    (super-Alfvenic) exceeds the lumped damping."""
    b_t, n_i_19, q, r0_m, a_m, beta_fast_pct, v_fast_over_va, damping = as_tensors(
        b_t, n_i_19, q, r0_m, a_m, beta_fast_pct, v_fast_over_va, damping_rate, dtype=dtype,
        device=device)
    v_a = alfven_speed(b_t, n_i_19)
    f0 = tae_frequency(b_t, n_i_19, q, r0_m)
    eps = a_m / r0_m
    gap = f0 * 2.0 * eps                       # gap width ~ 2 eps f0
    resonant = torch.clamp(v_fast_over_va - 1.0, min=0.0)
    drive = 0.5 * (beta_fast_pct / 100.0) * resonant
    ratio = drive / torch.clamp(damping, min=1e-12)
    return TAEResult(f_tae_hz=f0, gap_width_hz=gap, v_alfven_m_s=v_a,
                     drive_ratio=ratio, unstable=ratio > 1.0)


# ---------------------------------------------------------------------------
# Tearing modes: Delta' + Rutherford island evolution
# ---------------------------------------------------------------------------

class TearingResult(NamedTuple):
    delta_prime: torch.Tensor
    classically_unstable: torch.Tensor
    r_s_m: torch.Tensor           # rational-surface minor radius


def _gradient(y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``jnp.gradient(y, h)`` with a scalar spacing: central inside,
    one-sided at the ends."""
    inner = (y[2:] - y[:-2]) * 0.5 / h
    return torch.cat([((y[1] - y[0]) / h)[None], inner, ((y[-1] - y[-2]) / h)[None]])


def delta_prime_cylindrical(rho: torch.Tensor, q: torch.Tensor, j_phi: torch.Tensor, a_m, *,
                            m: int = 2, n: int = 1) -> TearingResult:
    """Cylindrical tearing-stability index for the (m, n) surface:
    ``Delta' r_s ~ -2m + alpha (r_s |dj/dr| / j(0))`` at the rational
    surface, the vacuum index -2m off the grid."""
    q_rat = m / n
    idx = torch.argmin(torch.abs(q - q_rat))
    r_s = rho[idx] * a_m
    dj = _gradient(j_phi, rho[1] - rho[0])
    j0 = torch.clamp(torch.abs(j_phi[0]), min=1e-12)
    drive = torch.abs(dj[idx]) * rho[idx] / j0
    dp = (-2.0 * m + 8.0 * drive) / torch.clamp(r_s, min=1e-6)
    on_grid = torch.abs(q[idx] - q_rat) < 0.5
    dp = torch.where(on_grid, dp, -2.0 * m / torch.clamp(r_s, min=1e-6))
    return TearingResult(delta_prime=dp, classically_unstable=dp > 0.0, r_s_m=r_s)


class IslandTrace(NamedTuple):
    w_m: torch.Tensor             # island width history
    saturated_w_m: torch.Tensor
    locked_risk: torch.Tensor     # width above the locking threshold


def rutherford_island_evolution(*, delta_prime, r_s_m, eta_ohm_m, w0_m: float = 1e-3,
                                w_sat_cap_m: float = 0.3, dt: float = 1e-3,
                                n_steps: int = 2000, lock_threshold_m: float = 0.05,
                                dtype=None, device="cuda") -> IslandTrace:
    """Modified Rutherford equation dw/dt = (eta/mu0)(Delta' - alpha w);
    saturated width from Delta'(w) = Delta' - alpha w."""
    delta_prime, r_s_m, eta_ohm_m = as_tensors(delta_prime, r_s_m, eta_ohm_m, dtype=dtype,
                                               device=device)
    tau_factor = 1.22 * eta_ohm_m / MU0
    alpha = torch.abs(delta_prime) / max(w_sat_cap_m, 1e-6)
    w, hist = torch.full_like(delta_prime, w0_m), []
    for _ in range(n_steps):
        dwdt = tau_factor * (delta_prime - alpha * w)
        w = torch.clamp(w + dt * dwdt, 0.0, 1.0)
        hist.append(w)
    hist = torch.stack(hist)
    w_sat = torch.where(delta_prime > 0, delta_prime / torch.clamp(alpha, min=1e-12),
                        torch.zeros_like(alpha))
    return IslandTrace(w_m=hist, saturated_w_m=w_sat, locked_risk=hist[-1] > lock_threshold_m)


# ---------------------------------------------------------------------------
# Locked mode (torque balance bifurcation)
# ---------------------------------------------------------------------------

class LockedModeResult(NamedTuple):
    omega_final: torch.Tensor     # final island rotation / omega0
    locked: torch.Tensor
    braking_torque_ratio: torch.Tensor


def locked_mode_evolution(*, w_island_m, b_error_mt, omega0_hz, viscous_time_s: float = 0.1,
                          r_s_m: float = 1.0, dt: float = 1e-3, n_steps: int = 3000,
                          dtype=None, device="cuda") -> LockedModeResult:
    """Island rotation braking by the error-field wall torque, normalised
    ``dx/dtau = (1 - x) - kappa x / (x^2 + delta^2)`` with the braking number
    ``kappa ~ (w^2 B_err)^2``: beyond a critical error field the fast root
    disappears and the rotation collapses (locked)."""
    w_island_m, b_error_mt = as_tensors(w_island_m, b_error_mt, dtype=dtype, device=device)
    w_ref, b_ref_mt, gain, delta = 0.05, 1.0, 0.05, 0.05
    kappa = ((w_island_m / w_ref) ** 2 * (b_error_mt / b_ref_mt)) ** 2 * gain
    d_tau = dt / viscous_time_s
    x = torch.ones_like(kappa)
    for _ in range(n_steps):
        dx = (1.0 - x) - kappa * x / (x ** 2 + delta ** 2)
        x = torch.clamp(x + d_tau * dx, 0.0, 2.0)
    return LockedModeResult(omega_final=x, locked=x < 0.1, braking_torque_ratio=kappa)


# ---------------------------------------------------------------------------
# Magneto-Rayleigh-Taylor
# ---------------------------------------------------------------------------

class MRTIResult(NamedTuple):
    gamma_s: torch.Tensor         # growth rate (0 when stabilised)
    k_cutoff_m: torch.Tensor      # wavenumber above which tension stabilises
    stabilised: torch.Tensor


def mrti_growth_rate(*, g_eff_m_s2, k_m, b_t, n_i_19, theta_kb_rad=0.0, atwood: float = 1.0,
                     dtype=None, device="cuda") -> MRTIResult:
    """MRT dispersion: gamma^2 = A g k - (k . B)^2 / (mu0 rho)."""
    g_eff_m_s2, k_m, b_t, n_i_19, theta = as_tensors(
        g_eff_m_s2, k_m, b_t, n_i_19, theta_kb_rad, dtype=dtype, device=device)
    rho = torch.clamp(n_i_19, min=1e-6) * 1e19 * M_D
    k_par = k_m * torch.cos(theta)
    tension = (k_par * b_t) ** 2 / (MU0 * rho)
    gamma2 = atwood * g_eff_m_s2 * k_m - tension
    gamma = torch.sqrt(torch.clamp(gamma2, min=0.0))
    cos2 = torch.clamp(torch.cos(theta) ** 2, min=1e-12)
    k_cut = atwood * g_eff_m_s2 * MU0 * rho / (b_t ** 2 * cos2)
    return MRTIResult(gamma_s=gamma, k_cutoff_m=k_cut, stabilised=gamma2 <= 0.0)
