"""Toroidal momentum transport and the L-H transition model (port of
``scpn_fusion_tpu/models/transport/momentum_lh.py``).

The rotation step is the thermal channels' Crank-Nicolson pattern (one Thomas
solve a step: one kernel launch on the card); the L-H state machine is the
Martin 2008 power threshold with hysteresis between the back and forward
transitions, branch-free (``torch.where``).  Scalar inputs may be Python
numbers or tensors; the L-H results are float64 tensors on ``h_mode``'s
device, as JAX's are float64 arrays with x64 on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.ops.tridiag import thomas_solve


def _floor(x, lo):
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) else max(x, lo)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


# ---------------------------------------------------------------------------
# L-H transition
# ---------------------------------------------------------------------------

def martin_lh_threshold_mw(ne20, b_t, surface_m2):
    """Martin et al. (2008): P_LH = 0.0488 ne20^0.717 B^0.803 S^0.941 [MW]."""
    return (0.0488 * _floor(ne20, 1e-6) ** 0.717
            * _floor(b_t, 1e-6) ** 0.803
            * _floor(surface_m2, 1e-6) ** 0.941)


def plasma_surface_area(r_m, a_m, kappa):
    return 4.0 * math.pi ** 2 * r_m * a_m * _sqrt(0.5 * (1.0 + kappa ** 2))


class LHState(NamedTuple):
    h_mode: torch.Tensor       # bool
    p_threshold_mw: torch.Tensor
    margin: torch.Tensor       # P_net / P_LH


def lh_transition_step(p_net_mw, ne20, b_t, r_m, a_m, kappa, h_mode: torch.Tensor,
                       *, hysteresis: float = 0.8) -> LHState:
    """Branch-free L-H / H-L update: forward transition when P_net > P_LH,
    back transition only when the power falls below ``hysteresis * P_LH``."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=h_mode.device) \
            if not isinstance(x, torch.Tensor) else x

    s = plasma_surface_area(r_m, a_m, kappa)
    p_lh = t(martin_lh_threshold_mw(ne20, b_t, s))
    p_net = t(p_net_mw)
    go_h = p_net > p_lh
    stay_h = p_net > hysteresis * p_lh
    new_mode = torch.where(h_mode, stay_h, go_h)
    return LHState(h_mode=new_mode, p_threshold_mw=p_lh,
                   margin=p_net / torch.clamp(p_lh, min=1e-9))


def confinement_multiplier(h_mode: torch.Tensor, *, h98_h: float = 1.0,
                           h98_l: float = 0.6) -> torch.Tensor:
    """H98 factor by confinement mode (L-mode ~0.6, H-mode ~1.0)."""
    full = torch.full_like(h_mode, h98_h, dtype=torch.float64)
    return torch.where(h_mode, full, torch.full_like(full, h98_l))


# ---------------------------------------------------------------------------
# Toroidal momentum transport
# ---------------------------------------------------------------------------

class MomentumParams(NamedTuple):
    r_m: torch.Tensor
    a_m: torch.Tensor
    prandtl: torch.Tensor      # chi_phi / chi_i
    pinch_v_m_s: torch.Tensor  # inward momentum pinch velocity (>0 inward)


def _trapezoid(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.trapezoid(y, x)``."""
    return 0.5 * ((x[1:] - x[:-1]) * (y[1:] + y[:-1])).sum(-1)


def nbi_torque_density(rho: torch.Tensor, p_nbi_mw, r_tangency_m, r_m, *,
                       deposition_width: float = 0.3, e_beam_kev: float = 500.0,
                       mass_amu: float = 2.0) -> torch.Tensor:
    """Gaussian-deposited NBI torque density: total torque T = P / v_beam *
    R_tan distributed over the profile."""
    v_beam = 4.38e5 * math.sqrt(max(e_beam_kev, 1.0) / mass_amu)
    total_torque = p_nbi_mw * 1e6 / v_beam * r_tangency_m
    shape = torch.exp(-(rho / deposition_width) ** 2)
    norm = _trapezoid(shape * rho, rho) * 2.0 * math.pi ** 2 * r_m * 1.0
    return total_torque * shape / torch.clamp(norm, min=1e-12)


def momentum_cn_step(omega: torch.Tensor, chi_i: torch.Tensor, torque: torch.Tensor,
                     n_i: torch.Tensor, rho: torch.Tensor, dt, params: MomentumParams,
                     *, edge_omega: float = 0.0) -> torch.Tensor:
    """One Crank-Nicolson step of the rotation diffusion equation (the
    inertia folded into the source term, reference reduced form)."""
    drho = rho[1] - rho[0]
    chi_phi = params.prandtl * chi_i
    alpha = chi_phi * dt / (2.0 * drho ** 2 * params.a_m ** 2)

    # inertia ~ n_i m R^2; torque -> domega source
    inertia = torch.clamp(n_i, min=1e-6) * 3.34e-27 * params.r_m ** 2 * 1e19
    src = torque * dt / torch.clamp(inertia, min=1e-30)

    lower = torch.cat([-alpha[1:-1], alpha.new_zeros(1)])
    upper = torch.cat([-alpha[0:1], -alpha[1:-1]])
    diag = torch.cat([1.0 + alpha[0:1], 1.0 + 2.0 * alpha[1:-1], alpha.new_ones(1)])
    # explicit half
    lap = torch.zeros_like(omega)
    lap[1:-1] = alpha[1:-1] * (omega[2:] - 2.0 * omega[1:-1] + omega[:-2])
    rhs = omega + lap + src
    # boundary rows: zero-gradient axis, Dirichlet edge
    rhs[-1] = edge_omega
    return thomas_solve(lower, diag, upper, rhs)


class RotationTrace(NamedTuple):
    omega: torch.Tensor        # (n_steps, n_rho)
    v_tor_core_m_s: torch.Tensor


def evolve_rotation(omega0: torch.Tensor, chi_i: torch.Tensor, torque: torch.Tensor,
                    n_i: torch.Tensor, rho: torch.Tensor, dt, n_steps: int,
                    params: MomentumParams) -> RotationTrace:
    om = omega0
    hist = []
    for _ in range(n_steps):
        om = momentum_cn_step(om, chi_i, torque, n_i, rho, dt, params)
        hist.append(om)
    hist_t = torch.stack(hist) if hist else omega0.new_zeros((0,) + tuple(omega0.shape))
    return RotationTrace(omega=hist_t, v_tor_core_m_s=hist_t[:, 0] * params.r_m)
