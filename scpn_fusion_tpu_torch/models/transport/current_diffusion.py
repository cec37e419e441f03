"""Resistive poloidal-flux diffusion and q-profile evolution (port of
``scpn_fusion_tpu/models/transport/current_diffusion.py``).

Crank-Nicolson step of ``dpsi/dt = D(rho) L[psi] + R0 eta j_source`` with
``D = eta_neo / (mu0 a^2)`` and the cylindrical ``L = d_rr + (1/r) d_r``,
the Sauter neoclassical parallel resistivity, a L'Hopital axis row, a
Dirichlet edge and ``q(rho) = -rho a^2 B0 / (R0 dpsi/drho)``; each step is
one Thomas solve (one kernel launch on the card), the time loop a Python
loop where JAX has ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from scpn_fusion_tpu_torch.models.transport.solver import _scalar, rho_grid
from scpn_fusion_tpu_torch.ops.tridiag import thomas_solve

MU_0 = 4.0e-7 * math.pi
E_CHARGE = 1.602e-19
M_E = 9.109e-31
EPS0 = 8.854e-12


def neoclassical_resistivity(te_kev, ne_19, z_eff, epsilon, q, r0) -> torch.Tensor:
    """Sauter neoclassical parallel resistivity [Ohm m]: ``eta_Spitzer /
    F33(f_t)`` with the Sauter 1999 (PoP 6:2834) Eq. 13a banana-limit
    conductivity reduction and the standard trapped-fraction interpolation."""
    te = torch.clamp(te_kev, min=1e-3)
    eps = torch.clamp(epsilon, min=1e-6)
    ln_lambda = 17.0
    eta_spitzer = 1.65e-9 * z_eff * ln_lambda / te**1.5
    f_t = 1.0 - (1.0 - eps) ** 2 / (torch.sqrt(torch.clamp(1.0 - eps**2, min=1e-12))
                                    * (1.0 + 1.46 * torch.sqrt(eps)))
    f_t = torch.clamp(f_t, 0.0, 1.0)
    f33 = (1.0 - (1.0 + 0.36 / z_eff) * f_t
           + (0.59 / z_eff) * f_t**2 - (0.23 / z_eff) * f_t**3)
    eta_neo = eta_spitzer / torch.clamp(f33, 0.05, 1.0)
    return torch.maximum(eta_neo, eta_spitzer)


def q_from_psi(rho: torch.Tensor, psi: torch.Tensor, r0: float, a: float,
               b0: float) -> torch.Tensor:
    """q(rho) = -rho a^2 B0 / (R0 dpsi/drho), L'Hopital at the axis."""
    drho = rho[1] - rho[0]
    interior = (psi[2:] - psi[:-2]) / (2.0 * drho)
    left = (psi[1] - psi[0]) / drho
    right = (psi[-1] - psi[-2]) / drho
    dpsi = torch.cat([left[None], interior, right[None]])
    denom = r0 * dpsi
    ok = denom.abs() > 1e-12
    q = torch.where(ok, -rho * a**2 * b0 / torch.where(ok, denom, 1.0), 1.0)
    d2psi = (psi[2] - 2 * psi[1] + psi[0]) / drho**2
    ok0 = d2psi.abs() > 1e-12
    q0 = torch.where(ok0, -(a**2) * b0 / (r0 * torch.where(ok0, d2psi, 1.0)), q[1])
    return torch.cat([q0[None], q[1:]]).abs()


def resistive_diffusion_time(a: float, eta) -> torch.Tensor:
    """tau_R = mu0 a^2 / eta [s]."""
    if isinstance(eta, torch.Tensor):
        return MU_0 * a**2 / torch.clamp(eta, min=1e-12)
    return MU_0 * a**2 / max(eta, 1e-12)


@dataclasses.dataclass(frozen=True)
class CurrentDiffusionParams:
    nr: int
    r0: float
    a: float
    b0: float

    def rho(self, dtype: torch.dtype = torch.float64,
            device: torch.device | str = "cuda") -> torch.Tensor:
        return rho_grid(self.nr, dtype, torch.device(device))


def initial_psi(params: CurrentDiffusionParams, dtype: torch.dtype = torch.float64,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Integrate dpsi/drho = -rho a^2 B0 / (R0 q) for q = 1 + 2 rho^2
    (trapezoidal), anchored at psi(edge) = 0."""
    rho = params.rho(dtype, device)
    drho = 1.0 / (params.nr - 1)
    q_r = 1.0 + 2.0 * rho**2
    dpsi = -rho * params.a**2 * params.b0 / (params.r0 * q_r)
    increments = torch.cat([rho.new_zeros(1), 0.5 * (dpsi[1:] + dpsi[:-1]) * drho])
    psi = torch.cumsum(increments, dim=0)
    return psi - psi[-1]


def step_current_diffusion(params: CurrentDiffusionParams, psi: torch.Tensor, dt, te, ne,
                           z_eff, j_source) -> torch.Tensor:
    """One Crank-Nicolson flux-diffusion step (reference ``step``)."""
    rho = params.rho(psi.dtype, psi.device)
    drho = 1.0 / (params.nr - 1)

    q_prof = q_from_psi(rho, psi, params.r0, params.a, params.b0)
    eps = rho * params.a / params.r0
    eta = neoclassical_resistivity(te, ne, z_eff, eps, q_prof, params.r0)
    d = eta / (MU_0 * params.a**2)

    alpha = dt / 2.0
    drho2 = drho**2
    r_int = rho[1:-1]
    coeff_prev = d[1:-1] * (1.0 / drho2 - 1.0 / (2.0 * r_int * drho))
    coeff_curr = d[1:-1] * (-2.0 / drho2)
    coeff_next = d[1:-1] * (1.0 / drho2 + 1.0 / (2.0 * r_int * drho))

    # Axis: L(psi)_0 = 4 D_0 (psi_1 - psi_0)/drho^2 (L'Hopital).
    ax = 4.0 * d[0] / drho2
    l_psi = coeff_prev * psi[:-2] + coeff_curr * psi[1:-1] + coeff_next * psi[2:]
    sub = torch.cat([-alpha * coeff_prev, psi.new_zeros(1)])
    diag = torch.cat([(1.0 + alpha * ax)[None], 1.0 - alpha * coeff_curr, psi.new_ones(1)])
    sup = torch.cat([(-alpha * ax)[None], -alpha * coeff_next])
    rhs = torch.cat([
        (psi[0] + alpha * ax * (psi[1] - psi[0]) + dt * params.r0 * eta[0] * j_source[0])[None],
        psi[1:-1] + alpha * l_psi + dt * params.r0 * eta[1:-1] * j_source[1:-1],
        psi[-1:]])
    return thomas_solve(sub, diag, sup, rhs)


def run_current_diffusion(params: CurrentDiffusionParams, psi0: torch.Tensor, dt, te, ne,
                          z_eff, j_source, *, n_steps: int):
    """Evolve psi for ``n_steps``; returns (psi_final, {"q0", "q_edge"}
    traces, stacked)."""
    dt = _scalar(dt, psi0)
    p = psi0
    q0, q_edge = [], []
    for _ in range(n_steps):
        p = step_current_diffusion(params, p, dt, te, ne, z_eff, j_source)
        q = q_from_psi(params.rho(p.dtype, p.device), p, params.r0, params.a, params.b0)
        q0.append(q[0])
        q_edge.append(q[-1])
    if not q0:
        return p, {"q0": p.new_zeros(0), "q_edge": p.new_zeros(0)}
    return p, {"q0": torch.stack(q0), "q_edge": torch.stack(q_edge)}
