"""Charge-state-resolved impurity transport: ionisation ladder and radiation
(port of ``scpn_fusion_tpu/models/transport/impurity.py``).

The ladder ``dn_z/dt = S_{z-1} n_{z-1} - (S_z + R_z) n_z + R_{z+1} n_{z+1} +
(1/r) d/dr (r D dn_z/dr)`` with ADAS-shaped analytic rates, one
operator-split step: backward Euler on the ladder (tridiagonal in z, one
system a radius) and CN diffusion in radius (one system a charge state).
Each of the two is ONE batched Thomas call (one kernel launch on the card),
where JAX solves the ladder with ``vmap`` and diffuses each state with
``vmap``.  The coronal equilibrium is closed form; line radiation uses the
cooling-rate closure.  Where JAX takes ``core.dtypes.default_float()`` the
port takes the input's dtype (float64 for a Python number).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.transport.solver import (
    build_cn_tridiag,
    explicit_diffusion_rhs,
)
from scpn_fusion_tpu_torch.ops.tridiag import thomas_solve_batched


@dataclasses.dataclass(frozen=True)
class ImpuritySpecies:
    """Analytic ADAS-shaped rate model for one impurity element.

    S_z(T) = s0 (z+1) sqrt(T) exp(-chi_z / T),  chi_z = chi0 (z+1)^2
    R_z(T) = r0 z^2 / sqrt(T)
    """

    z_max: int = 10           # highest charge state tracked
    chi0_ev: float = 13.6     # ionisation-potential scale [eV]
    s0: float = 1e-14         # ionisation prefactor [m^3/s]
    r0: float = 1e-19         # recombination prefactor [m^3/s]

    def ionisation_rate(self, t_e_ev, z):
        chi = self.chi0_ev * (z + 1.0) ** 2
        t = torch.clamp(t_e_ev, min=0.1)
        return self.s0 * (z + 1.0) * torch.sqrt(t) * torch.exp(-chi / t)

    def recombination_rate(self, t_e_ev, z):
        t = torch.clamp(t_e_ev, min=0.1)
        return self.r0 * z**2 / torch.sqrt(t)


def coronal_equilibrium(species: ImpuritySpecies, t_e_ev, n_total=1.0, *,
                        dtype: torch.dtype = torch.float64,
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """Closed-form coronal charge-state distribution at one T_e (a number or
    a 0-d tensor, whose dtype and device then win): the balance
    S_z n_z = R_{z+1} n_{z+1} gives the ratios, normalised to ``n_total``."""
    if isinstance(t_e_ev, torch.Tensor):
        dtype, device = t_e_ev.dtype, t_e_ev.device
    t_e = torch.as_tensor(t_e_ev, dtype=dtype, device=device)
    z = torch.arange(species.z_max + 1, dtype=dtype, device=device)[:-1]
    ratio = species.ionisation_rate(t_e, z) / torch.clamp(
        species.recombination_rate(t_e, z + 1.0), min=1e-30)
    log_ratios = torch.log(torch.clamp(ratio, min=1e-300))
    log_n = torch.cat([log_ratios.new_zeros(1), torch.cumsum(log_ratios, dim=0)])
    log_n = log_n - torch.max(log_n)
    n = torch.exp(log_n)
    return n_total * n / torch.sum(n)


class ImpurityState(NamedTuple):
    n_z: torch.Tensor     # (Z+1, nr) charge-state densities [1e19 m^-3]


def impurity_step(species: ImpuritySpecies, state: ImpurityState, t_e_ev, n_e_19, d_imp, rho,
                  dt, *, edge_source_1e19: float = 0.0) -> ImpurityState:
    """One operator-split step: implicit atomic rates, then CN radial
    diffusion of every charge state (only the neutral stage gets the edge
    source)."""
    n_z = state.n_z
    zp1, _ = n_z.shape
    drho = rho[1] - rho[0]
    n_e_m3 = torch.clamp(n_e_19, min=1e-3) * 1e19

    z_states = torch.arange(zp1, dtype=n_z.dtype, device=n_z.device)[:, None]
    s_z = species.ionisation_rate(t_e_ev, z_states) * n_e_m3[None, :]   # (Z+1, nr) [1/s]
    r_z = species.recombination_rate(t_e_ev, z_states) * n_e_m3[None, :]
    s_z[-1] = 0.0             # fully stripped cannot ionise
    r_z[0] = 0.0              # neutral cannot recombine

    # Backward-Euler ladder (tridiagonal in z) for every radius at once:
    # (I - dt A) n^{new} = n.
    sub = -dt * s_z[:-1, :]               # from z-1 ionising into z
    diag = 1.0 + dt * (s_z + r_z)
    sup = -dt * r_z[1:, :]                # from z+1 recombining into z
    n_new = thomas_solve_batched(sub.T, diag.T, sup.T, n_z.T).T
    n_new = torch.clamp(n_new, min=0.0)

    # Radial CN diffusion of every charge state (one batched solve).
    lh = explicit_diffusion_rhs(n_new, d_imp, rho, drho)
    rhs = n_new + 0.5 * dt * lh
    a, b, c = build_cn_tridiag(d_imp, dt, rho, drho)
    b[0] = 1.0
    b[-1] = 1.0
    c[0] = -1.0
    a[-1] = 0.0
    rhs[:, 0] = 0.0
    rhs[:, -1] = edge_source_1e19
    out = thomas_solve_batched(a.expand(zp1, -1), b.expand(zp1, -1), c.expand(zp1, -1), rhs)
    out[:, 0] = out[:, 1]
    n_diff = torch.clamp(out, min=0.0)
    n_diff[:, -1] = 0.0
    n_diff[0, -1] = edge_source_1e19
    return ImpurityState(n_diff)


def line_radiation_w_m3(species: ImpuritySpecies, state: ImpurityState, t_e_ev, n_e_19):
    """Total line radiation: P = n_e sum_z n_z L_z(T), with the cooling rate
    L_z ~ c0 z^2 / sqrt(T) exp(-E_line/T) (coronal closure)."""
    zp1 = state.n_z.shape[0]
    z_states = torch.arange(zp1, dtype=state.n_z.dtype, device=state.n_z.device)
    t = torch.clamp(t_e_ev, min=0.1)
    lz = 1e-33 * z_states[:, None] ** 2 / torch.sqrt(t)[None, :] \
        * torch.exp(-10.0 * z_states[:, None] / t[None, :])
    # densities in 1e19: the 1e38 folded on the host (f32-safe)
    return (n_e_19[None, :] * state.n_z) * (lz * 1e38)


def run_impurity(species: ImpuritySpecies, state: ImpurityState, t_e_ev, n_e_19, d_imp, rho, dt,
                 *, n_steps: int, edge_source_1e19: float = 0.0):
    """Evolve the impurity system; returns (state, {"p_rad_total",
    "n_total"} traces, stacked)."""
    p_rad, n_tot = [], []
    for _ in range(n_steps):
        state = impurity_step(species, state, t_e_ev, n_e_19, d_imp, rho, dt,
                              edge_source_1e19=edge_source_1e19)
        p_rad.append(torch.sum(line_radiation_w_m3(species, state, t_e_ev, n_e_19)))
        n_tot.append(torch.sum(state.n_z))
    if not p_rad:
        empty = state.n_z.new_zeros(0)
        return state, {"p_rad_total": empty, "n_total": empty}
    return state, {"p_rad_total": torch.stack(p_rad), "n_total": torch.stack(n_tot)}
