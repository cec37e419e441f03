"""TEMHD-stabilised liquid-metal divertor layer (thermoelectric MHD) (port of
``scpn_fusion_tpu/models/nuclear/temhd.py``).

Implicit 1D heat conduction through a thin liquid-lithium layer where
thermoelectric currents J = -sigma S grad(T) crossed with the tokamak field
drive convection that boosts the effective conductivity (reference
``TEMHD_Stabilizer``), and the heat-flux scan (``run_temhd_experiment``).

Each step's tridiagonal solve is ``ops.tridiag.thomas_solve_batched``: one
launch of row T a step on the card, for one flux or for every flux of
:func:`temhd_flux_scan` at once (JAX's ``vmap``: the fluxes are one batch).
The transient is a Python loop of steps with no host read; its boundary
rows are out-of-place writes.  ``jnp.gradient`` is
``frc_stability.gradient``.  The entry points take ``dtype`` (JAX reads its
x64 flag; float32 by default here) and ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors
from scpn_fusion_tpu_torch.models.physics.frc_stability import gradient
from scpn_fusion_tpu_torch.ops.tridiag import thomas_solve_batched


@dataclasses.dataclass(frozen=True)
class TEMHDParams:
    layer_thickness_mm: float = 5.0
    b_field_t: float = 10.0
    n_cells: int = 50
    rho_kg_m3: float = 500.0        # liquid lithium
    cp_j_kg_k: float = 4200.0
    k_thermal_w_m_k: float = 50.0
    seebeck_v_k: float = 20e-6
    sigma_s_m: float = 3e6
    viscosity_pa_s: float = 1e-3
    t_wall_k: float = 300.0

    @property
    def dz_m(self) -> float:
        return self.layer_thickness_mm * 1e-3 / (self.n_cells - 1)


class TEMHDState(NamedTuple):
    t_k: torch.Tensor            # (n_cells,) temperature profile, (n_fluxes, n_cells) a scan


class TEMHDTrace(NamedTuple):
    surface_t_k: torch.Tensor    # (n_steps,)
    k_eff_max: torch.Tensor      # (n_steps,)
    state: TEMHDState


def init_temhd(p: TEMHDParams, *, dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda") -> TEMHDState:
    return TEMHDState(t_k=torch.full((p.n_cells,), p.t_wall_k, dtype=dtype, device=device))


def _step(p: TEMHDParams, t: torch.Tensor, q_in: torch.Tensor, dt: float, dz_t: torch.Tensor):
    """One implicit step of the profiles ``t`` (..., n) under the incident
    fluxes ``q_in`` (..., 1) [W/m^2]: (t', surface temperature, max k_eff)."""
    dz = p.dz_m
    grad_t = gradient(t, dz_t)
    j_te = -p.sigma_s_m * p.seebeck_v_k * grad_t
    f_lorentz = torch.abs(j_te * p.b_field_t)
    v_conv = f_lorentz * dz ** 2 / (p.viscosity_pa_s + 1e-9)
    alpha = p.k_thermal_w_m_k / (p.rho_kg_m3 * p.cp_j_kg_k)
    peclet = torch.clamp(v_conv * dz / alpha, 0.0, 200.0)
    k_eff = torch.clamp(p.k_thermal_w_m_k * (1.0 + 0.2 * peclet), min=1e-9)

    r = k_eff * dt / (p.rho_kg_m3 * p.cp_j_kg_k * dz ** 2)
    # implicit interior rows for cells 1..N-1 (cell 0 pinned at T_wall)
    lower = -r[..., 2:]
    upper = -r[..., 1:-1]
    # Neumann heat-flux boundary at the plasma-facing surface
    diag = torch.cat([1.0 + 2.0 * r[..., 1:-1], 1.0 + r[..., -1:]], dim=-1)
    rhs = t[..., 1:]
    rhs = torch.cat([rhs[..., :1] + r[..., 1:2] * p.t_wall_k, rhs[..., 1:]], dim=-1)
    rhs = torch.cat([rhs[..., :-1], rhs[..., -1:] + r[..., -1:] * q_in * dz / k_eff[..., -1:]],
                    dim=-1)
    batch = t.shape[:-1]
    t_new = thomas_solve_batched(*(x.reshape(-1, x.shape[-1]) for x in (lower, diag, upper, rhs)))
    t1 = torch.cat([torch.full((*batch, 1), p.t_wall_k, dtype=t.dtype, device=t.device),
                    t_new.reshape(*batch, -1)], dim=-1)
    return t1, t1[..., -1], torch.amax(k_eff, dim=-1)


def temhd_step(p: TEMHDParams, state: TEMHDState, heat_flux_mw_m2, dt: float = 0.1):
    """One implicit step: TE-convection-enhanced conduction.

    Physics chain (reference ``step`` :86-131): grad T -> thermoelectric
    current J = -sigma S grad T -> Lorentz force |J x B| -> convection
    velocity (Stokes balance) -> Peclet number -> k_eff = k (1 + 0.2 Pe).
    """
    t = state.t_k
    (q,) = as_tensors(heat_flux_mw_m2, dtype=t.dtype, device=t.device)
    dz_t = torch.tensor(p.dz_m, dtype=t.dtype, device=t.device)
    t1, t_surf, k_max = _step(p, t, (q * 1e6)[..., None], dt, dz_t)
    return TEMHDState(t_k=t1), t_surf, k_max


def _run(p: TEMHDParams, q: torch.Tensor, dt: float, n_steps: int):
    """The transient of every flux of ``q`` (...,) from the wall
    temperature: (final profiles, surface temperatures and max k_eff, each
    (..., n_steps))."""
    t = torch.full((*q.shape, p.n_cells), p.t_wall_k, dtype=q.dtype, device=q.device)
    dz_t = torch.tensor(p.dz_m, dtype=q.dtype, device=q.device)
    q_in = (q * 1e6)[..., None]
    surf, k_max = [], []
    for _ in range(n_steps):
        t, t_surf, k = _step(p, t, q_in, dt, dz_t)
        surf.append(t_surf)
        k_max.append(k)
    return t, torch.stack(surf, dim=-1), torch.stack(k_max, dim=-1)


def run_temhd(p: TEMHDParams, heat_flux_mw_m2, *, dt: float = 0.1, n_steps: int = 300,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cuda") -> TEMHDTrace:
    """Whole thermal transient at constant incident flux (JAX's scan): one
    launch of row T a step on the card."""
    (q,) = as_tensors(heat_flux_mw_m2, dtype=dtype, device=device)
    t, surf, k_max = _run(p, q, dt, n_steps)
    return TEMHDTrace(surface_t_k=surf, k_eff_max=k_max, state=TEMHDState(t_k=t))


def temhd_flux_scan(p: TEMHDParams, fluxes_mw_m2, *, dt: float = 0.1, n_steps: int = 300,
                    dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"):
    """The experiment over incident heat fluxes (reference
    ``run_temhd_experiment``), the fluxes one batch (one launch of row T a
    step for all of them); returns final surface temperatures and the TE
    conductivity-enhancement factors."""
    (q,) = as_tensors(fluxes_mw_m2, dtype=dtype, device=device)
    _, surf, k_max = _run(p, torch.atleast_1d(q), dt, n_steps)
    return surf[..., -1], k_max[..., -1] / p.k_thermal_w_m_k
