"""GS <-> transport self-consistent coupling (port of
``scpn_fusion_tpu/models/transport/coupling.py``).

The outer fixed-point loop: ``n_inner`` transport steps, the 1D -> 2D
profile projection, a full GS equilibrium solve, the psi residual.  JAX runs
it as one ``lax.while_loop``; here it is a Python loop with one host read of
the residual an outer iteration.

Projection semantics (``map_profiles_to_2d``): ``rho_2d = sqrt(clip(psi_norm,
0, 1))``; pressure ``ne (Ti + Te)`` and the Sauter bootstrap current
interpolated onto the 2D grid; ``J_phi = P * R + j_bs`` renormalised to the
target plasma current.  As in the JAX package, ``J_phi`` is returned but
does not enter the GS solve, which takes the configuration's profile
coefficients.

The GS solve runs the hand-written kernels (the fused source and the fused
V-cycle) iff ``cfg.solver.use_pallas`` is set, the solve is on a CUDA device
and the dtype is float32: the port's rule of ``fixed_boundary.py`` in place of
JAX's "on a TPU".  It takes JAX's arguments: no smoothing arguments, so its
V-cycles are (3, 3) whatever the configuration says, tolerances rounded to
the dtype.  Every Thomas solve of the transport steps is one kernel launch on
the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
    _as_dtype,
    solve_fixed_boundary_impl,
)
from scpn_fusion_tpu_torch.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu_torch.models.equilibrium.topology import analyze_topology
from scpn_fusion_tpu_torch.models.transport.closures import E_KEV_J, sauter_bootstrap_current
from scpn_fusion_tpu_torch.models.transport.solver import (
    TransportParams,
    TransportState,
    _scalar,
    _volume_element,
    evolve_profiles,
)


class CoupledResult(NamedTuple):
    psi: torch.Tensor
    transport: TransportState
    j_phi: torch.Tensor
    outer_iterations: int
    psi_residual: torch.Tensor
    converged: bool
    t_core: torch.Tensor
    tau_e: torch.Tensor


def interp_1d(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: linear interpolation on the increasing
    knots ``xp``, held at ``fp[0]`` / ``fp[-1]`` outside them."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32
                                        else np.float64).eps))
    dx0 = dx.abs() <= epsilon
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def interp_profile_to_2d(profile_1d: torch.Tensor, rho_1d: torch.Tensor,
                         rho_2d: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a 1D rho-profile onto a 2D rho map."""
    return interp_1d(rho_2d.reshape(-1), rho_1d, profile_1d).reshape(rho_2d.shape)


def map_profiles_to_2d(psi: torch.Tensor, ts: TransportState, tp: TransportParams,
                       grid: Grid, i_target: torch.Tensor, mu0: float) -> torch.Tensor:
    """Project transport profiles to a 2D J_phi source (Ip-renormalised)."""
    rho_1d = tp.rho(psi.dtype, psi.device)
    topo = analyze_topology(psi, grid.ZZ, grid.dR, grid.dZ, grid.Z_min)
    psi_axis = topo.psi_axis
    psi_edge = topo.psi_boundary
    # Degenerate-map guard: fall back to the global minimum.
    psi_edge = torch.where((psi_edge - psi_axis).abs() < 1.0, psi.min(), psi_edge)
    denom = psi_edge - psi_axis
    denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
    psi_norm = torch.clamp((psi - psi_axis) / denom, 0.0, 1.0)
    rho_2d = torch.sqrt(psi_norm)

    r0 = 0.5 * (grid.R_min + grid.R_max)
    j_bs_1d = sauter_bootstrap_current(rho_1d, ts.te, ts.ti, ts.ne, ts.q, r0, tp.a_minor, tp.b0,
                                       1.5)

    pressure_2d = interp_profile_to_2d(ts.ne * (ts.ti + ts.te), rho_1d, rho_2d)
    j_bs_2d = interp_profile_to_2d(j_bs_1d, rho_1d, rho_2d)

    j_phi = pressure_2d * grid.RR + j_bs_2d
    i_curr = torch.sum(j_phi) * grid.dR * grid.dZ
    scale = torch.where(i_curr.abs() > 1e-9, i_target / i_curr, 0.0)
    return j_phi * scale


def compute_confinement_time(ts: TransportState, tp: TransportParams, p_loss_mw) -> torch.Tensor:
    """tau_E = W_stored / P_loss."""
    rho = tp.rho(ts.ti.dtype, ts.ti.device)
    d_v = _volume_element(tp, rho)
    energy = 1.5 * (torch.clamp(ts.ne, 0.0, 1e3) * 1e19) \
        * (torch.clamp(ts.ti, 0.0, 1e3) + torch.clamp(ts.te, 0.0, 1e3)) * E_KEV_J
    w_mw = torch.sum(energy * d_v) / 1e6
    p_loss = _scalar(p_loss_mw, w_mw)
    return torch.where(p_loss > 0, w_mw / torch.clamp(p_loss, min=1e-30), math.inf)


def run_self_consistent(
    cfg: ReactorConfig,
    grid: Grid,
    tp: TransportParams,
    ts0: TransportState,
    psi0: torch.Tensor,
    psi_bc: torch.Tensor,
    *,
    p_aux_mw,
    dt,
    n_inner: int = 100,
    n_outer: int = 10,
    psi_tol: float = 1e-3,
) -> CoupledResult:
    """Self-consistent GS <-> transport fixed point on ``psi0``'s device and
    dtype (``grid``, ``ts0`` and ``psi_bc`` on the same)."""
    dtype, device = psi0.dtype, psi0.device
    i_target = torch.full((), float(cfg.physics.plasma_current_target), dtype=dtype,
                          device=device)
    mu0 = float(cfg.physics.vacuum_permeability)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype, device)
    sol = cfg.solver
    use_pallas = sol.use_pallas and device.type == "cuda" and dtype == torch.float32
    p_aux_mw, dt = _scalar(p_aux_mw, psi0), _scalar(dt, psi0)

    def gs_solve(psi_in: torch.Tensor):
        return solve_fixed_boundary_impl(
            grid, psi_in, psi_bc, i_target, p_c, ff_c,
            _as_dtype(sol.convergence_threshold, dtype), math.inf,
            _as_dtype(sol.relaxation_factor, dtype), _as_dtype(sol.sor_omega, dtype),
            solver_method=sol.solver_method,
            max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps,
            anderson_m=sol.anderson_depth,
            mu0=mu0,
            use_gs_criterion=False,
            use_pallas=use_pallas,
        )

    tol = _as_dtype(psi_tol, dtype)
    k, psi, ts = 0, psi0, ts0
    j_phi = torch.zeros_like(psi0)
    resid_t = torch.full((), 1e30, dtype=dtype, device=device)  # finite: the loop must start
    resid = float(resid_t)
    while k < n_outer and resid >= tol and math.isfinite(resid):
        for _ in range(n_inner):
            ts = evolve_profiles(ts, dt, p_aux_mw, tp)
        j_phi = map_profiles_to_2d(psi, ts, tp, grid, i_target, mu0)
        psi_new = gs_solve(psi).psi
        norm_old = torch.clamp(torch.linalg.vector_norm(psi), min=1e-30)
        resid_t = torch.linalg.vector_norm(psi_new - psi) / norm_old
        resid = float(resid_t)     # the one host read of the outer iteration
        psi = psi_new
        k += 1

    return CoupledResult(
        psi=psi, transport=ts, j_phi=j_phi, outer_iterations=k, psi_residual=resid_t,
        converged=resid < tol, t_core=ts.ti[1],
        tau_e=compute_confinement_time(ts, tp, p_aux_mw))
