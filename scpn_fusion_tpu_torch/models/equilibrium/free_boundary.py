"""Free-boundary Grad-Shafranov solve with coil-driven boundary flux (port of
``scpn_fusion_tpu/models/equilibrium/free_boundary.py``).

The outer loop: the coils' flux (plus, with ``use_wall_response``, the
plasma's own flux on the wall) is the Dirichlet ring of an inner Picard solve
(``fixed_boundary.solve_fixed_boundary_impl``); with ``optimize_shape`` the
coil currents are re-fitted after each inner solve by the bounded Tikhonov
least squares of ``ops/lstsq``; the loop stops when the largest change of psi
between two inner solves falls below ``tol``.  The JAX ``lax.while_loop`` is
a Python loop here, with one host read of that change an outer iteration.

The inner solve is called as the JAX package calls it: no ``mg_pre_smooth``
/ ``mg_post_smooth`` (the V-cycle is the solver's default (3, 3), whatever
the configuration says), the 50 Jacobi seed sweeps on every outer iteration,
no GS-residual criterion, tolerances rounded to the solve's dtype.

The hand-written CUDA kernels (the fused source and the fused V-cycle up to
257^2) run iff ``cfg.solver.use_pallas`` is set, the grid is on a CUDA
device, and the dtype is float32 or ``mixed_n_refine > 0`` -- the JAX rule
with "tpu" read as "cuda".  In mixed mode only the injected float32 V-cycle
of ``mixed_precision.make_refinement_elliptic`` takes them; the float64
source stays on the plain ops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.core.special import green_coil_psi
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
    EquilibriumResult,
    _as_dtype,
    solve_fixed_boundary_impl,
)
from scpn_fusion_tpu_torch.models.equilibrium.mixed_precision import make_refinement_elliptic
from scpn_fusion_tpu_torch.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu_torch.ops.lstsq import tikhonov_coil_lstsq

MU0_SI = 4.0e-7 * math.pi


class CoilSet(NamedTuple):
    """Coil description as tensors (one device, one dtype)."""

    r: torch.Tensor          # (n_coils,)
    z: torch.Tensor          # (n_coils,)
    currents: torch.Tensor   # (n_coils,)
    turns: torch.Tensor      # (n_coils,)
    current_limits: torch.Tensor | None = None      # (n_coils,) or None
    target_flux_points: torch.Tensor | None = None  # (n_pts, 2) or None
    target_flux_values: torch.Tensor | None = None  # (n_pts,) or None


class FreeBoundaryResult(NamedTuple):
    """``outer_iterations`` and ``converged`` are host values."""

    psi: torch.Tensor
    coil_currents: torch.Tensor
    outer_iterations: int
    final_diff: torch.Tensor
    converged: bool
    equilibrium: EquilibriumResult


def coilset_from_config(cfg: ReactorConfig, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda") -> CoilSet:
    def t(vals):
        return torch.tensor(vals, dtype=dtype, device=device)
    return CoilSet(r=t([c.r for c in cfg.coils]), z=t([c.z for c in cfg.coils]),
                   currents=t([c.current for c in cfg.coils]),
                   turns=t([float(c.turns) for c in cfg.coils]))


def mutual_inductance_matrix(coil_r: torch.Tensor, coil_z: torch.Tensor, turns: torch.Tensor,
                             points: torch.Tensor, mu0: float = MU0_SI) -> torch.Tensor:
    """Coil-to-point flux response ``M[coil, point]`` per ampere, turns
    included."""
    return turns[:, None] * green_coil_psi(coil_r[:, None], coil_z[:, None],
                                           points[None, :, 0], points[None, :, 1], mu0)


def external_flux_table(grid: Grid, coils: CoilSet, mu0: float) -> torch.Tensor:
    """Per-coil unit-current flux on the grid: ``G[c, z, r]`` (turns included)."""
    return coils.turns[:, None, None] * green_coil_psi(
        coils.r[:, None, None], coils.z[:, None, None], grid.RR[None], grid.ZZ[None], mu0)


def interp_psi_at_points(psi: torch.Tensor, grid: Grid, points: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of a (NZ, NR) field at (R, Z) points.

    The clip bounds ``N - 1 - 1e-6`` are rounded to the field's dtype, as
    JAX's weakly typed constants are (``NR - 1`` for a float32 grid above
    ~17 points); the cast to an index truncates."""
    dt = psi.dtype
    fr = torch.clamp((points[:, 0] - grid.R_min) / grid.dR, 0.0,
                     _as_dtype(grid.NR - 1 - 1e-6, dt))
    fz = torch.clamp((points[:, 1] - grid.Z_min) / grid.dZ, 0.0,
                     _as_dtype(grid.NZ - 1 - 1e-6, dt))
    ir = torch.clamp(fr.to(torch.int64), 0, grid.NR - 2)
    iz = torch.clamp(fz.to(torch.int64), 0, grid.NZ - 2)
    tr = torch.clamp(fr - ir, 0.0, 1.0)
    tz = torch.clamp(fz - iz, 0.0, 1.0)
    p00 = psi[iz, ir]
    p01 = psi[iz, ir + 1]
    p10 = psi[iz + 1, ir]
    p11 = psi[iz + 1, ir + 1]
    return ((1 - tr) * (1 - tz) * p00 + tr * (1 - tz) * p01
            + (1 - tr) * tz * p10 + tr * tz * p11)


def _dummy_eq(grid: Grid, max_iter: int) -> EquilibriumResult:
    """The result before the first inner solve: zero fields (``j_phi`` zero
    is what the wall response sees in the first outer iteration)."""
    z = grid.zeros()
    s = torch.zeros((), dtype=grid.dtype, device=grid.device)
    hist = torch.full((max_iter,), math.nan, dtype=grid.dtype, device=grid.device)
    return EquilibriumResult(psi=z, j_phi=z, b_r=z, b_z=z, converged=False, iterations=0,
                             residual=s, gs_residual=s, gs_residual_best=s,
                             residual_history=hist, gs_residual_history=hist.clone())


def _run_free_boundary(
    coils: CoilSet,
    *,
    cfg: ReactorConfig,
    grid: Grid,
    max_outer_iter: int,
    tol: float,
    optimize_shape: bool,
    tikhonov_alpha: float,
    mu0_green: float,
    use_pallas: bool,
    anderson_gram_f32: bool = False,
    use_wall_response: bool = False,
    mixed_n_refine: int = 0,
    elliptic_fn=None,
) -> FreeBoundaryResult:
    """The outer loop on the grid's device and dtype.  ``elliptic_fn(psi,
    source) -> psi`` replaces the inner elliptic step (the mixed-precision
    defect correction when ``mixed_n_refine > 0``; a distributed V-cycle)."""
    dtype = coils.currents.dtype
    g_table = external_flux_table(grid, coils, mu0_green).reshape(len(coils.r), -1)

    def coil_flux(currents: torch.Tensor) -> torch.Tensor:
        return (currents @ g_table).reshape(grid.shape)

    elliptic_inj = elliptic_fn
    if mixed_n_refine > 0 and elliptic_inj is None:
        elliptic_inj = make_refinement_elliptic(grid, n_refine=mixed_n_refine,
                                                use_pallas=use_pallas)

    wall = None
    if use_wall_response:
        # the plasma's flux on the computational wall, one matmul an outer
        # iteration with the geometry-only M[wall, interior]
        from scpn_fusion_tpu_torch.models.equilibrium.shape_control import (
            plasma_wall_flux,
            wall_response_matrix,
        )
        m_wall, b_idx, s_idx = wall_response_matrix(grid, mu0_green)
        d_area = grid.dR * grid.dZ

        def wall(j_phi: torch.Tensor) -> torch.Tensor:
            return plasma_wall_flux(m_wall, b_idx, s_idx, j_phi, d_area, grid.shape)

    m_ctrl = None
    if coils.target_flux_points is not None:
        m_ctrl = mutual_inductance_matrix(coils.r, coils.z, coils.turns,
                                          coils.target_flux_points, mu0_green)

    if coils.current_limits is not None:
        lb, ub = -coils.current_limits.abs(), coils.current_limits.abs()
    else:
        ub = torch.full_like(coils.currents, 1e30)
        lb = -ub

    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype, grid.device)
    sol = cfg.solver
    i_target = torch.full((), float(cfg.physics.plasma_current_target), dtype=dtype,
                          device=grid.device)

    def inner_solve(psi0: torch.Tensor, psi_ext: torch.Tensor) -> EquilibriumResult:
        return solve_fixed_boundary_impl(
            grid, psi0, psi_ext, i_target, p_c, ff_c,
            _as_dtype(sol.convergence_threshold, dtype), math.inf,
            _as_dtype(sol.relaxation_factor, dtype), _as_dtype(sol.sor_omega, dtype),
            solver_method=sol.solver_method,
            max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps,
            anderson_m=sol.anderson_depth,
            mu0=float(cfg.physics.vacuum_permeability),
            use_gs_criterion=False,
            # in mixed mode the kernels belong to the injected float32
            # V-cycle only; the float64 topology and source stay plain
            use_pallas=use_pallas and elliptic_inj is None,
            elliptic_fn=elliptic_inj,
            anderson_gram_f32=anderson_gram_f32,
        )

    tol_d = _as_dtype(tol, dtype)
    k, diff = 0, 1e30
    psi, currents = coil_flux(coils.currents), coils.currents
    eq = _dummy_eq(grid, sol.max_iterations)
    diff_t = torch.full((), diff, dtype=dtype, device=grid.device)
    while k < max_outer_iter and diff >= tol_d and math.isfinite(diff):
        psi_ext = coil_flux(currents)
        if wall is not None:
            psi_ext = psi_ext + wall(eq.j_phi)
        # the first inner solve starts from the coils' flux, the later ones
        # from the previous interior under the updated ring
        eq = inner_solve(psi, psi_ext)
        if optimize_shape:
            if coils.target_flux_values is not None:
                target = coils.target_flux_values
            else:
                samples = interp_psi_at_points(eq.psi, grid, coils.target_flux_points)
                target = samples.mean().expand_as(samples)
            currents = tikhonov_coil_lstsq(m_ctrl.T, target, tikhonov_alpha, lb, ub)
        diff_t = (eq.psi - psi).abs().max()
        diff = diff_t.item()     # the one host read of the outer iteration
        psi = eq.psi
        k += 1
    return FreeBoundaryResult(psi=psi, coil_currents=currents, outer_iterations=k,
                              final_diff=diff_t, converged=diff < tol_d, equilibrium=eq)


def solve_free_boundary(
    cfg: ReactorConfig,
    coils: CoilSet | None = None,
    *,
    grid: Grid | None = None,
    max_outer_iter: int = 20,
    tol: float = 1e-4,
    optimize_shape: bool = False,
    tikhonov_alpha: float = 1e-4,
    mu0_green: float | None = None,
    use_wall_response: bool = False,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    anderson_gram_f32: bool = False,
    mixed_n_refine: int = 0,
) -> FreeBoundaryResult:
    """Free-boundary equilibrium: the coil-flux boundary <-> inner GS solve
    outer loop, on ``device`` (where the grid is built when ``grid`` is None;
    a given grid's device otherwise) in ``dtype``.

    ``mu0_green`` is the permeability of the coil Green's functions (SI by
    default, whatever the config's; 1.0 for normalised problems).
    ``mixed_n_refine > 0`` (float64 only) makes each inner elliptic step
    ``mixed_n_refine`` rounds of float64 defect -> float32 V-cycle."""
    if mixed_n_refine > 0 and dtype != torch.float64:
        raise ValueError("mixed_n_refine needs dtype=float64 (the float32 work lives inside "
                         "the injected V-cycle)")
    if grid is None:
        grid = Grid.from_config(cfg, dtype=dtype, device=device)
    if coils is None:
        coils = coilset_from_config(cfg, dtype, grid.device)
    if mu0_green is None:
        mu0_green = MU0_SI
    if optimize_shape and coils.target_flux_points is None:
        raise ValueError("optimize_shape requires CoilSet.target_flux_points")
    use_pallas = (cfg.solver.use_pallas and grid.device.type == "cuda"
                  and (dtype == torch.float32 or mixed_n_refine > 0))
    return _run_free_boundary(
        coils, cfg=cfg, grid=grid, max_outer_iter=int(max_outer_iter), tol=float(tol),
        optimize_shape=bool(optimize_shape), tikhonov_alpha=float(tikhonov_alpha),
        mu0_green=float(mu0_green), use_pallas=use_pallas,
        use_wall_response=bool(use_wall_response), anderson_gram_f32=bool(anderson_gram_f32),
        mixed_n_refine=int(mixed_n_refine))
