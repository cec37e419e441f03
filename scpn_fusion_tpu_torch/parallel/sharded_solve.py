"""Distributed equilibrium solve: the Anderson-MG-Picard loop with a sharded
elliptic step (port of ``scpn_fusion_tpu/parallel/sharded_solve.py``).

The port's single-device Picard loop
(``models/equilibrium/fixed_boundary.solve_fixed_boundary_impl``: topology,
profiles, Anderson mixing, the dual criterion, the divergence guard) runs on
the mesh's first device with its elliptic step replaced by the Z-slab
``parallel/sharded_mg.sharded_vcycle``.  Everything outside the elliptic
step runs the plain ops on that device, where JAX partitions it by GSPMD;
the source is the plain chain, as in JAX (``use_pallas`` stays off).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import (
    EquilibriumResult,
    _as_dtype,
    solve_fixed_boundary_impl,
)
from scpn_fusion_tpu_torch.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu_torch.ops.multigrid import prolongate_bilinear
from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet
from scpn_fusion_tpu_torch.parallel.halo import make_z_mesh
from scpn_fusion_tpu_torch.parallel.mesh import Mesh
from scpn_fusion_tpu_torch.parallel.sharded_mg import sharded_vcycle


@functools.lru_cache(maxsize=16)
def _make_elliptic_fn(mesh: Mesh, axis: str, grid: Grid):
    """One elliptic step ``(psi, source) -> psi`` per (mesh, grid), as JAX
    caches one per geometry."""
    d_r, d_z = float(grid.dR), float(grid.dZ)
    r_1d = grid.R

    def elliptic(psi, source):
        return sharded_vcycle(psi, source, r_1d.to(psi.dtype), 1.0, mesh=mesh, axis=axis,
                              d_r=d_r, d_z=d_z)

    return elliptic


def _solve_with_elliptic(cfg: ReactorConfig, grid: Grid, elliptic, psi0, skip_seed: bool):
    """The fixed-boundary Picard solve of ``cfg`` on ``grid`` with the
    elliptic step ``elliptic``; a warm start ``psi0`` keeps its interior
    under the exact vacuum ring of the grid."""
    dtype = grid.dtype
    psi_bc = vacuum_psi_from_config(grid, cfg).to(dtype)
    psi_init = psi_bc if psi0 is None else apply_dirichlet(psi0.to(dtype=dtype,
                                                                   device=grid.device), psi_bc)
    p_coeffs, ff_coeffs = profile_coeffs_from_physics(cfg.physics, dtype, grid.device)
    sol = cfg.solver
    gs_tol = sol.gs_residual_threshold if sol.gs_residual_threshold > 0 else math.inf
    return solve_fixed_boundary_impl(
        grid, psi_init, psi_bc,
        torch.full((), float(cfg.physics.plasma_current_target), dtype=dtype,
                   device=grid.device),
        p_coeffs, ff_coeffs,
        _as_dtype(sol.convergence_threshold, dtype), _as_dtype(gs_tol, dtype),
        _as_dtype(sol.relaxation_factor, dtype), _as_dtype(sol.sor_omega, dtype),
        solver_method=sol.solver_method,
        max_iter=sol.max_iterations,
        h_mode=cfg.physics.profile_mode == "h-mode",
        inner_sweeps=sol.inner_sweeps,
        anderson_m=sol.anderson_depth,
        mu0=float(cfg.physics.vacuum_permeability),
        use_gs_criterion=sol.gs_residual_threshold > 0,
        elliptic_fn=elliptic,
        skip_seed=skip_seed,
    )


def solve_equilibrium_sharded(cfg: ReactorConfig, mesh: Mesh | None = None, *,
                              n_devices: int | None = None, axis: str = "z",
                              dtype: torch.dtype = torch.float32,
                              psi0: torch.Tensor | None = None,
                              skip_seed: bool = False) -> EquilibriumResult:
    """The fixed-boundary GS equilibrium with the inner elliptic solve
    distributed over a Z-slab mesh: the contract of
    ``models.equilibrium.solve_equilibrium`` (thresholds, Anderson depth,
    relaxation from ``cfg.solver``).  Pass a ``mesh`` or ``n_devices`` (CUDA
    devices); the outer loop and the result live on the mesh's first
    device."""
    if mesh is None:
        mesh = make_z_mesh(n_devices, axis=axis)
    grid = Grid.from_config(cfg, dtype=dtype, device=mesh.first)
    return _solve_with_elliptic(cfg, grid, _make_elliptic_fn(mesh, axis, grid), psi0, skip_seed)


def solve_equilibrium_sharded_fmg(cfg: ReactorConfig, mesh: Mesh | None = None, *,
                                  n_devices: int | None = None, axis: str = "z",
                                  coarse_tol: float = 1e-3, min_coarse: int = 65,
                                  dtype: torch.dtype = torch.float32
                                  ) -> tuple[EquilibriumResult, list[dict]]:
    """Distributed FMG cascade: the warm-start ladder of
    ``solve_equilibrium_fmg`` with every level's elliptic step Z-slab
    sharded.  Coarse levels converge at ``coarse_tol`` and seed the next
    through a bilinear prolongation; the finest runs at the configured
    tolerance.  Returns ``(result, cascade_info)``."""
    if mesh is None:
        mesh = make_z_mesh(n_devices, axis=axis)
    nr, nz = cfg.grid_resolution
    if nr != nz:
        raise ValueError("solve_equilibrium_sharded_fmg expects a square grid")
    sizes = [nr]
    while (sizes[-1] - 1) % 2 == 0 and (sizes[-1] - 1) // 2 + 1 >= min_coarse:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    sizes = sizes[::-1]

    psi = None
    info: list[dict] = []
    res = None
    for n in sizes:
        level_cfg = dataclasses.replace(
            cfg, grid_resolution=(n, n),
            solver=dataclasses.replace(
                cfg.solver,
                convergence_threshold=(cfg.solver.convergence_threshold
                                       if n == nr else coarse_tol)))
        res = solve_equilibrium_sharded(level_cfg, mesh, axis=axis, dtype=dtype, psi0=psi,
                                        skip_seed=psi is not None)
        info.append({"n": n, "iterations": int(res.iterations),
                     "converged": bool(res.converged)})
        if n != nr:
            psi = prolongate_bilinear(res.psi, 2 * (n - 1) + 1, 2 * (n - 1) + 1)
    return res, info
