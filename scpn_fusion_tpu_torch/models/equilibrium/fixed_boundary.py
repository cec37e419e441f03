"""Fixed-boundary Grad-Shafranov equilibrium: the Picard solver (port of
``scpn_fusion_tpu/models/equilibrium/fixed_boundary.py``).

Same algorithm and semantics as the JAX solver: seed plasma (normalised
Gaussian J + 50 Jacobi sweeps, skipped on a warm start), zero-current
short-circuit, per iteration topology -> Ip-renormalised source -> elliptic
step (Jacobi / SOR / multigrid V-cycle) -> under-relaxation, Anderson mixing
every third step, the dual convergence criterion, and the divergence guard
returning the best state seen.

The JAX ``lax.while_loop`` is a Python loop here.  Reading the update norm
``diff`` to decide whether to stop costs one host synchronisation per
iteration; the Anderson ``lax.cond`` becomes a Python ``if`` on host
counters and needs none.  (CUDA graphs that remove the per-iteration sync
are later work.)  The JAX ``guarded_body`` only matters under ``vmap``; a
single solve does not need it.

The hand-written CUDA kernels run iff ``cfg.solver.use_pallas`` is set, the
solve is on a CUDA device and the dtype is float32 -- the JAX rule with
"tpu" replaced by "cuda".  f64 on CUDA runs the plain ops, as f64 does in
JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.profiles import (
    ProfileCoeffs,
    plasma_current_density,
    profile_coeffs_from_physics,
)
from scpn_fusion_tpu_torch.models.equilibrium.topology import analyze_topology, compute_b_field
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl, prolongate_bilinear
from scpn_fusion_tpu_torch.ops.stencil import (
    apply_dirichlet,
    gs_residual_rms,
    jacobi_step,
    jacobi_sweeps,
    sor_step,
)


class EquilibriumResult(NamedTuple):
    """Result of one solve (the JAX result's fields; ``converged`` and
    ``iterations`` are host values)."""

    psi: torch.Tensor
    j_phi: torch.Tensor
    b_r: torch.Tensor
    b_z: torch.Tensor
    converged: bool
    iterations: int
    residual: torch.Tensor           # best update-diff seen
    gs_residual: torch.Tensor        # final GS-residual RMS
    gs_residual_best: torch.Tensor
    residual_history: torch.Tensor   # (max_iter,), NaN-padded
    gs_residual_history: torch.Tensor


def _anderson_mix(psi_buf: torch.Tensor, f_buf: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Tikhonov-regularised, norm-clipped type-II Anderson mixing over the
    (m, NZ, NR) history buffers, newest last; ``n_valid`` newest rows are
    filled.  Same algebra as the JAX ``_anderson_mix``; the Gram matrix is a
    sum of elementwise products (no matmul, so no TF32 on the card)."""
    m = psi_buf.shape[0]
    dev, dt = f_buf.device, f_buf.dtype
    idx = torch.arange(m, device=dev)
    valid = idx >= (m - n_valid)
    f_masked = torch.where(valid[:, None, None], f_buf, torch.zeros_like(f_buf))

    d_f = f_masked[1:] - f_masked[:-1]
    pair_valid = idx[:-1] >= (m - n_valid)
    d_f = torch.where(pair_valid[:, None, None], d_f, torch.zeros_like(d_f))

    rhs = f_masked[-1]
    gram = (d_f[:, None] * d_f[None, :]).sum((-2, -1))
    scale = torch.trace(gram) / (m - 1)
    gram = gram + (1e-10 + 1e-8 * scale) * torch.eye(m - 1, dtype=dt, device=dev)
    gamma = torch.linalg.solve_ex(gram, (d_f * rhs).sum((-2, -1)))[0]
    g_norm = torch.linalg.vector_norm(gamma)
    gamma = gamma * torch.clamp(10.0 / torch.clamp(g_norm, min=1e-30), max=1.0)

    alpha = torch.zeros(m, dtype=dt, device=dev)
    alpha[:-1] += gamma
    alpha[1:] -= gamma
    alpha[-1] += 1.0
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    alpha_sum = alpha.sum()
    safe = alpha_sum.abs() >= 1e-12
    alpha = torch.where(safe, alpha / torch.where(safe, alpha_sum, torch.ones_like(alpha_sum)),
                        torch.zeros_like(alpha))
    mixed = (alpha[:, None, None] * psi_buf).sum(0)
    return torch.where(safe, mixed, psi_buf[-1])


def solve_fixed_boundary_impl(
    grid: Grid,
    psi0: torch.Tensor,
    psi_bc: torch.Tensor,
    i_target: torch.Tensor,
    p_coeffs: ProfileCoeffs,
    ff_coeffs: ProfileCoeffs,
    tol: float,
    gs_tol: float,
    alpha_relax: float,
    omega: float,
    *,
    solver_method: str,
    max_iter: int,
    h_mode: bool,
    inner_sweeps: int,
    anderson_m: int,
    mu0: float,
    use_gs_criterion: bool,
    use_pallas: bool = False,
    skip_seed: bool = False,
    mg_pre_smooth: int = 3,
    mg_post_smooth: int = 3,
    mg_min_grid: int = 5,
) -> EquilibriumResult:
    """The Picard loop on the grid's device and dtype.  ``tol``, ``gs_tol``,
    ``alpha_relax`` and ``omega`` are Python floats already rounded to the
    solve's dtype."""
    r_1d = grid.R
    rr = r_1d[None, :].expand(grid.NZ, grid.NR)
    zz = grid.Z[:, None].expand(grid.NZ, grid.NR)
    d_r, d_z = grid.dR, grid.dZ
    dtype, device = psi0.dtype, psi0.device

    use_anderson = solver_method in ("anderson", "anderson_mg")
    m_hist = anderson_m if use_anderson else 1

    if skip_seed:
        psi = psi0
    else:
        r_center = 0.5 * (grid.R_min + grid.R_max)
        j_seed = torch.exp(-((rr - r_center) ** 2 + zz**2) / 2.0)
        i_seed = j_seed.sum() * d_r * d_z
        j_seed = j_seed * (i_target / torch.clamp(i_seed, min=1e-30))
        psi = jacobi_sweeps(psi0, -mu0 * rr * j_seed, r_1d, d_r, d_z, 50)

    def elliptic_step(psi_in: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        if solver_method == "jacobi":
            out = psi_in
            for _ in range(inner_sweeps):
                out = jacobi_step(out, source, r_1d, d_r, d_z)
        elif solver_method in ("multigrid", "anderson_mg"):
            out = _vcycle_impl(psi_in, source, r_1d, d_r, d_z, 1.0, mg_pre_smooth,
                               mg_post_smooth, mg_min_grid, 50, use_pallas)
        elif use_pallas:  # "sor" | "anderson"
            from scpn_fusion_tpu_torch.ops.cuda_stencil import sor_sweeps
            out = sor_sweeps(psi_in, source, r_1d, d_r, d_z, omega, inner_sweeps)
        else:
            out = psi_in
            for _ in range(inner_sweeps):
                out = sor_step(out, source, r_1d, d_r, d_z, omega)
        return apply_dirichlet(out, psi_bc)

    divertor_mask = (zz < (grid.Z_min * 0.5)).to(dtype).contiguous()

    def picard_source(psi_k: torch.Tensor) -> torch.Tensor:
        if use_pallas:
            from scpn_fusion_tpu_torch.ops.cuda_source import fused_topology_source
            return fused_topology_source(psi_k, r_1d, divertor_mask, p_coeffs, ff_coeffs,
                                         i_target, d_r=d_r, d_z=d_z, mu0=mu0, h_mode=h_mode)
        topo = analyze_topology(psi_k, zz, d_r, d_z, grid.Z_min)
        j_phi = plasma_current_density(psi_k, topo.psi_axis, topo.psi_boundary, rr,
                                       h_mode=h_mode, p_coeffs=p_coeffs, ff_coeffs=ff_coeffs,
                                       mu0=mu0, i_target=i_target, d_r=d_r, d_z=d_z)
        return -mu0 * rr * j_phi

    psi_buf = torch.zeros((m_hist,) + tuple(psi.shape), dtype=dtype, device=device)
    f_buf = torch.zeros_like(psi_buf)
    n_valid = 0
    k = 0
    diff = 1e30
    converged = False
    best_diff = math.inf
    best_psi = psi
    gs_best = torch.full((), math.inf, dtype=dtype, device=device)
    res_hist: list[float] = []
    gs_hist: list[torch.Tensor] = []
    nan = torch.full((), math.nan, dtype=dtype, device=device)

    while k < max_iter and not converged and math.isfinite(diff):
        source = picard_source(psi)
        psi_new = elliptic_step(psi, source)
        diff_t = (psi_new - psi).abs().mean()
        psi_relaxed = (1.0 - alpha_relax) * psi + alpha_relax * psi_new

        if use_anderson:
            psi_buf = torch.cat([psi_buf[1:], psi_relaxed[None]])
            f_buf = torch.cat([f_buf[1:], (psi_new - psi)[None]])
            n_valid = min(n_valid + 1, m_hist)
            if n_valid >= 3 and k % 3 == 0:
                psi_next = apply_dirichlet(_anderson_mix(psi_buf, f_buf, n_valid), psi_bc)
            else:
                psi_next = psi_relaxed
        else:
            psi_next = psi_relaxed

        if use_gs_criterion:
            gs_res = gs_residual_rms(psi_next, source, r_1d, d_r, d_z)
            gs_best = torch.minimum(gs_res, gs_best)
        else:
            gs_res = nan

        # The one host synchronisation of the iteration.
        diff = diff_t.item()
        if diff < best_diff:
            best_diff, best_psi = diff, psi_next
        converged = diff < tol and (not use_gs_criterion or gs_res.item() < gs_tol)
        res_hist.append(diff)
        gs_hist.append(gs_res)
        psi = psi_next
        k += 1

    diverged = not math.isfinite(diff)
    psi_out = best_psi if diverged else psi

    topo = analyze_topology(psi_out, zz, d_r, d_z, grid.Z_min)
    j_phi = plasma_current_density(psi_out, topo.psi_axis, topo.psi_boundary, rr,
                                   h_mode=h_mode, p_coeffs=p_coeffs, ff_coeffs=ff_coeffs,
                                   mu0=mu0, i_target=i_target, d_r=d_r, d_z=d_z)
    source = -mu0 * rr * j_phi
    gs_final = gs_residual_rms(psi_out, source, r_1d, d_r, d_z)
    b_r, b_z = compute_b_field(psi_out, rr, d_r, d_z)

    res_history = torch.full((max_iter,), math.nan, dtype=dtype, device=device)
    gs_history = torch.full((max_iter,), math.nan, dtype=dtype, device=device)
    if k:
        res_history[:k] = torch.tensor(res_hist, dtype=dtype, device=device)
        gs_history[:k] = torch.stack(gs_hist)
    return EquilibriumResult(
        psi=psi_out, j_phi=j_phi, b_r=b_r, b_z=b_z,
        converged=bool(converged and not diverged), iterations=k,
        residual=torch.full((), best_diff, dtype=dtype, device=device),
        gs_residual=gs_final, gs_residual_best=torch.minimum(gs_best, gs_final),
        residual_history=res_history, gs_residual_history=gs_history,
    )


def _as_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a JAX scalar array of that dtype)."""
    return float(np.asarray(x, dtype=np.float32 if dtype == torch.float32 else np.float64))


def solve_equilibrium(
    cfg: ReactorConfig,
    grid: Grid | None = None,
    *,
    psi0: torch.Tensor | None = None,
    boundary_flux: torch.Tensor | None = None,
    preserve_initial_state: bool = False,
    i_target: float | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
    skip_seed: bool = False,
) -> EquilibriumResult:
    """Solve the fixed-boundary GS equilibrium for a reactor configuration
    on ``device`` in ``dtype`` (the JAX entry point's arguments plus
    ``device``)."""
    device = torch.device(device)
    if grid is None:
        grid = Grid.from_config(cfg, dtype=dtype, device=device)
    i_t = cfg.physics.plasma_current_target if i_target is None else i_target
    i_t = torch.full((), float(i_t), dtype=dtype, device=device)
    mu0 = float(cfg.physics.vacuum_permeability)

    if i_target is None and abs(cfg.physics.plasma_current_target) < 1e-12 \
            and not preserve_initial_state:
        psi_vac = vacuum_psi_from_config(grid, cfg).to(dtype)
        zeros = grid.zeros()
        b_r, b_z = compute_b_field(psi_vac, grid.RR, grid.dR, grid.dZ)
        n = cfg.solver.max_iterations
        zero = torch.zeros((), dtype=dtype, device=device)
        hist = torch.full((n,), math.nan, dtype=dtype, device=device)
        return EquilibriumResult(psi=psi_vac, j_phi=zeros, b_r=b_r, b_z=b_z, converged=True,
                                 iterations=0, residual=zero, gs_residual=zero,
                                 gs_residual_best=zero, residual_history=hist,
                                 gs_residual_history=hist.clone())

    if boundary_flux is not None:
        psi_bc = torch.as_tensor(boundary_flux).to(dtype=dtype, device=device)
        if tuple(psi_bc.shape) != grid.shape:
            raise ValueError(
                f"boundary_flux shape {tuple(psi_bc.shape)} must match grid {grid.shape}")
    elif preserve_initial_state and psi0 is not None:
        psi_bc = torch.as_tensor(psi0).to(dtype=dtype, device=device)
    else:
        psi_bc = vacuum_psi_from_config(grid, cfg).to(dtype)

    if preserve_initial_state and psi0 is not None:
        psi_init = apply_dirichlet(torch.as_tensor(psi0).to(dtype=dtype, device=device), psi_bc)
    else:
        psi_init = psi_bc

    p_coeffs, ff_coeffs = profile_coeffs_from_physics(cfg.physics, dtype, device)
    sol = cfg.solver
    gs_tol = sol.gs_residual_threshold if sol.gs_residual_threshold > 0 else math.inf
    return solve_fixed_boundary_impl(
        grid, psi_init, psi_bc, i_t, p_coeffs, ff_coeffs,
        _as_dtype(sol.convergence_threshold, dtype), _as_dtype(gs_tol, dtype),
        _as_dtype(sol.relaxation_factor, dtype), _as_dtype(sol.sor_omega, dtype),
        solver_method=sol.solver_method,
        max_iter=sol.max_iterations,
        h_mode=cfg.physics.profile_mode == "h-mode",
        inner_sweeps=sol.inner_sweeps,
        anderson_m=sol.anderson_depth,
        mu0=mu0,
        use_gs_criterion=sol.gs_residual_threshold > 0,
        use_pallas=(sol.use_pallas and device.type == "cuda" and dtype == torch.float32),
        skip_seed=skip_seed,
        mg_pre_smooth=sol.mg_pre_smooth,
        mg_post_smooth=sol.mg_post_smooth,
        mg_min_grid=sol.mg_min_grid,
    )


def solve_equilibrium_fmg(
    cfg: ReactorConfig,
    *,
    coarse_tol: float = 1e-3,
    min_coarse: int = 65,
    i_target: float | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> tuple[EquilibriumResult, list[dict]]:
    """Nested-iteration (FMG) Picard cascade to the configured resolution:
    solve coarse levels at ``coarse_tol``, prolong, warm-start the next level
    with the exact fine vacuum ring, finish at the configured tolerance.

    Returns ``(final_result, cascade_info)`` with per-level grid size,
    outer iterations and convergence."""
    nr, nz = cfg.grid_resolution
    if nr != nz:
        raise ValueError("solve_equilibrium_fmg expects a square grid")
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
        level_grid = Grid.from_config(level_cfg, dtype=dtype, device=device)
        bc = vacuum_psi_from_config(level_grid, level_cfg) if psi is not None else None
        res = solve_equilibrium(level_cfg, grid=level_grid, psi0=psi, boundary_flux=bc,
                                preserve_initial_state=psi is not None, i_target=i_target,
                                dtype=dtype, device=device, skip_seed=psi is not None)
        info.append({"n": n, "iterations": int(res.iterations),
                     "converged": bool(res.converged)})
        if n != nr:
            psi = prolongate_bilinear(res.psi, 2 * (n - 1) + 1, 2 * (n - 1) + 1)
    return res, info
