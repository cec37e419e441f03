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
JAX.  The JAX solver also stops its ``sor`` / ``anderson`` kernel and its
fused source at 12 MB of fields (VMEM); the port has no such gate: the
``sor_sweeps`` routes (``ops/cuda_stencil.sor_sweeps``) and the source
kernel (``ops/cuda_source.fused_topology_source``) take every f32 size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

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


def _anderson_mix(psi_buf: torch.Tensor, f_buf: torch.Tensor, n_valid: int,
                  gram_in_f32: bool = False) -> torch.Tensor:
    """Tikhonov-regularised, norm-clipped type-II Anderson mixing over the
    (m, NZ, NR) history buffers, newest last, or over (B, m, NZ, NR) buffers
    of a batch with one shared ``n_valid`` (the ensemble's batched solve);
    the ``n_valid`` newest rows are filled.  Same algebra as the JAX
    ``_anderson_mix``.  The Gram matrix is built row by row from elementwise
    products (no matmul, so no TF32 on the card, and no (m-1) x (m-1) x NZ x
    NR product: ~300 MB at 2049^2 in f64), the solves batched.
    ``gram_in_f32`` (the mixed-precision path): the Gram build and the solve
    run in float32, the mix itself in the buffers' dtype."""
    if psi_buf.dim() == 3:
        return _anderson_mix(psi_buf[None], f_buf[None], n_valid, gram_in_f32)[0]
    b, m = psi_buf.shape[:2]
    dev, dt = f_buf.device, f_buf.dtype
    idx = torch.arange(m, device=dev)
    valid = idx >= (m - n_valid)
    f_masked = torch.where(valid[None, :, None, None], f_buf, torch.zeros_like(f_buf))

    d_f = f_masked[:, 1:] - f_masked[:, :-1]
    pair_valid = idx[:-1] >= (m - n_valid)
    d_f = torch.where(pair_valid[None, :, None, None], d_f, torch.zeros_like(d_f))

    cdt = torch.float32 if gram_in_f32 else dt
    d_f_c = d_f.to(cdt)
    rhs = f_masked[:, -1].to(cdt)
    k = m - 1
    gram = torch.stack([(d_f_c * d_f_c[:, a:a + 1]).sum((-2, -1)) for a in range(k)], 1)
    scale = gram.diagonal(dim1=-2, dim2=-1).sum(-1) / k
    gram = gram + (1e-10 + 1e-8 * scale)[:, None, None] * torch.eye(k, dtype=cdt, device=dev)
    proj = (d_f_c * rhs[:, None]).sum((-2, -1))
    gamma = torch.linalg.solve_ex(gram, proj)[0].to(dt)
    g_norm = torch.linalg.vector_norm(gamma, dim=-1, keepdim=True)
    gamma = gamma * torch.clamp(10.0 / torch.clamp(g_norm, min=1e-30), max=1.0)

    alpha = torch.zeros((b, m), dtype=dt, device=dev)
    alpha[:, :-1] += gamma
    alpha[:, 1:] -= gamma
    alpha[:, -1] += 1.0
    alpha = torch.where(valid[None], alpha, torch.zeros_like(alpha))
    alpha_sum = alpha.sum(-1, keepdim=True)
    safe = alpha_sum.abs() >= 1e-12
    alpha = torch.where(safe, alpha / torch.where(safe, alpha_sum, torch.ones_like(alpha_sum)),
                        torch.zeros_like(alpha))
    mixed = (alpha[:, :, None, None] * psi_buf).sum(1)
    return torch.where(safe[:, :, None], mixed, psi_buf[:, -1])


def _seed_psi(grid: Grid, psi_bc: torch.Tensor, i_target: torch.Tensor,
              mu0: float) -> torch.Tensor:
    """The seed plasma of one solve: the normalised Gaussian J at the target
    current, then 50 Jacobi sweeps from ``psi_bc``."""
    rr, zz = grid.RR, grid.ZZ
    r_center = 0.5 * (grid.R_min + grid.R_max)
    j_seed = torch.exp(-((rr - r_center) ** 2 + zz**2) / 2.0)
    i_seed = j_seed.sum() * grid.dR * grid.dZ
    j_seed = j_seed * (i_target / torch.clamp(i_seed, min=1e-30))
    return jacobi_sweeps(psi_bc, -mu0 * rr * j_seed, grid.R, grid.dR, grid.dZ, 50)


def _plain_source(psi: torch.Tensor, i_target: torch.Tensor, grid: Grid, p_coeffs: ProfileCoeffs,
                  ff_coeffs: ProfileCoeffs, mu0: float, h_mode: bool) -> torch.Tensor:
    """The Picard source ``-mu0 R J_phi`` of one psi in plain ops."""
    rr = grid.RR
    topo = analyze_topology(psi, grid.ZZ, grid.dR, grid.dZ, grid.Z_min)
    j_phi = plasma_current_density(psi, topo.psi_axis, topo.psi_boundary, rr, h_mode=h_mode,
                                   p_coeffs=p_coeffs, ff_coeffs=ff_coeffs, mu0=mu0,
                                   i_target=i_target, d_r=grid.dR, d_z=grid.dZ)
    return -mu0 * rr * j_phi


def _elliptic(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, d_r: float,
              d_z: float, *, solver_method: str, inner_sweeps: int, omega: float,
              use_pallas: bool, mg_pre_smooth: int = 3, mg_post_smooth: int = 3,
              mg_min_grid: int = 5) -> torch.Tensor:
    """The Picard elliptic step of one psi, before its Dirichlet ring:
    ``inner_sweeps`` Jacobi or SOR sweeps, or one V-cycle."""
    if solver_method == "jacobi":
        for _ in range(inner_sweeps):
            psi = jacobi_step(psi, source, r_1d, d_r, d_z)
        return psi
    if solver_method in ("multigrid", "anderson_mg"):
        return _vcycle_impl(psi, source, r_1d, d_r, d_z, 1.0, mg_pre_smooth, mg_post_smooth,
                            mg_min_grid, 50, use_pallas)
    if use_pallas:  # "sor" | "anderson": one launch for up to 4 sweeps at any size
        # and for more up to ~129^2; 2 n staged launches beyond (cuda_stencil.sor_sweeps)
        from scpn_fusion_tpu_torch.ops.cuda_stencil import sor_sweeps
        return sor_sweeps(psi, source, r_1d, d_r, d_z, omega, inner_sweeps)
    for _ in range(inner_sweeps):
        psi = sor_step(psi, source, r_1d, d_r, d_z, omega)
    return psi


class _Picard(NamedTuple):
    """One Picard iteration, for one psi (NZ, NR) or for a batch (B, NZ, NR)
    with (B, m, NZ, NR) history buffers: the loop of a single solve and the
    ensemble's batched loop (``parallel/ensemble.py``) both step with it and
    differ only in how they keep their carry."""

    source: Callable        # psi -> the Picard source
    elliptic: Callable      # (psi, source) -> psi, before the Dirichlet ring
    gs_rms: Callable        # (psi, source) -> the GS-residual RMS
    psi_bc: torch.Tensor
    alpha_relax: float
    use_anderson: bool
    anderson_gram_f32: bool
    use_gs_criterion: bool

    def step(self, psi: torch.Tensor, psi_buf: torch.Tensor, f_buf: torch.Tensor,
             n_valid: int, k: int):
        """Iteration ``k`` from ``psi``: source -> elliptic step -> update
        norm -> under-relaxation, the Anderson history and its every-third-step
        mix.  Returns ``(psi_next, diff, gs_res or None, psi_buf, f_buf,
        n_valid)``; ``diff`` and ``gs_res`` have psi's leading shape."""
        source = self.source(psi)
        psi_new = apply_dirichlet(self.elliptic(psi, source), self.psi_bc)
        diff = (psi_new - psi).abs().mean((-2, -1))
        psi_next = (1.0 - self.alpha_relax) * psi + self.alpha_relax * psi_new
        if self.use_anderson:
            psi_buf = torch.cat([psi_buf[..., 1:, :, :], psi_next.unsqueeze(-3)], -3)
            f_buf = torch.cat([f_buf[..., 1:, :, :], (psi_new - psi).unsqueeze(-3)], -3)
            n_valid = min(n_valid + 1, psi_buf.shape[-3])
            if n_valid >= 3 and k % 3 == 0:
                psi_next = apply_dirichlet(
                    _anderson_mix(psi_buf, f_buf, n_valid, self.anderson_gram_f32), self.psi_bc)
        gs_res = self.gs_rms(psi_next, source) if self.use_gs_criterion else None
        return psi_next, diff, gs_res, psi_buf, f_buf, n_valid


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
    elliptic_fn=None,
    skip_seed: bool = False,
    anderson_gram_f32: bool = False,
    mg_pre_smooth: int = 3,
    mg_post_smooth: int = 3,
    mg_min_grid: int = 5,
) -> EquilibriumResult:
    """The Picard loop on the grid's device and dtype.  ``tol``, ``gs_tol``,
    ``alpha_relax`` and ``omega`` are Python floats already rounded to the
    solve's dtype.  ``elliptic_fn(psi, source) -> psi`` replaces the elliptic
    step (the mixed-precision defect correction); ``anderson_gram_f32``
    builds the Anderson Gram matrix in float32."""
    r_1d = grid.R
    rr, zz = grid.RR, grid.ZZ
    d_r, d_z = grid.dR, grid.dZ
    dtype, device = psi0.dtype, psi0.device

    use_anderson = solver_method in ("anderson", "anderson_mg")
    m_hist = anderson_m if use_anderson else 1

    psi = psi0 if skip_seed else _seed_psi(grid, psi0, i_target, mu0)

    if elliptic_fn is None:
        def elliptic_fn(psi_in: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
            return _elliptic(psi_in, source, r_1d, d_r, d_z, solver_method=solver_method,
                             inner_sweeps=inner_sweeps, omega=omega, use_pallas=use_pallas,
                             mg_pre_smooth=mg_pre_smooth, mg_post_smooth=mg_post_smooth,
                             mg_min_grid=mg_min_grid)

    if use_pallas:
        # what the source kernel needs of the solve's constants, packed once
        from scpn_fusion_tpu_torch.ops import cuda_source
        divertor_mask = (zz < (grid.Z_min * 0.5)).to(dtype).contiguous()
        source_params = cuda_source.pack_source_params(p_coeffs, ff_coeffs, i_target, like=psi0)

        def picard_source(psi_k: torch.Tensor) -> torch.Tensor:
            return cuda_source.fused_topology_source(psi_k, r_1d, divertor_mask, source_params,
                                                     d_r=d_r, d_z=d_z, mu0=mu0, h_mode=h_mode)
    else:
        def picard_source(psi_k: torch.Tensor) -> torch.Tensor:
            return _plain_source(psi_k, i_target, grid, p_coeffs, ff_coeffs, mu0, h_mode)

    picard = _Picard(picard_source, elliptic_fn,
                     lambda p, s: gs_residual_rms(p, s, r_1d, d_r, d_z), psi_bc, alpha_relax,
                     use_anderson, anderson_gram_f32, use_gs_criterion)
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
        psi_next, diff_t, gs_res, psi_buf, f_buf, n_valid = picard.step(psi, psi_buf, f_buf,
                                                                         n_valid, k)
        # The one host synchronisation of the iteration.
        if use_gs_criterion:
            gs_best = torch.minimum(gs_res, gs_best)
            diff, gs_val = torch.stack([diff_t, gs_res]).tolist()
        else:
            gs_res = nan
            diff, gs_val = diff_t.item(), math.nan
        if diff < best_diff:
            best_diff, best_psi = diff, psi_next
        converged = diff < tol and (not use_gs_criterion or gs_val < gs_tol)
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
    device: torch.device | str = "cuda",
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
    device: torch.device | str = "cuda",
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
