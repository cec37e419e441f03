"""Newton-Krylov Grad-Shafranov solver, matrix-free with the exact JVP (port
of ``scpn_fusion_tpu/models/equilibrium/newton.py``).

A Picard warm-up, then Newton iterations solving ``J(psi) delta = -F(psi)``:

* ``F(psi) = Delta* psi - S(psi)`` on the interior (the Dirichlet ring
  pinned), S the Ip-renormalised profile source;
* ``J v`` exactly, by forward-mode autodiff of the residual
  (``torch.func.jvp``): the topology and renormalisation terms included;
* the Krylov solve is BiCGSTAB (:func:`_bicgstab`, step for step the
  ``jax.scipy.sparse.linalg.bicgstab`` of JAX 0.9.0) preconditioned by one
  multigrid V-cycle at (2, 2) smoothing;
* an Armijo line search over a fixed ladder of five step sizes.

The preconditioner's V-cycle runs with the kernels off, as in the JAX
package, so the whole solve runs plain PyTorch ops on every device; the
hand-written kernels have no forward-mode derivative either.  The JAX
``lax.while_loop`` loops are Python loops: one host read a BiCGSTAB step and
one a Newton step.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.func

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import _as_dtype
from scpn_fusion_tpu_torch.models.equilibrium.profiles import (
    ProfileCoeffs,
    plasma_current_density,
    profile_coeffs_from_physics,
)
from scpn_fusion_tpu_torch.models.equilibrium.topology import analyze_topology
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl
from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet, gs_operator, jacobi_sweeps, sor_step

ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)   # the line search's step sizes, largest first


class NewtonResult(NamedTuple):
    """``converged`` and ``iterations`` are host values."""

    psi: torch.Tensor
    j_phi: torch.Tensor
    converged: bool
    iterations: int
    residual_norm: torch.Tensor
    residual_history: torch.Tensor


def _zero_ring(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x[1:-1, 1:-1], (1, 1, 1, 1))


def _bicgstab(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
              precond: Callable[[torch.Tensor], torch.Tensor], *, maxiter: int,
              tol: float = 1e-5, atol: float = 0.0) -> torch.Tensor:
    """Preconditioned BiCGSTAB from ``x0 = 0``, following JAX 0.9.0's
    ``_bicgstab_solve`` step for step: it stops when ``|r|^2 <= atol2 =
    max(tol^2 |b|^2, atol^2)``, after ``maxiter`` steps, or on a breakdown
    (code -10: ``rho == 0``; -11: ``omega == 0`` or ``alpha == 0``), and a
    step whose intermediate residual ``s`` is already small enough takes
    only the half step (the ``exit_early`` selects)."""
    def vdot(u, v):
        return (u * v).sum()

    atol2 = torch.maximum(tol * tol * vdot(b, b),
                          torch.full((), atol * atol, dtype=b.dtype, device=b.device))
    x = torch.zeros_like(b)
    r = b - matvec(x)
    rhat = p = q = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    rs, lim = torch.stack([vdot(r, r), atol2]).tolist()
    while rs > lim and k < maxiter and k >= 0:
        rho_ = vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = precond(p)
        q = matvec(phat)
        alpha = rho_ / vdot(rhat, q)
        s = r - alpha * q
        exit_early = vdot(s, s) < atol2
        shat = precond(s)
        t = matvec(shat)
        omega = vdot(t, s) / vdot(t, t)
        x = torch.where(exit_early, x + alpha * phat, x + (alpha * phat + omega * shat))
        r = torch.where(exit_early, s, s - omega * t)
        rho = rho_
        # the one host read of the step
        rs, rho_zero, oa_zero = torch.stack([
            vdot(r, r), (rho_ == 0).to(b.dtype),
            ((omega == 0) | (alpha == 0)).to(b.dtype)]).tolist()
        k = -10 if rho_zero else -11 if oa_zero else k + 1
    return x


def _residual_fns(grid: Grid, i_target: torch.Tensor, p_coeffs: ProfileCoeffs,
                  ff_coeffs: ProfileCoeffs, *, h_mode: bool, mu0: float):
    """``(source_of, residual)`` on ``grid``: ``source_of(psi)`` is the
    Ip-renormalised source ``-mu0 R J_phi`` and ``J_phi``; ``residual(psi)``
    is ``Delta* psi - S(psi)`` on the interior, zero on the ring."""
    r_1d = grid.R
    rr = r_1d[None, :].expand(grid.NZ, grid.NR)
    zz = grid.Z[:, None].expand(grid.NZ, grid.NR)

    def source_of(psi: torch.Tensor):
        topo = analyze_topology(psi, zz, grid.dR, grid.dZ, grid.Z_min)
        j_phi = plasma_current_density(
            psi, topo.psi_axis, topo.psi_boundary, rr, h_mode=h_mode, p_coeffs=p_coeffs,
            ff_coeffs=ff_coeffs, mu0=mu0, i_target=i_target, d_r=grid.dR, d_z=grid.dZ)
        return -mu0 * rr * j_phi, j_phi

    def residual(psi: torch.Tensor) -> torch.Tensor:
        return _zero_ring(gs_operator(psi, r_1d, grid.dR, grid.dZ) - source_of(psi)[0])

    return source_of, residual


def _solve_newton_impl(
    grid: Grid,
    psi0: torch.Tensor,
    psi_bc: torch.Tensor,
    i_target: torch.Tensor,
    p_coeffs: ProfileCoeffs,
    ff_coeffs: ProfileCoeffs,
    tol: float,
    *,
    max_newton: int = 30,
    warmup_iters: int = 15,
    krylov_iters: int = 30,
    h_mode: bool = False,
    mu0: float = 1.0,
) -> NewtonResult:
    """The solve on ``psi0``'s device and dtype; ``tol`` (the RMS residual
    at which Newton stops) is a Python float already rounded to the dtype."""
    r_1d = grid.R
    rr = r_1d[None, :].expand(grid.NZ, grid.NR)
    zz = grid.Z[:, None].expand(grid.NZ, grid.NR)
    d_r, d_z = grid.dR, grid.dZ
    dtype, device = psi0.dtype, psi0.device
    source_of, residual = _residual_fns(grid, i_target, p_coeffs, ff_coeffs, h_mode=h_mode,
                                        mu0=mu0)

    def precond(v: torch.Tensor) -> torch.Tensor:
        # one V-cycle approximating (Delta*)^-1 v with a zero ring, kernels off
        return _vcycle_impl(torch.zeros_like(v), v, r_1d, d_r, d_z, 1.0, 2, 2, 5, 30, False)

    # Picard warm-up: the seed, then relaxed fixed-point steps of 10 SOR sweeps
    r_center = 0.5 * (grid.R_min + grid.R_max)
    j_seed = torch.exp(-(((rr - r_center) ** 2 + zz**2) / 2.0))
    j_seed = j_seed * (i_target / torch.clamp(j_seed.sum() * d_r * d_z, min=1e-30))
    psi = jacobi_sweeps(psi0, -mu0 * rr * j_seed, r_1d, d_r, d_z, 50)
    for _ in range(warmup_iters):
        src, _ = source_of(psi)
        p_new = psi
        for _ in range(10):
            p_new = sor_step(p_new, src, r_1d, d_r, d_z, 1.6)
        p_new = apply_dirichlet(p_new, psi_bc)
        psi = psi + 0.3 * (p_new - psi)
    psi = apply_dirichlet(psi, psi_bc)

    n_int = (grid.NZ - 2) * (grid.NR - 2)
    alphas = torch.tensor(ALPHAS, dtype=dtype, device=device)

    def rms(f: torch.Tensor) -> torch.Tensor:
        return torch.sqrt((f * f).sum() / n_int)

    f_norm_t = rms(residual(psi))
    f_norm = f_norm_t.item()
    k, converged = 0, False
    hist: list[torch.Tensor] = []
    while k < max_newton and not converged and math.isfinite(f_norm):
        f = residual(psi)
        f_norm_now = rms(f)

        def matvec(v: torch.Tensor, at=psi) -> torch.Tensor:
            # the exact Jacobian-vector product by forward-mode autodiff
            return torch.func.jvp(residual, (at,), (v,))[1]

        delta = _zero_ring(_bicgstab(matvec, -f, precond, maxiter=krylov_iters, tol=1e-3))
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))

        # Armijo backtracking: the first step size of the ladder that lowers
        # the residual enough
        merits = torch.stack([rms(residual(psi + a * delta)) for a in alphas])
        ok = merits < f_norm_now * (1.0 - 1e-4 * alphas)
        best = torch.argmax(ok.to(torch.int8))
        any_ok = ok.any()
        alpha = torch.where(any_ok, alphas[best], torch.zeros_like(f_norm_now))
        f_norm_t = torch.where(any_ok, merits[best], f_norm_now)
        psi = psi + alpha * delta
        hist.append(f_norm_t)
        f_norm = f_norm_t.item()    # the one host read of the Newton step
        converged = f_norm < tol
        k += 1

    history = torch.full((max_newton,), math.nan, dtype=dtype, device=device)
    if k:
        history[:k] = torch.stack(hist)
    return NewtonResult(psi=psi, j_phi=source_of(psi)[1], converged=converged, iterations=k,
                        residual_norm=f_norm_t, residual_history=history)


def solve_equilibrium_newton(
    cfg: ReactorConfig,
    grid: Grid | None = None,
    *,
    boundary_flux: torch.Tensor | None = None,
    max_newton: int = 30,
    warmup_iters: int = 15,
    krylov_iters: int = 30,
    tol: float | None = None,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
) -> NewtonResult:
    """Newton-Krylov equilibrium solve (the reference's ``method="newton"``
    lane) on ``device`` (where the grid is built when ``grid`` is None) in
    ``dtype``.  The JAX default dtype is the widest float there is, which is
    float64 for torch on every device.  ``tol`` (GS-residual RMS) defaults
    to ``1e-6 * (max |psi_bc| + 1)``.  Plain PyTorch ops throughout."""
    if grid is None:
        grid = Grid.from_config(cfg, dtype=dtype, device=device)
    if boundary_flux is not None:
        psi_bc = torch.as_tensor(boundary_flux).to(dtype=dtype, device=grid.device)
    else:
        psi_bc = vacuum_psi_from_config(grid, cfg).to(dtype)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype, grid.device)
    if tol is None:
        tol = 1e-6 * (float(psi_bc.abs().max()) + 1.0)
    return _solve_newton_impl(
        grid, psi_bc, psi_bc,
        torch.full((), float(cfg.physics.plasma_current_target), dtype=dtype, device=grid.device),
        p_c, ff_c, _as_dtype(tol, dtype),
        max_newton=max_newton, warmup_iters=warmup_iters, krylov_iters=krylov_iters,
        h_mode=cfg.physics.profile_mode == "h-mode",
        mu0=float(cfg.physics.vacuum_permeability))
