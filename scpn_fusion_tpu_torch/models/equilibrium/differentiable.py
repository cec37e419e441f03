"""Differentiable predictive forward: exact gradients via the IFT adjoint
(port of ``scpn_fusion_tpu/models/equilibrium/differentiable.py``).

:func:`fixed_point_ift` is a ``torch.autograd.Function``.  Its forward runs
``n_fwd`` steps of a contraction ``psi <- F(theta, psi)`` without a graph;
its backward solves the adjoint equation ``w = v + (dF/dpsi)^T w`` at the
fixed point psi* by ``n_bwd`` fixed-point iterations of one
``torch.func.vjp`` of ``F`` at (theta, psi*), then returns
``(dF/dtheta)^T w``.  Memory is O(1) in the iteration count, and the
gradient is that of the fixed point, not of the trajectory.

The predictive forward maps (coil currents, profile coefficients, Ip) to psi
through an under-relaxed Picard step with softmax axis/X-point fluxes and a
plain V-cycle (or plain SOR sweeps) as the inner solve.  Plain PyTorch ops
run on every device: the hand-written kernels have no backward, and the JAX
module keeps its Pallas kernels off here too.
"""

from __future__ import annotations

import functools
import math
from functools import partial
from typing import Callable, NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs, mtanh_profile
from scpn_fusion_tpu_torch.models.equilibrium.topology import soft_axis_flux, soft_x_point_flux
from scpn_fusion_tpu_torch.models.equilibrium.vacuum import (
    coil_response_table,
    vacuum_psi_from_table,
)
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl
from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet, sor_step

MU0 = 4.0e-7 * math.pi


# ---------------------------------------------------------------------------
# Generic IFT fixed point
# ---------------------------------------------------------------------------

def _flatten(theta):
    """(leaves, rebuild) for a tensor, a tuple or a NamedTuple of tensors."""
    if isinstance(theta, torch.Tensor):
        return [theta], lambda leaves: leaves[0]
    if hasattr(theta, "_fields"):
        return list(theta), lambda leaves: type(theta)(*leaves)
    return list(theta), tuple


class _FixedPointIFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, step_fn, rebuild, n_fwd, n_bwd, psi0, *leaves):
        theta = rebuild(list(leaves))
        psi = psi0
        for _ in range(n_fwd):
            psi = step_fn(theta, psi)
        ctx.step_fn, ctx.rebuild, ctx.n_bwd = step_fn, rebuild, n_bwd
        ctx.save_for_backward(psi, *leaves)
        return psi

    @staticmethod
    def backward(ctx, v):
        psi_star, *leaves = ctx.saved_tensors

        def step(psi, *lv):
            return ctx.step_fn(ctx.rebuild(list(lv)), psi)

        with torch.enable_grad():
            _, vjp_both = torch.func.vjp(step, psi_star, *leaves)
        w = v
        for _ in range(ctx.n_bwd):
            w = v + vjp_both(w)[0]          # w <- v + (dF/dpsi)^T w
        grad_theta = vjp_both(w)[1:]
        return (None, None, None, None, torch.zeros_like(psi_star), *grad_theta)


def fixed_point_ift(step_fn: Callable, theta, psi0: torch.Tensor, n_fwd: int,
                    n_bwd: int) -> torch.Tensor:
    """psi* = step_fn(theta, psi*) by ``n_fwd`` iterations; IFT gradients.

    ``theta`` is a tensor or a (named) tuple of tensors; ``step_fn`` must be
    a contraction near the fixed point.  Gradients with respect to theta are
    exact at the fixed point whatever ``n_fwd`` (the adjoint is evaluated at
    psi*, not along the trajectory); psi0 gets a zero gradient.
    """
    leaves, rebuild = _flatten(theta)
    return _FixedPointIFT.apply(step_fn, rebuild, n_fwd, n_bwd, psi0, *leaves)


# ---------------------------------------------------------------------------
# Concrete predictive forward
# ---------------------------------------------------------------------------

class PredictiveTheta(NamedTuple):
    """Differentiable inputs of the predictive forward."""

    coil_currents: torch.Tensor   # (n_coils,) effective amp-turns
    p_coeffs: torch.Tensor        # ProfileCoeffs as a flat (4,) vector
    ip_target: torch.Tensor       # 0-dim [A]


class PredictiveModel(NamedTuple):
    """Static per-geometry tables (on the grid's device)."""

    grid: Grid
    coil_table: torch.Tensor      # (n_coils, NZ, NR)
    relax: float
    sweeps_per_iter: int
    use_vcycle: bool = False


@functools.lru_cache(maxsize=16)
def _grid_arrays(grid: Grid):
    """(R, RR, ZZ) of a grid on its device, built once."""
    return grid.R, grid.RR, grid.ZZ


def build_predictive_model(grid: Grid, coil_r, coil_z, *, relax: float = 0.2,
                           sweeps_per_iter: int = 8,
                           use_vcycle: bool = False) -> PredictiveModel:
    """The coil response table on ``grid`` (its device and dtype).

    ``use_vcycle`` replaces the ``sweeps_per_iter`` SOR sweeps with one
    multigrid V-cycle per Picard step: the outer map then contracts by
    ~(1 - relax), so the fixed point and its adjoint converge in O(10^2)
    iterations instead of O(10^4)."""
    r = torch.as_tensor(coil_r, dtype=grid.dtype, device=grid.device)
    z = torch.as_tensor(coil_z, dtype=grid.dtype, device=grid.device)
    return PredictiveModel(grid=grid, coil_table=coil_response_table(grid, r, z, float(MU0)),
                           relax=relax, sweeps_per_iter=sweeps_per_iter,
                           use_vcycle=use_vcycle)


def _predictive_step(model: PredictiveModel, theta: PredictiveTheta,
                     psi: torch.Tensor) -> torch.Tensor:
    """One under-relaxed Picard step of the coil-driven GS problem, smooth in
    theta and psi (softmax axis/X-point fluxes; Ip renormalised to
    ``theta.ip_target``)."""
    grid = model.grid
    r_1d, rr, zz = _grid_arrays(grid)
    psi_vac = vacuum_psi_from_table(model.coil_table, theta.coil_currents)

    psi_ax = soft_axis_flux(psi)
    psi_bd = soft_x_point_flux(psi, zz, grid.dR, grid.dZ, grid.Z_min)
    span = psi_ax - psi_bd
    psi_n = torch.clamp((psi_ax - psi) / torch.where(span.abs() > 1e-12, span,
                                                     torch.ones_like(span)), 0.0, 1.0)

    coeffs = ProfileCoeffs(*[theta.p_coeffs[i] for i in range(4)])
    shape = mtanh_profile(psi_n, coeffs)
    inside = (psi_n < 1.0).to(psi.dtype)
    j_raw = rr / rr.mean() * shape * inside
    ip_raw = j_raw.sum() * (grid.dR * grid.dZ)
    j_phi = j_raw * theta.ip_target / torch.where(ip_raw.abs() > 1e-12, ip_raw,
                                                  torch.ones_like(ip_raw))
    source = -MU0 * rr * j_phi

    # Dirichlet boundary from the coil field; elliptic inner solve.
    psi_new = apply_dirichlet(psi, psi_vac)
    if model.use_vcycle:
        psi_new = _vcycle_impl(psi_new, source, r_1d, grid.dR, grid.dZ, 1.0, 3, 3, 5, 50)
    else:
        for _ in range(model.sweeps_per_iter):
            psi_new = sor_step(psi_new, source, r_1d, grid.dR, grid.dZ, omega=1.5)
    return (1.0 - model.relax) * psi + model.relax * psi_new


def solve_predictive_diff(model: PredictiveModel, theta: PredictiveTheta, *,
                          n_fwd: int = 300, n_bwd: int = 200) -> torch.Tensor:
    """Differentiable psi(theta) on the model's device."""
    psi0 = vacuum_psi_from_table(model.coil_table, theta.coil_currents).detach()
    return fixed_point_ift(partial(_predictive_step, model), theta, psi0, n_fwd, n_bwd)


def axis_sensitivity(model: PredictiveModel, theta: PredictiveTheta,
                     **kw) -> PredictiveTheta:
    """d(axis flux)/d(theta) through the converged equilibrium."""
    leaves = [t.detach().requires_grad_(True) for t in theta]
    psi = solve_predictive_diff(model, PredictiveTheta(*leaves), **kw)
    return PredictiveTheta(*torch.autograd.grad(soft_axis_flux(psi), leaves))


def optimize_coil_currents_diff(model: PredictiveModel, theta0: PredictiveTheta,
                                target_axis_flux: torch.Tensor, *, lr: float = 0.05,
                                n_steps: int = 50, **kw) -> PredictiveTheta:
    """Gradient-descent coil-current trim toward a target axis flux: ``n_steps``
    steps of length ``lr`` along the normalised IFT gradient."""
    currents = theta0.coil_currents.detach()
    for _ in range(n_steps):
        c = currents.requires_grad_(True)
        psi = solve_predictive_diff(model, theta0._replace(coil_currents=c), **kw)
        (g,) = torch.autograd.grad((soft_axis_flux(psi) - target_axis_flux) ** 2, c)
        currents = (c - lr * g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)).detach()
    return theta0._replace(coil_currents=currents)
