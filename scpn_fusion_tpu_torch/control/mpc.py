"""Nonlinear model-predictive control with gradient-through-rollout planning
(port of ``scpn_fusion_tpu/control/mpc.py``).

The horizon rollout is a Python loop of Euler steps; the planner is Adam on
the *exact* gradient of the rollout cost (``torch.autograd.grad`` through
the rollout, where JAX takes ``jax.grad``), and control bounds are enforced
by projection each iteration.  Adam is optax's formula written out
(:func:`_adam_update`: the moments, their bias corrections and
``mu_hat / (sqrt(nu_hat) + eps)``, in optax's order of operations), not
``torch.optim.Adam``, whose order differs.  Works with any dynamics function
``f(x, u) -> dx/dt`` of tensors: an analytic plant or a learned surrogate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 10
    dt: float = 0.1
    iterations: int = 50
    learning_rate: float = 0.05
    l2_reg: float = 0.01
    u_min: float = -1.0
    u_max: float = 1.0


class MPCPlan(NamedTuple):
    u_traj: torch.Tensor     # (N, nu) planned inputs
    x_traj: torch.Tensor     # (N+1, nx) predicted states
    cost: torch.Tensor
    first_action: torch.Tensor


def _adam_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int,
                 learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of ``optax.adam(learning_rate)``: returns (update, mu, nu,
    count), the update to add to the parameters."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    count += 1
    mu_hat = mu / (1 - b1**count)
    nu_hat = nu / (1 - b2**count)
    return -learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps)), mu, nu, count


def rollout(dynamics: Callable, x0: torch.Tensor, u_traj: torch.Tensor,
            dt) -> torch.Tensor:
    """Euler rollout of dx/dt = f(x, u); returns (N+1, nx)."""
    xs = [x0]
    for u in u_traj:
        xs.append(xs[-1] + dt * dynamics(xs[-1], u))
    return torch.stack(xs)


def plan(
    dynamics: Callable,
    cfg: MPCConfig,
    x0: torch.Tensor,
    x_target: torch.Tensor,
    u_init: torch.Tensor | None = None,
    q_weights: torch.Tensor | None = None,
) -> MPCPlan:
    """Solve the finite-horizon tracking problem by Adam on the rollout cost.

    cost = sum_k ||Q (x_k - x*)||^2 + l2 ||u||^2, bounds via projection.
    The plan runs on ``x0``'s device and in its dtype.
    """
    nx = x0.shape[0]
    nu = u_init.shape[1] if u_init is not None else nx
    if u_init is None:
        u_init = torch.zeros((cfg.horizon, nu), dtype=x0.dtype, device=x0.device)
    q = torch.ones((nx,), dtype=x0.dtype, device=x0.device) if q_weights is None else q_weights

    def cost_fn(u_traj):
        xs = rollout(dynamics, x0, u_traj, cfg.dt)
        track = ((q[None, :] * (xs[1:] - x_target[None, :])) ** 2).sum()
        return track + cfg.l2_reg * (u_traj**2).sum()

    u = u_init.detach()
    mu, nu_m, count = torch.zeros_like(u), torch.zeros_like(u), 0
    for _ in range(cfg.iterations):
        u_req = u.requires_grad_(True)
        (grads,) = torch.autograd.grad(cost_fn(u_req), u_req)
        update, mu, nu_m, count = _adam_update(grads, mu, nu_m, count, cfg.learning_rate)
        u = torch.clamp(u.detach() + update, cfg.u_min, cfg.u_max)
    with torch.no_grad():
        xs = rollout(dynamics, x0, u, cfg.dt)
        cost = cost_fn(u)
    return MPCPlan(u_traj=u, x_traj=xs, cost=cost, first_action=u[0])


def mpc_closed_loop(
    dynamics: Callable,
    true_plant: Callable,
    cfg: MPCConfig,
    x0: torch.Tensor,
    x_target: torch.Tensor,
    n_steps: int,
    q_weights: torch.Tensor | None = None,
    nu: int | None = None,
):
    """Receding-horizon closed loop: plan, apply the first action, repeat;
    warm-starts each plan from the shifted previous one."""
    nu = nu if nu is not None else x0.shape[0]
    u_warm = torch.zeros((cfg.horizon, nu), dtype=x0.dtype, device=x0.device)
    x = x0
    xs, us = [x0], []
    for _ in range(n_steps):
        p = plan(dynamics, cfg, x, x_target, u_warm, q_weights)
        u = p.first_action
        x = x + cfg.dt * true_plant(x, u)
        xs.append(x)
        us.append(u)
        u_warm = torch.cat([p.u_traj[1:], p.u_traj[-1:]], dim=0)
    return torch.stack(xs), torch.stack(us)
