"""Learned-dynamics (neural-surrogate) model-predictive control (port of
``scpn_fusion_tpu/control/surrogate_mpc.py``).

The dynamics surrogate is an MLP residual model ``x_{k+1} = x_k +
f_theta(x_k, u_k)`` trained with ``models/surrogates/mlp``; the planner is
the generic gradient MPC of ``control/mpc.py``.  The model takes leading
batch dimensions, where JAX ``vmap``s it.

The draws rule: :func:`learn_dynamics` draws the initial weights and the
minibatches from a ``torch.Generator``; :func:`_learn_dynamics` takes the
initial parameters and the minibatch indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.mpc import MPCConfig, mpc_closed_loop, plan
from scpn_fusion_tpu_torch.models.surrogates.mlp import (
    MLPParams,
    _train_mlp,
    batch_indices,
    init_mlp,
    mlp_apply,
)


class DynamicsSurrogate(NamedTuple):
    mlp: MLPParams
    x_mean: torch.Tensor
    x_std: torch.Tensor
    d_mean: torch.Tensor     # residual (delta-x) normalisation
    d_std: torch.Tensor
    n_state: int
    n_control: int

    def __call__(self, x, u):
        """Discrete map: x_{k+1} = x_k + f_theta(x_k, u_k), over leading
        batch dimensions of ``x`` (..., n_state) and ``u`` (..., n_control)."""
        x = torch.atleast_1d(x)
        xu = torch.cat([x, torch.atleast_1d(u)], dim=-1)
        xn = (xu - self.x_mean) / self.x_std
        lead = xn.shape[:-1]
        d = mlp_apply(self.mlp, xn.reshape(-1, xn.shape[-1])).reshape(*lead, -1)
        return x + (d * self.d_std + self.d_mean)

    def derivative(self, dt: float):
        """Continuous-form wrapper for the generic MPC rollout
        (``mpc.rollout`` integrates x + dt * f(x, u))."""
        def f(x, u):
            return (self(x, u) - torch.atleast_1d(x)) / dt
        return f


def dynamics_dataset(x_traj: torch.Tensor, u_traj: torch.Tensor, dtype=torch.float32):
    """(normalised inputs, normalised residuals, x_mean, x_std, d_mean,
    d_std) of :func:`learn_dynamics`; the first two in ``dtype`` (float32,
    as JAX, by default)."""
    n_state, n_control = x_traj.shape[-1], u_traj.shape[-1]
    x_in = torch.cat([x_traj[:, :-1].reshape(-1, n_state), u_traj.reshape(-1, n_control)], dim=1)
    d_out = (x_traj[:, 1:] - x_traj[:, :-1]).reshape(-1, n_state)
    x_mean = x_in.mean(0)
    x_std = torch.clamp(x_in.std(0, unbiased=False), min=1e-9)
    d_mean = d_out.mean(0)
    d_std = torch.clamp(d_out.std(0, unbiased=False), min=1e-9)
    xn = ((x_in - x_mean) / x_std).to(dtype)
    dn = ((d_out - d_mean) / d_std).to(dtype)
    return xn, dn, x_mean, x_std, d_mean, d_std


def learn_dynamics(x_traj: torch.Tensor, u_traj: torch.Tensor, generator: torch.Generator, *,
                   hidden=(64, 64), n_steps: int = 3000, lr: float = 1e-3,
                   dtype=torch.float32) -> DynamicsSurrogate:
    """Fit the residual dynamics model from logged rollouts, in ``dtype``
    (float32, which JAX fixes, by default).

    x_traj: (N, T+1, n_state) states; u_traj: (N, T, n_control) controls.
    """
    n_state, n_control = x_traj.shape[-1], u_traj.shape[-1]
    params0 = init_mlp(generator, (n_state + n_control, *hidden, n_state), dtype=dtype,
                       device=x_traj.device)
    n_rows = x_traj.shape[0] * u_traj.shape[1]
    idx = batch_indices(generator, n_steps, min(512, n_rows), n_rows, x_traj.device)
    return _learn_dynamics(x_traj, u_traj, params0, idx, lr=lr)


def _learn_dynamics(x_traj: torch.Tensor, u_traj: torch.Tensor, params0: MLPParams,
                    batch_idx: torch.Tensor, *, lr: float = 1e-3) -> DynamicsSurrogate:
    """:func:`learn_dynamics` from ``params0`` (whose dtype the training
    takes) with the (n_steps, batch) indices given."""
    dtype = params0.weights[0].dtype
    xn, dn, x_mean, x_std, d_mean, d_std = dynamics_dataset(x_traj, u_traj, dtype)
    res = _train_mlp(params0, xn, dn, batch_idx, lr=lr)
    return DynamicsSurrogate(mlp=res.params, x_mean=x_mean.to(dtype), x_std=x_std.to(dtype),
                             d_mean=d_mean.to(dtype), d_std=d_std.to(dtype),
                             n_state=x_traj.shape[-1], n_control=u_traj.shape[-1])


def one_step_error(model: DynamicsSurrogate, x_traj, u_traj) -> torch.Tensor:
    """Held-out one-step relative L2 error (model-quality gate)."""
    pred = model(x_traj[:, :-1], u_traj)
    err = torch.linalg.norm(pred - x_traj[:, 1:])
    return err / torch.clamp(torch.linalg.norm(x_traj[:, 1:]), min=1e-30)


def surrogate_mpc_plan(model: DynamicsSurrogate, cfg: MPCConfig, x0, x_target, u_init=None):
    """Plan over the learned model (generic gradient MPC underneath)."""
    if u_init is None:
        u_init = torch.zeros((cfg.horizon, model.n_control), dtype=model.x_mean.dtype,
                             device=x0.device)
    return plan(model.derivative(cfg.dt), cfg, x0, x_target, u_init)


def surrogate_mpc_closed_loop(model: DynamicsSurrogate, true_plant, cfg: MPCConfig, x0,
                              x_target, *, n_steps: int):
    """Receding-horizon control of the TRUE plant using the learned model
    for planning; ``true_plant(x, u)`` is the continuous-form real dynamics."""
    return mpc_closed_loop(model.derivative(cfg.dt), true_plant, cfg, x0, x_target, n_steps,
                           nu=model.n_control)
