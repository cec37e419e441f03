"""QLKNN-class neural-turbulence feature pipeline and training lane (port of
``scpn_fusion_tpu/models/surrogates/qlknn.py``).

Banana-regime electron collisionality, the profile -> 10-feature QLKNN
normaliser (a second-order gradient on a non-uniform grid), the synthetic
parameter scan with the Jenko critical-gradient analytic targets, and the
features -> fluxes wrapper.  Training rides the port's MLP and its Adam
(``mlp.train_mlp``).

The draws rule: :func:`generate_parameter_scan` and :func:`train_qlknn`
draw from a ``torch.Generator``; their twins take the draws
(:func:`_parameter_scan` the (n, 10) uniforms; :func:`_train_qlknn` the
uniforms, the initial parameters and the minibatch indices), so a test can
feed them JAX's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.surrogates.mlp import (
    MLPParams,
    _train_mlp,
    batch_indices,
    init_mlp,
    mlp_apply,
)

E_CHARGE = 1.602176634e-19
M_ELECTRON = 9.1093837015e-31
EPS0 = 8.8541878128e-12
LN_LAMBDA = 17.0
MU0 = 4.0e-7 * math.pi

# Uniform sampling bounds of the 10D QLKNN space:
# [R/L_Ti, R/L_Te, R/L_ne, q, s_hat, alpha_MHD, Ti/Te, nu*, Z_eff, eps]
FEATURE_BOUNDS = np.array([
    [0.0, 15.0], [0.0, 15.0], [-5.0, 10.0], [0.5, 5.0], [-1.0, 3.0],
    [0.0, 2.0], [0.1, 2.0], [1e-3, 1.0], [1.0, 3.0], [0.01, 0.3]])


def _grad_nonuniform(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Second-order gradient on a non-uniform strictly increasing grid."""
    h_l = x[1:-1] - x[:-2]
    h_r = x[2:] - x[1:-1]
    interior = (h_l**2 * y[2:] - h_r**2 * y[:-2]
                + (h_r**2 - h_l**2) * y[1:-1]) / (h_l * h_r * (h_l + h_r))
    first = (y[1] - y[0]) / (x[1] - x[0])
    last = (y[-1] - y[-2]) / (x[-1] - x[-2])
    return torch.cat([first[None], interior, last[None]])


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def electron_collisionality_star(ne_19, te_kev, q, r0: float, epsilon,
                                 z_eff=1.5) -> torch.Tensor:
    """Banana-regime electron collisionality ``nu* = nu_ee q R0 /
    (eps^1.5 v_the)``."""
    if r0 <= 0.0 or not np.isfinite(r0):
        raise ValueError("R0 must be finite and positive")
    ne_19 = torch.as_tensor(ne_19)
    ne_m3 = ne_19 * 1e19
    te_j = torch.clamp(_like(te_kev, ne_19), min=1e-3) * 1e3 * E_CHARGE
    v_the = torch.sqrt(2.0 * te_j / M_ELECTRON)
    nu_ee = (ne_m3 * torch.clamp(_like(z_eff, ne_19), min=1.0) * E_CHARGE**4
             * LN_LAMBDA
             / (12.0 * math.pi**1.5 * EPS0**2 * math.sqrt(M_ELECTRON)
                * te_j**1.5))
    nu_star = nu_ee * _like(q, ne_19) * r0 / (
        torch.clamp(_like(epsilon, ne_19), min=1e-4) ** 1.5 * v_the)
    return torch.clamp(nu_star, min=0.0)


def qlknn_features_from_profiles(te, ti, ne, q, r, *, r0: float, a: float,
                                 b0: float) -> torch.Tensor:
    """Physical profiles -> (N, 10) dimensionless QLKNN inputs."""
    r = torch.as_tensor(r)
    if r.ndim != 1 or r.shape[0] < 2:
        raise ValueError("r profile must be 1D with at least two points")
    if r0 <= 0.0 or a <= 0.0 or b0 <= 0.0:
        raise ValueError("R0, a, and B0 must be positive")
    te, ti, ne, q = (_like(v, r) for v in (te, ti, ne, q))
    for v in (te, ti, ne, q):
        if v.shape != r.shape:
            raise ValueError(
                "Te, Ti, ne, q, and r profiles must have the same shape")

    grad_te = _grad_nonuniform(te, r)
    grad_ti = _grad_nonuniform(ti, r)
    grad_ne = _grad_nonuniform(ne, r)
    grad_q = _grad_nonuniform(q, r)

    r_l_ti = -r0 / torch.clamp(ti, min=1e-3) * grad_ti
    r_l_te = -r0 / torch.clamp(te, min=1e-3) * grad_te
    r_l_ne = -r0 / torch.clamp(ne, min=1e-3) * grad_ne
    s_hat = r / torch.clamp(q, min=1e-3) * grad_q
    p = 2.0 * ne * 1e19 * te * 1e3 * E_CHARGE
    alpha_mhd = -(q**2) * r0 * _grad_nonuniform(p, r) * 2.0 * MU0 / b0**2
    ti_te = ti / torch.clamp(te, min=1e-3)
    epsilon = r / r0
    z_eff = torch.full_like(r, 1.5)
    nu_star = electron_collisionality_star(ne, te, q, r0, epsilon, z_eff)
    return torch.stack([r_l_ti, r_l_te, r_l_ne, q, s_hat, alpha_mhd, ti_te,
                        nu_star, z_eff, epsilon], dim=1)


def generate_parameter_scan(generator: torch.Generator, n_samples: int, *,
                            device: torch.device | str = "cuda") -> torch.Tensor:
    """Uniform random sampling of the 10D QLKNN space (float32, as JAX's)."""
    u = torch.rand((n_samples, 10), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return _parameter_scan(u.to(device))


def _parameter_scan(u: torch.Tensor) -> torch.Tensor:
    """:func:`generate_parameter_scan` on the given (n, 10) uniforms in [0, 1)."""
    lo = torch.as_tensor(FEATURE_BOUNDS[:, 0], dtype=torch.float32, device=u.device)
    hi = torch.as_tensor(FEATURE_BOUNDS[:, 1], dtype=torch.float32, device=u.device)
    return lo + u * (hi - lo)


def analytic_targets(inputs: torch.Tensor) -> torch.Tensor:
    """Jenko critical-gradient quasilinear targets ``[Q_i, Q_e, Gamma_e]`` in
    gyro-Bohm units."""
    x = torch.as_tensor(inputs)
    if x.ndim != 2 or x.shape[1] != 10:
        raise ValueError("inputs must have shape (n_samples, 10)")
    r_l_ti, ti_te = x[:, 0], x[:, 6]
    r_l_ne, q = x[:, 2], x[:, 3]
    s_hat, eps, nu_star = x[:, 4], x[:, 9], x[:, 7]

    crit = ((1.0 + ti_te) * torch.clamp(1.33 + 1.91 * s_hat / q, min=0.0)
            * (1.0 - 1.5 * eps))
    crit = torch.clamp(crit, min=0.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    q_i = torch.where(r_l_ti > crit, 5.0 * torch.clamp(r_l_ti - crit, min=0.0) ** 1.5, zero)
    drive = r_l_ne - 2.0
    tem_damping = 1.0 / torch.sqrt(1.0 + torch.clamp(nu_star, min=0.0))
    q_e = torch.where(drive > 0.0, 2.0 * drive * tem_damping, zero)
    gamma_e = torch.where(drive > 0.0, drive * tem_damping, zero)
    return torch.stack([q_i, q_e, gamma_e], dim=1)


class QLKNNModel(NamedTuple):
    """Trained surrogate + input standardisation."""

    params: MLPParams
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_scale: torch.Tensor


def train_qlknn(generator: torch.Generator, *, n_samples: int = 8192,
                hidden: tuple[int, ...] = (64, 64), n_steps: int = 3000,
                lr: float = 1e-3, device: torch.device | str = "cuda") -> QLKNNModel:
    """Distil the analytic quasilinear closure into an MLP: the scan, the He
    initialisation and the minibatch indices (256 a step) drawn from
    ``generator``."""
    u = torch.rand((n_samples, 10), generator=generator, dtype=torch.float32,
                   device=generator.device).to(device)
    params = init_mlp(generator, (10, *hidden, 3), device=device)
    idx = batch_indices(generator, n_steps, 256, n_samples, device)
    return _train_qlknn(u, params, idx, lr=lr)


def _train_qlknn(u: torch.Tensor, params: MLPParams, batch_idx: torch.Tensor, *,
                 lr: float = 1e-3) -> QLKNNModel:
    """:func:`train_qlknn` on the given uniforms, initial parameters and
    (n_steps, 256) minibatch indices."""
    x = _parameter_scan(u)
    y = analytic_targets(x)
    x_mean, x_std = x.mean(0), torch.clamp(x.std(0, correction=0), min=1e-6)
    y_scale = torch.clamp(y.std(0, correction=0), min=1e-6)
    result = _train_mlp(params, (x - x_mean) / x_std, y / y_scale, batch_idx, lr=lr)
    return QLKNNModel(params=result.params, x_mean=x_mean, x_std=x_std, y_scale=y_scale)


def predict_fluxes(model: QLKNNModel, features: torch.Tensor) -> torch.Tensor:
    """(N, 10) features -> (N, 3) non-negative GB fluxes."""
    z = (torch.as_tensor(features) - model.x_mean) / model.x_std
    return torch.clamp(mlp_apply(model.params, z) * model.y_scale, min=0.0)


def fluxes_from_profiles(model: QLKNNModel, te, ti, ne, q, r, *,
                         r0: float, a: float, b0: float) -> torch.Tensor:
    """End to end: profiles -> features -> GB fluxes."""
    feats = qlknn_features_from_profiles(te, ti, ne, q, r, r0=r0, a=a, b0=b0)
    return predict_fluxes(model, feats)
