"""HEAT-ML magnetic-shadow divertor surrogate (port of
``scpn_fusion_tpu/models/surrogates/heat_shadow.py``).

A ridge-fit polynomial surrogate for the divertor magnetic-shadow fraction,
a synthetic reference law to generate its dataset, the shadow -> heat-flux
attenuation and an RMSE% quality metric.  The model is a weights vector:
``fit`` returns it, ``predict`` is a plain function of (weights, features).
The ridge normal equations are solved by a Cholesky factor on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

N_FEATURES = 7


class ShadowDataset(NamedTuple):
    features: torch.Tensor        # (N, 7)
    shadow_fraction: torch.Tensor  # (N,)


def _as_2d(features) -> torch.Tensor:
    x = torch.as_tensor(features)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[1] != N_FEATURES:
        raise ValueError(
            "Expected shape (N, 7): [R, B_pol, P_sol, fx, kappa, delta, xpt_z]")
    return x


def synthetic_shadow_reference(features) -> torch.Tensor:
    """Synthetic reference law for the divertor magnetic-shadow fraction."""
    x = _as_2d(features)
    r, b_pol, p_sol, fx, kappa, delta, xpt_z = [x[:, i] for i in range(7)]
    field_term = 0.20 + 0.24 * torch.tanh(0.65 * (b_pol - 1.3))
    geometry_term = (0.16 * torch.tanh(0.20 * (fx - 10.0))
                     + 0.10 * torch.tanh(1.1 * (kappa - 1.5)))
    xpt_term = 0.08 * torch.exp(-((xpt_z + 1.7) ** 2) / 0.28)
    power_penalty = 0.18 * torch.tanh(0.020 * (p_sol - 70.0))
    shaping_bonus = 0.06 * delta
    shadow = (field_term + geometry_term + xpt_term + shaping_bonus
              - power_penalty)
    return torch.clamp(shadow, 0.03, 0.82)


def generate_shadow_dataset(seed: int, samples: int, *, dtype=torch.float32,
                            device: torch.device | str = "cuda") -> ShadowDataset:
    """Deterministic synthetic training dataset, drawn with numpy as in JAX,
    in ``dtype`` on ``device``."""
    if samples < 8:
        raise ValueError("samples must be >= 8")
    rng = np.random.default_rng(seed)
    feats = np.column_stack([
        rng.uniform(1.0, 3.5, samples),
        rng.uniform(0.8, 3.8, samples),
        rng.uniform(20.0, 180.0, samples),
        rng.uniform(6.0, 24.0, samples),
        rng.uniform(1.2, 2.2, samples),
        rng.uniform(0.05, 0.65, samples),
        rng.uniform(-2.6, -1.1, samples),
    ])
    feats = torch.from_numpy(feats).to(dtype=dtype, device=device)
    return ShadowDataset(features=feats,
                         shadow_fraction=synthetic_shadow_reference(feats))


def _feature_map(features) -> torch.Tensor:
    """Compact polynomial basis."""
    x = _as_2d(features)
    r, b_pol, p_sol, fx, kappa, delta, xpt_z = [x[:, i] for i in range(7)]
    return torch.column_stack([
        torch.ones(x.shape[0], dtype=x.dtype, device=x.device),
        x,
        b_pol * fx,
        p_sol / torch.clamp(fx, min=1e-6),
        kappa * delta,
        torch.exp(-((xpt_z + 1.7) ** 2) / 0.30),
        torch.tanh(0.02 * (p_sol - 70.0)),
        torch.tanh(0.20 * (fx - 10.0)),
        torch.tanh(0.65 * (b_pol - 1.3)),
    ])


def fit_shadow_surrogate(features, target, ridge: float = 1e-4) -> torch.Tensor:
    """Ridge-regularised weights via Cholesky normal equations."""
    ridge = max(float(ridge), 1e-10)
    phi = _feature_map(features)
    y = torch.as_tensor(target).reshape(-1)
    if y.shape[0] != phi.shape[0]:
        raise ValueError("features and target row count mismatch")
    lhs = phi.T @ phi + ridge * torch.eye(phi.shape[1], dtype=phi.dtype, device=phi.device)
    rhs = phi.T @ y
    factor = torch.linalg.cholesky(lhs)
    return torch.cholesky_solve(rhs[:, None], factor)[:, 0]


def fit_synthetic(seed: int = 42, samples: int = 2048, ridge: float = 1e-4, *,
                  dtype=torch.float32, device: torch.device | str = "cuda") -> torch.Tensor:
    ds = generate_shadow_dataset(seed=seed, samples=samples, dtype=dtype, device=device)
    return fit_shadow_surrogate(ds.features, ds.shadow_fraction, ridge)


def predict_shadow_fraction(weights: torch.Tensor, features) -> torch.Tensor:
    """Clipped shadow-fraction prediction."""
    return torch.clamp(_feature_map(features) @ weights, 0.0, 0.85)


def predict_divertor_flux(weights: torch.Tensor, q_div_baseline_w_m2, features) -> torch.Tensor:
    """Shadow-attenuated divertor heat flux, ``q (1 - 0.58 s)``."""
    shadow = predict_shadow_fraction(weights, features)
    return torch.clamp(torch.as_tensor(q_div_baseline_w_m2, dtype=shadow.dtype,
                                       device=shadow.device) * (1.0 - 0.58 * shadow), min=1e-6)


def rmse_percent(y_true, y_pred) -> float:
    """RMSE as % of mean |reference|."""
    yt = np.asarray(_numpy(y_true), np.float64).reshape(-1)
    yp = np.asarray(_numpy(y_pred), np.float64).reshape(-1)
    if yt.size == 0 or yt.shape != yp.shape:
        raise ValueError("y_true/y_pred must be non-empty and same shape")
    rmse = float(np.sqrt(np.mean((yt - yp) ** 2)))
    return 100.0 * rmse / float(max(np.mean(np.abs(yt)), 1e-9))


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
