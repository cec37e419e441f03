"""Extended Kalman filter for plasma state estimation (port of
``scpn_fusion_tpu/control/estimator.py``).

6D state [R, Z, vR, vZ, Ip, Te_core], 4D measurement [R, Z, Ip, Te_core],
constant-velocity process model; the state is an explicit NamedTuple.  The
JAX module takes its default float type from ``core.dtypes``; the port takes
explicit torch dtypes (the filter runs in the state's).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EKFState(NamedTuple):
    x: torch.Tensor   # (6,)
    p: torch.Tensor   # (6, 6)


def ekf_init(x0: torch.Tensor, p0: torch.Tensor) -> EKFState:
    return EKFState(torch.as_tensor(x0), torch.as_tensor(p0))


def measurement_matrix(dtype: torch.dtype = torch.float64,
                       device: torch.device | str = "cuda") -> torch.Tensor:
    h = torch.zeros((4, 6), dtype=dtype, device=device)
    h[0, 0] = h[1, 1] = h[2, 4] = h[3, 5] = 1.0
    return h


def ekf_predict(state: EKFState, q: torch.Tensor, dt) -> EKFState:
    """Constant-velocity prediction: R += vR dt, Z += vZ dt."""
    f = torch.eye(6, dtype=state.x.dtype, device=state.x.device)
    f[0, 2] = dt
    f[1, 3] = dt
    x = f @ state.x
    p = f @ state.p @ f.T + q * dt
    return EKFState(x, p)


def ekf_update(state: EKFState, z: torch.Tensor, r_cov: torch.Tensor) -> EKFState:
    """Measurement update with the linear H (Joseph-free standard form)."""
    h = measurement_matrix(state.x.dtype, state.x.device)
    y = z - h @ state.x
    s = h @ state.p @ h.T + r_cov
    k = state.p @ h.T @ torch.linalg.inv(s)
    x = state.x + k @ y
    p = (torch.eye(6, dtype=state.x.dtype, device=state.x.device) - k @ h) @ state.p
    return EKFState(x, p)


def ekf_step(state: EKFState, z: torch.Tensor, q: torch.Tensor, r_cov: torch.Tensor,
             dt) -> EKFState:
    """Predict + update in one call (per control tick)."""
    return ekf_update(ekf_predict(state, q, dt), z, r_cov)
