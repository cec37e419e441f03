"""Mean-field Kuramoto-Sakaguchi oscillators with a global field driver
(port of ``scpn_fusion_tpu/models/phase/kuramoto.py``).

    dtheta_i/dt = omega_i + K R sin(psi_r - theta_i - alpha)
                  + zeta sin(Psi - theta_i)

where (R, psi_r) is the Kuramoto order parameter and Psi is an exogenous
global driver phase ("external") or the mean-field phase ("mean_field").
The JAX package runs a trajectory as one ``lax.scan``; the port runs
:func:`run_kuramoto` as a Python loop of plain ops (~15 launches a step for
its one population; no caller runs it at scale).  The Lyapunov diagnostics
V = <1 - cos(theta - Psi)> and lambda = ln(V_T/V_0)/T come out of the same
loop.  ``jnp.mean`` is the sum times the reciprocal of the count, as XLA
rounds it (``core.grid.xla_mean``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import as_tensors, xla_mean


def wrap_phase(x: torch.Tensor) -> torch.Tensor:
    """Map phases to (-pi, pi]: ``(x + pi) % 2pi - pi``, the remainder
    taking the divisor's sign (``fmod``, then the divisor added where the
    signs differ), pi and 2pi rounded to the dtype once."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def order_parameter(theta: torch.Tensor, weights: torch.Tensor | None = None):
    """Kuramoto order parameter R e^{i psi} = <w e^{i theta}>/W -> (R, psi)."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    if weights is None:
        zr, zi = xla_mean(c), xla_mean(s)
    else:
        w_sum = torch.clamp(torch.sum(weights), min=1e-15)
        zr = torch.sum(weights * c) / w_sum
        zi = torch.sum(weights * s) / w_sum
    return torch.sqrt(zr * zr + zi * zi), torch.atan2(zi, zr)


def lyapunov_v(theta: torch.Tensor, psi) -> torch.Tensor:
    """V = <1 - cos(theta - Psi)>; 0 at sync, 2 at max desync."""
    return xla_mean(1.0 - torch.cos(theta - psi))


def lyapunov_exponent(v_hist, dt) -> torch.Tensor:
    """lambda = ln(V_final/V_initial)/T over the sampled window."""
    if not isinstance(v_hist, torch.Tensor):
        (v_hist,) = as_tensors(v_hist, dtype=torch.float64, device="cpu")
    n = v_hist.shape[0]
    v0 = torch.clamp(v_hist[0], min=1e-15)
    vf = torch.clamp(v_hist[-1], min=1e-15)
    return torch.log(vf / v0) / (n * torch.as_tensor(dt, dtype=v_hist.dtype,
                                                     device=v_hist.device))


def resolve_psi(theta: torch.Tensor, psi_external, mode: str = "external"):
    """Global driver phase: caller-supplied carrier or the mean field."""
    if mode == "external":
        return torch.as_tensor(psi_external, dtype=theta.dtype, device=theta.device)
    if mode == "mean_field":
        return order_parameter(theta)[1]
    raise ValueError(f"unknown psi mode {mode!r}")


def kuramoto_step(theta: torch.Tensor, omega: torch.Tensor, *, dt, k_coupling, alpha=0.0,
                  zeta=0.0, psi=0.0, wrap: bool = True):
    """One Euler step; ``psi`` must already be resolved (see resolve_psi).

    Returns (theta1, aux) with aux = dict(R, psi_r, dtheta).
    """
    r, psi_r = order_parameter(theta)
    dtheta = omega + (k_coupling * r) * torch.sin(psi_r - theta - alpha)
    dtheta = dtheta + zeta * torch.sin(psi - theta)
    theta1 = theta + dt * dtheta
    if wrap:
        theta1 = wrap_phase(theta1)
    return theta1, {"R": r, "psi_r": psi_r, "dtheta": dtheta}


class KuramotoTrace(NamedTuple):
    theta: torch.Tensor       # (n_steps, N)
    r: torch.Tensor           # (n_steps,)
    v: torch.Tensor           # (n_steps,) Lyapunov V against the driver
    lambda_exp: torch.Tensor  # scalar


def run_kuramoto(theta0, omega, *, dt, k_coupling, alpha=0.0, zeta=0.0, psi_external=0.0,
                 psi_mode: str = "external", n_steps: int = 1000,
                 dtype: torch.dtype | None = None,
                 device: torch.device | str = "cuda") -> KuramotoTrace:
    """Whole trajectory with its Lyapunov history, a loop of plain ops.
    ``theta0`` and ``omega`` given as tensors set the device and (unless
    ``dtype`` is given) the dtype; else ``dtype`` (float32 by default) on
    ``device``."""
    theta, omega = as_tensors(theta0, omega, dtype=dtype, device=device)
    thetas, rs, vs = [], [], []
    for _ in range(n_steps):
        psi = resolve_psi(theta, psi_external, psi_mode)
        theta, aux = kuramoto_step(theta, omega, dt=dt, k_coupling=k_coupling, alpha=alpha,
                                   zeta=zeta, psi=psi)
        thetas.append(theta)
        rs.append(aux["R"])
        vs.append(lyapunov_v(theta, psi))
    v = torch.stack(vs)
    return KuramotoTrace(torch.stack(thetas), torch.stack(rs), v, lyapunov_exponent(v, dt))
