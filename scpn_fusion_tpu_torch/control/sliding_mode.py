"""Super-twisting sliding-mode vertical stabiliser (port of
``scpn_fusion_tpu/control/sliding_mode.py``).

Second-order sliding mode u = -alpha sqrt(|s|) sign(s) + v,
dv/dt = -beta sign(s), s = e + c de/dt, with actuator saturation, plus the
Lyapunov gain certificate and the finite-time convergence bound.  State is
carried functionally (``smc_step(params, v, e, de) -> (u, v')``), and a
closed-loop shot (:func:`run_smc_vertical`, one ``lax.scan`` in JAX) is a
Python loop over steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class SMCParams:
    alpha: float = 5.0      # proportional sqrt gain
    beta: float = 3.0       # integral switching gain
    c: float = 0.1          # sliding-surface velocity weight [s]
    u_max: float = 10.0     # actuator saturation


def sliding_surface(p: SMCParams, e, de_dt):
    """s = e + c de/dt."""
    return e + p.c * de_dt


def smc_step(p: SMCParams, v, e, de_dt, dt):
    """One super-twisting update; returns (u, v_next)."""
    s = sliding_surface(p, e, de_dt)
    v_next = torch.clamp(v - p.beta * torch.sign(s) * dt, -p.u_max, p.u_max)
    u = -p.alpha * torch.sqrt(s.abs()) * torch.sign(s) + v_next
    return torch.clamp(u, -p.u_max, p.u_max), v_next


def lyapunov_certificate(alpha: float, beta: float, l_max: float) -> bool:
    """Gain conditions alpha > sqrt(2 L), beta > L for finite-time stability
    under |disturbance rate| <= L."""
    l_safe = max(l_max, 1e-12)
    return alpha > math.sqrt(2.0 * l_safe) and beta > l_safe


def estimate_convergence_time(alpha: float, beta: float, l_max: float, s0: float) -> float:
    """Upper bound t_reach <= 2 sqrt(|s0|) / (alpha - sqrt(2 L))."""
    if l_max < 0:
        return float("inf")
    denom = alpha - math.sqrt(2.0 * l_max)
    if denom <= 0:
        return float("inf")
    return 2.0 * math.sqrt(abs(s0)) / denom


class SMCTrace(NamedTuple):
    z: torch.Tensor
    u: torch.Tensor
    s: torch.Tensor


def run_smc_vertical(p: SMCParams, *, z0: float, dz0: float, gamma: float, control_gain: float,
                     z_ref: float = 0.0, dt: float = 1e-4, n_steps: int = 5000,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda") -> SMCTrace:
    """Closed-loop shot against the unstable rigid plant
    d2Z/dt2 = gamma^2 (Z - Z_axis) + g u (float32, as JAX's, unless
    ``dtype`` says otherwise)."""
    z, dz, v = (torch.tensor(x, dtype=dtype, device=device) for x in (z0, dz0, 0.0))
    rows = []
    for _ in range(n_steps):
        e = z - z_ref
        u, v = smc_step(p, v, e, dz, dt)
        ddz = gamma ** 2 * (z - z_ref) + control_gain * u
        dz = dz + dt * ddz
        z = z + dt * dz
        rows.append((z, u, sliding_surface(p, e, dz)))
    return SMCTrace(*(torch.stack(col) for col in zip(*rows)))
