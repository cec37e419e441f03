"""Physics-facing controllers: density, burn, detachment, fault tolerance
(port of ``scpn_fusion_tpu/control/plasma_controllers.py``).

Every controller is (state, observation) -> (state, action) as a pure
function with the reference's NaN fail-safe (a non-finite observation
freezes the action at zero command).  The detachment loop is a plain loop of
200 ticks of 0-d ops over the port's two-point SOL model (the JAX package
runs it as one ``lax.scan``).  Functions of Python numbers take ``dtype``
and ``device``; functions of tensors follow them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import two_point_sol


def _failsafe(value: torch.Tensor, fallback: float = 0.0) -> torch.Tensor:
    return torch.where(torch.isfinite(value), value, torch.full_like(value, fallback))


def _like(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Density controller (gas puff + Greenwald ceiling)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DensityControllerParams:
    kp: float = 2.0
    ki: float = 0.5
    puff_max: float = 10.0           # max gas-puff command [a.u.]
    greenwald_fraction_max: float = 0.85
    pumpout_rate: float = 0.2        # density decay toward wall pumping


class DensityControllerState(NamedTuple):
    integral: torch.Tensor


def density_controller_step(p: DensityControllerParams, state: DensityControllerState, ne19,
                            ne19_target, ip_ma, a_m, dt):
    """PI gas-puff command; the target is capped at the Greenwald ceiling."""
    like = state.integral
    ne19, ne19_target, ip_ma = (_like(v, like) for v in (ne19, ne19_target, ip_ma))
    n_gw19 = 10.0 * ip_ma / (math.pi * a_m ** 2)
    target = torch.minimum(ne19_target, p.greenwald_fraction_max * n_gw19)
    err = _failsafe(target - ne19)
    integral = torch.clamp(state.integral + err * dt, -10.0, 10.0)
    puff = torch.clamp(p.kp * err + p.ki * integral, 0.0, p.puff_max)
    return DensityControllerState(integral=integral), puff


def density_plant_step(ne19, puff, p: DensityControllerParams, dt):
    """Reduced fueling plant: dn/dt = puff - pumpout * n."""
    return torch.clamp(ne19 + dt * (puff - p.pumpout_rate * ne19), min=0.01)


# ---------------------------------------------------------------------------
# Burn controller (P_aux modulation toward a target temperature)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BurnControllerParams:
    kp: float = 5.0
    ki: float = 1.0
    p_aux_min_mw: float = 0.0
    p_aux_max_mw: float = 100.0
    slew_mw_s: float = 20.0


class BurnControllerState(NamedTuple):
    integral: torch.Tensor
    p_aux_mw: torch.Tensor


def burn_controller_step(p: BurnControllerParams, state: BurnControllerState, t_kev,
                         t_target_kev, dt):
    """PI on core temperature via auxiliary heating with slew + saturation
    (anti-windup: the integral only accumulates when unsaturated)."""
    like = state.integral
    err = _failsafe(_like(t_target_kev, like) - _like(t_kev, like))
    raw = p.kp * err + p.ki * state.integral
    lo, hi = p.p_aux_min_mw, p.p_aux_max_mw
    slewed = torch.clamp(raw, state.p_aux_mw - p.slew_mw_s * dt, state.p_aux_mw + p.slew_mw_s * dt)
    cmd = torch.clamp(slewed, lo, hi)
    unsaturated = (cmd > lo + 1e-9) & (cmd < hi - 1e-9)
    integral = state.integral + torch.where(unsaturated, err * dt, torch.zeros_like(err))
    return BurnControllerState(integral=integral, p_aux_mw=cmd), cmd


# ---------------------------------------------------------------------------
# Detachment controller (impurity seeding on target heat flux)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DetachmentControllerParams:
    q_target_mw_m2: float = 5.0
    kp: float = 0.08
    ki: float = 0.02
    f_rad_max: float = 0.99
    r0_m: float = 6.2
    a_m: float = 2.0
    q95: float = 3.5
    b_pol_t: float = 1.2
    # parallel -> target-surface projection: field-line tilt * flux expansion
    tilt_sin: float = 0.05
    f_expansion: float = 8.0


class DetachmentControllerState(NamedTuple):
    f_rad: torch.Tensor      # commanded radiated fraction (seeding level)
    integral: torch.Tensor


def target_surface_flux(p: DetachmentControllerParams, q_parallel_mw_m2, f_rad):
    """Perpendicular flux on the target plate: parallel flux reduced by
    radiation, field-line tilt and poloidal flux expansion."""
    return q_parallel_mw_m2 * (1.0 - f_rad) * p.tilt_sin / max(p.f_expansion, 1.0)


def detachment_controller_step(p: DetachmentControllerParams, state: DetachmentControllerState,
                               p_sol_mw, n_u_19, dt):
    """Regulate the target heat flux by impurity seeding against the
    two-point SOL model."""
    sol = two_point_sol(p_sol_mw=p_sol_mw, n_u_19=n_u_19, r0=p.r0_m, a=p.a_m, q95=p.q95,
                        b_pol=p.b_pol_t, f_rad=state.f_rad)
    q_t = target_surface_flux(p, sol.q_parallel_mw_m2, state.f_rad)
    err = _failsafe(q_t - p.q_target_mw_m2)       # positive -> seed more
    integral = torch.clamp(state.integral + err * dt, -50.0, 50.0)
    f_rad = torch.clamp(state.f_rad + p.kp * err * dt + p.ki * integral * dt, 0.0, p.f_rad_max)
    return DetachmentControllerState(f_rad=f_rad, integral=integral), f_rad, sol


def run_detachment_loop(p: DetachmentControllerParams, *, p_sol_mw, n_u_19, dt=0.05,
                        n_steps: int = 200, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda"):
    """The seeding loop, ``n_steps`` ticks; returns (final state, f_rad
    trace, q_target trace)."""
    zero = torch.zeros((), dtype=dtype, device=device)
    state = DetachmentControllerState(f_rad=zero, integral=zero.clone())
    f_rad_tr, q_tr = [], []
    for _ in range(n_steps):
        state, f_rad, sol = detachment_controller_step(p, state, p_sol_mw, n_u_19, dt)
        f_rad_tr.append(f_rad)
        q_tr.append(target_surface_flux(p, sol.q_parallel_mw_m2, f_rad))
    return state, torch.stack(f_rad_tr), torch.stack(q_tr)


# ---------------------------------------------------------------------------
# Fault-tolerant control (sensor voting + actuator reallocation)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultToleranceParams:
    residual_threshold: float = 3.0     # sigma units
    min_healthy_sensors: int = 2


class FaultReport(NamedTuple):
    healthy: torch.Tensor        # (n_sensors,) bool
    fused_estimate: torch.Tensor
    degraded: torch.Tensor       # bool: too few healthy sensors


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor, as JAX computes it: the non-NaN
    values sorted, the linear quantile at 0.5 (count - 1), i.e. ``lo * 0.5 +
    hi * 0.5`` of the middle pair for an even count (``torch.nanmedian``
    returns the lower one); NaN when every value is NaN.  No host read."""
    vals = torch.sort(x).values                       # NaNs sort last
    n = (~torch.isnan(x)).sum().to(x.dtype)
    q = 0.5 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    zero = torch.zeros_like(n)
    i_low = torch.maximum(zero, torch.minimum(low, n - 1.0)).long()
    i_high = torch.maximum(zero, torch.minimum(high, n - 1.0)).long()
    return vals[i_low] * w_low + vals[i_high] * w_high


def sensor_vote(readings: torch.Tensor, sigma: torch.Tensor,
                p: FaultToleranceParams = FaultToleranceParams()) -> FaultReport:
    """Median-residual fault detection + inverse-variance fusion: a sensor is
    faulted when its residual against the median exceeds ``threshold *
    sigma`` or is non-finite."""
    finite = torch.isfinite(readings)
    safe = torch.where(finite, readings, torch.zeros_like(readings))
    med = nanmedian(torch.where(finite, readings, torch.full_like(readings, math.nan)))
    med = torch.where(torch.isfinite(med), med, torch.zeros_like(med))
    resid = torch.abs(safe - med) / torch.clamp(sigma, min=1e-12)
    healthy = finite & (resid < p.residual_threshold)
    w = torch.where(healthy, 1.0 / torch.clamp(sigma, min=1e-12) ** 2, torch.zeros_like(sigma))
    fused = torch.sum(w * safe) / torch.clamp(torch.sum(w), min=1e-30)
    degraded = torch.sum(healthy) < p.min_healthy_sensors
    fused = torch.where(degraded, med, fused)
    return FaultReport(healthy=healthy, fused_estimate=fused, degraded=degraded)


def reallocate_actuators(demand, available: torch.Tensor,
                         effectiveness: torch.Tensor) -> torch.Tensor:
    """Redistribute a total demand over healthy actuators, weighted by
    effectiveness (failed actuators get zero)."""
    w = torch.where(available, torch.clamp(effectiveness, min=0.0),
                    torch.zeros_like(effectiveness))
    total_w = torch.clamp(torch.sum(w), min=1e-30)
    return demand * w / total_w
