"""Adaptive time stepping of the CN transport stepper: Richardson error and a
PI controller (port of ``scpn_fusion_tpu/models/transport/adaptive.py``).

Each step solves one full dt step and two half steps; CN is second order, so
``err = ||T_full - T_half|| / (2^p - 1)`` with p = 2.  dt follows the PI law
``dt *= clip(safety * (tol/err)^(0.7/p) * (err_prev/err)^(0.4/p), 0.1, 2)``
within [dt_min, dt_max], and the half-step result is accepted.  JAX runs the
whole trajectory as one ``lax.scan``; here it is a Python loop whose only
host reads are the Picard residuals inside the steps: dt stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.transport.solver import (
    TransportParams,
    TransportState,
    evolve_profiles,
)

_P_ORDER = 2  # Crank-Nicolson is second order


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """PI controller knobs (reference defaults)."""

    dt_init: float = 0.01
    dt_min: float = 1e-5
    dt_max: float = 1.0
    tol: float = 1e-3
    safety: float = 0.9


class AdaptiveTrace(NamedTuple):
    dt: torch.Tensor          # (n_steps,) dt used by each step
    error: torch.Tensor       # (n_steps,) Richardson error estimates
    time: torch.Tensor        # (n_steps,) cumulative simulated time
    ti0: torch.Tensor         # (n_steps,) near-axis ion temperature


def _pi_factor(cfg: AdaptiveConfig, err: torch.Tensor, err_prev: torch.Tensor) -> torch.Tensor:
    """PI step-size factor, clipped to [0.1, 2] (reference ``adapt_dt``)."""
    ratio_i = (torch.full_like(err, cfg.tol) / err) ** (0.7 / _P_ORDER)
    ratio_p = (err_prev / err) ** (0.4 / _P_ORDER)
    return torch.clamp(cfg.safety * ratio_i * ratio_p, 0.1, 2.0)


def run_transport_adaptive(
    s: TransportState,
    p_aux_mw,
    params: TransportParams,
    *,
    cfg: AdaptiveConfig = AdaptiveConfig(),
    n_steps: int = 50,
    surrogate=None,
) -> tuple[TransportState, AdaptiveTrace]:
    """Run ``n_steps`` adaptive CN steps on the state's device: full-dt step
    and two half-dt steps -> Richardson error -> accept the half-step state
    -> PI-update dt for the next step."""
    dt = torch.full((), cfg.dt_init, dtype=s.ti.dtype, device=s.ti.device)
    err_prev = torch.full_like(dt, cfg.tol)
    t_now = torch.zeros_like(dt)
    rows: list[tuple] = []
    for _ in range(n_steps):
        full = evolve_profiles(s, dt, p_aux_mw, params, surrogate)
        half = evolve_profiles(s, 0.5 * dt, p_aux_mw, params, surrogate)
        half = evolve_profiles(half, 0.5 * dt, p_aux_mw, params, surrogate)
        err = torch.clamp(
            torch.linalg.vector_norm(torch.cat([full.ti - half.ti, full.te - half.te]))
            / (2.0**_P_ORDER - 1.0), min=1e-15)
        dt_next = torch.clamp(dt * _pi_factor(cfg, err, err_prev), cfg.dt_min, cfg.dt_max)
        t_now = t_now + dt
        rows.append((dt, err, t_now, half.ti[1]))
        s, dt, err_prev = half, dt_next, err
    if not rows:
        empty = dt.new_zeros(0)
        return s, AdaptiveTrace(empty, empty, empty, empty)
    return s, AdaptiveTrace(*(torch.stack(col) for col in zip(*rows)))
