"""Kadomtsev sawtooth cycle: q=1 trigger, reconnection crash, mixing (port of
``scpn_fusion_tpu/models/physics/sawtooth.py``).

The monitor finds the q=1 radius, the Kadomtsev crash computes the mixing
radius from the helical-flux proxy ``dpsi*/drho = rho (1/q - 1)``, then
flattens density (particle-conserving volume average) and temperature
(energy-conserving pressure average ``T_mix = <nT>/<n>``) inside the mixing
radius and resets the core q just above unity.  Masked arithmetic, no
branch; the crossings are ``jnp.argmax`` of bool masks, taken as uint8
(``torch.argmax`` refuses bool).  Follows the tensors' device and dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SawtoothCrash(NamedTuple):
    t_new: torch.Tensor
    n_new: torch.Tensor
    q_new: torch.Tensor
    rho_1: torch.Tensor       # q=1 radius (nan if none)
    rho_mix: torch.Tensor     # mixing radius
    triggered: torch.Tensor   # bool


def find_q1_radius(rho: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Outermost-inward linear-interpolated q=1 crossing (nan if q>1 all)."""
    nan = torch.full_like(rho[0], math.nan)
    any_below = torch.any(q < 1.0)
    # First index from the axis where q crosses 1 going outward.
    crossing = (q[:-1] < 1.0) & (q[1:] >= 1.0)
    idx = torch.argmax(crossing.to(torch.uint8))
    has_cross = torch.any(crossing)
    frac = (1.0 - q[idx]) / torch.clamp(q[idx + 1] - q[idx], min=1e-12)
    rho_1 = rho[idx] + frac * (rho[idx + 1] - rho[idx])
    rho_1 = torch.where(has_cross, rho_1, torch.where(any_below, rho[-1], nan))
    return torch.where(any_below, rho_1, nan)


def check_trigger(q: torch.Tensor, shear: torch.Tensor, s_crit: float = 0.1) -> torch.Tensor:
    """Crash trigger: q<1 exists and local shear at q=1 exceeds s_crit."""
    below = q < 1.0
    s_at = torch.where(below, shear, torch.zeros_like(shear))
    return torch.any(below) & (torch.max(torch.abs(s_at)) > s_crit)


def kadomtsev_crash(rho: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                    q: torch.Tensor) -> SawtoothCrash:
    """Apply Kadomtsev reconnection mixing (no-op when q >= 1 everywhere)."""
    rho_1 = find_q1_radius(rho, q)
    has_q1 = torch.isfinite(rho_1)

    # Helical flux proxy psi*(rho) by trapezoid integration.
    integrand = rho * (1.0 / torch.clamp(q, min=1e-6) - 1.0)
    d_rho = torch.diff(rho)
    increments = 0.5 * (integrand[1:] + integrand[:-1]) * d_rho
    psi_star = torch.cat([rho.new_zeros(1), torch.cumsum(increments, dim=0)])

    # Mixing radius: first psi* <= 0 crossing beyond rho_1.
    beyond = rho >= torch.where(has_q1, rho_1, torch.full_like(rho_1, math.inf))
    crossed = beyond & (psi_star <= 0.0)
    idx_mix = torch.argmax(crossed.to(torch.uint8))
    any_crossed = torch.any(crossed)
    prev = torch.clamp(idx_mix - 1, min=0)
    frac = psi_star[prev] / torch.clamp(psi_star[prev] - psi_star[idx_mix], min=1e-30)
    rho_mix_val = rho[prev] + frac * (rho[idx_mix] - rho[prev])
    rho_mix = torch.where(any_crossed, rho_mix_val, rho[-1])
    rho_mix = torch.where(has_q1, rho_mix, torch.full_like(rho_mix, math.nan))

    # Conservative mixing inside rho_mix.
    inside = rho < torch.where(has_q1, rho_mix, torch.full_like(rho_mix, -1.0))
    w = torch.where(inside, rho, torch.zeros_like(rho))
    w_sum = torch.clamp(torch.sum(w), min=1e-30)
    n_mix = torch.sum(w * n) / w_sum
    t_mix = torch.sum(w * n * t) / torch.clamp(torch.sum(w * n), min=1e-30)

    t_new = torch.where(inside, t_mix, t)
    n_new = torch.where(inside, n_mix, n)
    q_new = torch.where(inside, torch.full_like(q, 1.01), q)

    return SawtoothCrash(
        t_new=torch.where(has_q1, t_new, t),
        n_new=torch.where(has_q1, n_new, n),
        q_new=torch.where(has_q1, q_new, q),
        rho_1=rho_1, rho_mix=rho_mix, triggered=has_q1)


def sawtooth_step(rho: torch.Tensor, t: torch.Tensor, n: torch.Tensor, q: torch.Tensor,
                  shear: torch.Tensor, s_crit: float = 0.1) -> SawtoothCrash:
    """Monitor + conditional crash in one call."""
    fire = check_trigger(q, shear, s_crit)
    crash = kadomtsev_crash(rho, t, n, q)
    go = fire & crash.triggered
    nan = torch.full_like(crash.rho_1, math.nan)
    return SawtoothCrash(
        t_new=torch.where(go, crash.t_new, t),
        n_new=torch.where(go, crash.n_new, n),
        q_new=torch.where(go, crash.q_new, q),
        rho_1=torch.where(fire, crash.rho_1, nan),
        rho_mix=torch.where(fire, crash.rho_mix, nan),
        triggered=go)
