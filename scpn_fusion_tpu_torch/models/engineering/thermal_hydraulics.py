"""Coolant-loop thermal hydraulics: friction factor + pumping power (port of
``scpn_fusion_tpu/models/engineering/thermal_hydraulics.py``).

The reference's lumped loop model (Churchill all-regime Darcy friction
factor + Darcy-Weisbach pressure drop + pump power for water/helium/LiPb
loops) as batched PyTorch functions: design scans over (Q, delta_T, L, D)
envelopes are one call, and the friction factor is smooth and
differentiable for gradient-based BoP optimisation (inputs are clamped so
the function is total).  Python numbers become tensors of ``dtype``
(float32 by default) on ``device``; a tensor input sets both.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import as_tensors

#: Thermophysical properties at ~300 C (reference ``CoolantLoop.__init__``).
COOLANTS = {
    "water": {"rho": 700.0, "mu": 1e-4, "cp": 5000.0},
    "helium": {"rho": 5.0, "mu": 3e-5, "cp": 5190.0},
    "lipb": {"rho": 9000.0, "mu": 1e-3, "cp": 190.0},
}


def churchill_friction_factor(re, epsilon_d=1e-4, *, dtype=None, device="cuda"):
    """Churchill correlation for the Darcy friction factor (all regimes:
    laminar / transition / turbulent; reference ``:38-53``)."""
    (re,) = as_tensors(re, dtype=dtype, device=device)
    re = torch.clamp(re, min=1e-3)
    a = (2.457 * torch.log(1.0 / ((7.0 / re) ** 0.9 + 0.27 * epsilon_d))) ** 16
    b = (37530.0 / re) ** 16
    return 8.0 * ((8.0 / re) ** 12 + 1.0 / (a + b) ** 1.5) ** (1.0 / 12.0)


class PumpingPower(NamedTuple):
    mdot_kg_s: torch.Tensor
    velocity_m_s: torch.Tensor
    reynolds: torch.Tensor
    friction_factor: torch.Tensor
    dp_pa: torch.Tensor
    p_pump_mw: torch.Tensor


def pumping_power(q_thermal_mw, *, coolant: str = "water", delta_t=50.0, pipe_length_m=100.0,
                  pipe_diameter_m=0.05, eta_pump: float = 0.8, dtype=None,
                  device="cuda") -> PumpingPower:
    """Pumping power to exhaust ``q_thermal_mw`` through the loop
    (reference ``calculate_pumping_power:71-118``): mdot = Q/(cp dT),
    Darcy-Weisbach dP = f (L/D) rho v^2/2, P = dP mdot/(rho eta).  The
    thermal duty, the temperature rise, the length and the diameter may be
    tensors (a scan; the diameter differentiable)."""
    p = COOLANTS[coolant]
    q, delta_t, pipe_length_m, pipe_diameter_m = as_tensors(
        q_thermal_mw, delta_t, pipe_length_m, pipe_diameter_m, dtype=dtype, device=device)
    q = torch.clamp(q, min=0.0)
    mdot = q * 1e6 / (p["cp"] * delta_t)
    area = math.pi * (pipe_diameter_m / 2.0) ** 2
    v = mdot / (p["rho"] * area)
    re = p["rho"] * v * pipe_diameter_m / p["mu"]
    f = churchill_friction_factor(re)
    dp = f * (pipe_length_m / pipe_diameter_m) * p["rho"] * v**2 / 2.0
    p_pump = dp * (mdot / p["rho"]) / eta_pump
    return PumpingPower(mdot, v, re, f, dp, p_pump / 1e6)
