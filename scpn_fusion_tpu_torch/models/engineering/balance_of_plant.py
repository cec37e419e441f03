"""Balance of plant: fusion power -> grid electricity, with parasitic loads
(port of ``scpn_fusion_tpu/models/engineering/balance_of_plant.py``).

A frozen :class:`PlantParams` and batched PyTorch functions, so whole
operating-point scans (P_fusion x P_aux grids) are one call on the inputs'
device.  :func:`plant_performance` computes in float32 by default, as the
JAX function casts its inputs to float32; the loop hydraulics of Python
constants (the Reynolds number, the Churchill factor, the pressure drop) are
folded on the host in float64, as XLA folds them, and enter as Python
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import as_tensors

# coolant: (density kg/m3, cp J/kgK, viscosity Pa s, dT_loop K)
_COOLANTS = {
    "water": (720.0, 5500.0, 9.0e-5, 40.0),     # PWR-like, 15 MPa
    "helium": (5.0, 5190.0, 4.0e-5, 300.0),     # 8 MPa HTGR-like
    "flibe": (1940.0, 2415.0, 6.0e-3, 100.0),
}


@dataclasses.dataclass(frozen=True)
class PlantParams:
    coolant: str = "water"
    eta_thermal: float = 0.35       # Rankine
    eta_heating: float = 0.40       # wall-plug efficiency of NBI/ECRH
    p_cryo_mw: float = 30.0
    p_misc_mw: float = 15.0
    blanket_multiplication: float = 1.15
    neutron_fraction: float = 0.8   # D-T: 14.1 MeV n of 17.6 MeV
    pipe_diameter_m: float = 0.4
    pipe_length_m: float = 200.0
    flow_velocity_m_s: float = 8.0
    pump_efficiency: float = 0.85

    def __post_init__(self):
        if self.coolant not in _COOLANTS:
            raise ValueError(f"unknown coolant {self.coolant!r}; "
                             f"known: {sorted(_COOLANTS)}")
        if not 0.0 < self.eta_thermal < 1.0:
            raise ValueError("eta_thermal must be in (0, 1)")


class PlantPerformance(NamedTuple):
    p_fusion_mw: torch.Tensor
    p_thermal_mw: torch.Tensor
    p_gross_mw: torch.Tensor
    p_recirc_mw: torch.Tensor
    p_net_mw: torch.Tensor
    q_plasma: torch.Tensor
    q_engineering: torch.Tensor
    p_pump_mw: torch.Tensor
    p_heating_plug_mw: torch.Tensor


def churchill_friction_factor(reynolds, roughness_ratio: float = 1e-4, *, dtype=None,
                              device="cuda"):
    """Churchill (1977) all-regime Darcy friction factor (differentiable;
    reference ``thermal_hydraulics.py:38``)."""
    (re,) = as_tensors(reynolds, dtype=dtype, device=device)
    re = torch.clamp(re, min=1.0)
    a = (2.457 * torch.log(1.0 / ((7.0 / re) ** 0.9 + 0.27 * roughness_ratio))) ** 16
    b = (37530.0 / re) ** 16
    return 8.0 * ((8.0 / re) ** 12 + 1.0 / (a + b) ** 1.5) ** (1.0 / 12.0)


def loop_pressure_drop(params: PlantParams) -> float:
    """Darcy-Weisbach pressure drop [Pa] over the loop at the design flow
    velocity, from the single-pipe Reynolds number (parallel pipes scale
    linearly): a float64 constant of the parameters."""
    rho, _, mu, _ = _COOLANTS[params.coolant]
    v = params.flow_velocity_m_s
    d = params.pipe_diameter_m
    re = rho * v * d / mu
    f = float(churchill_friction_factor(re, dtype=torch.float64, device="cpu"))
    return f * (params.pipe_length_m / d) * 0.5 * rho * v * v


def pumping_power(p_thermal_mw, params: PlantParams, *, dtype=None, device="cuda"):
    """Coolant pumping power [MW] from loop hydraulics.

    Mass flow from the thermal duty (m = P / (cp dT)); pressure drop from
    Darcy-Weisbach over the loop length at the design flow velocity."""
    rho, cp, _, dt_loop = _COOLANTS[params.coolant]
    (p_thermal,) = as_tensors(p_thermal_mw, dtype=dtype, device=device)
    mdot = p_thermal * 1e6 / (cp * dt_loop)                      # kg/s
    p_pump_w = mdot * loop_pressure_drop(params) / (rho * params.pump_efficiency)
    return p_pump_w / 1e6


class CoolantLoop:
    """Thin stateful facade (reference ``CoolantLoop`` API shape)."""

    def __init__(self, coolant_type: str = "water", *, dtype=torch.float32, device="cuda"):
        self.params = PlantParams(coolant=coolant_type)
        self.dtype, self.device = dtype, device

    def calculate_pumping_power(self, p_thermal_mw: float) -> dict:
        p = float(pumping_power(p_thermal_mw, self.params, dtype=self.dtype, device=self.device))
        _, cp, _, dt_loop = _COOLANTS[self.params.coolant]
        return {"P_pump_MW": p,
                "mdot_kg_s": p_thermal_mw * 1e6 / (cp * dt_loop)}


def plant_performance(p_fusion_mw, p_aux_absorbed_mw, params: PlantParams = PlantParams(), *,
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda") -> PlantPerformance:
    """Fusion power -> net electricity (reference
    ``calculate_plant_performance`` :64-120 semantics), in ``dtype``
    (float32, as JAX casts its inputs; a tensor input sets the device)."""
    p_fus, p_aux = as_tensors(p_fusion_mw, p_aux_absorbed_mw, dtype=dtype, device=device)

    p_neutron = params.neutron_fraction * p_fus
    p_alpha = (1.0 - params.neutron_fraction) * p_fus
    p_thermal = (p_neutron * params.blanket_multiplication
                 + p_alpha + p_aux)
    p_gross = p_thermal * params.eta_thermal

    p_pump = pumping_power(p_thermal, params)
    p_plug = p_aux / params.eta_heating
    p_recirc = params.p_cryo_mw + params.p_misc_mw + p_pump + p_plug
    p_net = p_gross - p_recirc

    q_plasma = torch.where(p_aux > 0, p_fus / torch.clamp(p_aux, min=1e-9), 0.0)
    q_eng = torch.where(p_recirc > 0, p_gross / torch.clamp(p_recirc, min=1e-9), 0.0)
    return PlantPerformance(
        p_fusion_mw=p_fus, p_thermal_mw=p_thermal, p_gross_mw=p_gross,
        p_recirc_mw=p_recirc, p_net_mw=p_net, q_plasma=q_plasma,
        q_engineering=q_eng, p_pump_mw=p_pump, p_heating_plug_mw=p_plug)
