"""Divertor heat-exhaust laboratory: tungsten vs liquid-lithium vapor shield
(port of ``scpn_fusion_tpu/models/physics/divertor_lab.py``).

Eich-scaling parallel heat flux, two-point SOL transport, 1D tungsten
monoblock conduction limit, self-consistent lithium vapor shielding,
Hartmann-corrected TEMHD pressure loss, and the combined liquid-metal
stability index.

The JAX package iterates the vapor-shield fixed point as a
``lax.while_loop``; the port runs the same under-relaxed Picard map as a
Python loop with one host read an iteration (the residual test), and
returns JAX's iteration count.  A flow-velocity scan is one batch
dimension (JAX: ``vmap``).  Plain PyTorch ops: functions given Python
numbers take ``dtype`` (float32 by default; JAX's lithium shield takes its
float from the x64 flag) and ``device`` (``"cuda"`` by default); given
tensors they follow them.  Quotients by configuration numbers divide by
tensors, so ``q_target == q_parallel / expansion`` holds on every device as
it does in Python double.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

W_MELT_C = 3422.0          # tungsten melting point [C]
LI_BOIL_C = 1342.0         # lithium boiling point  [C]


class DivertorLoad(NamedTuple):
    lambda_q_m: torch.Tensor      # Eich SOL width
    q_parallel: torch.Tensor      # upstream parallel flux [W/m^2]
    q_target: torch.Tensor        # wetted-target flux [W/m^2]
    t_upstream_ev: torch.Tensor
    t_target_ev: torch.Tensor


def divertor_heat_load(p_sol_mw, r_major, b_pol, *, expansion_factor=10.0, f_rad=0.0,
                       q95: float = 3.0, kappa0: float = 2000.0, dtype=None,
                       device="cuda") -> DivertorLoad:
    """Eich-width parallel flux + conduction-limited two-point model:

    lambda_q [mm] = 0.63 B_pol^-1.19,  q_par = P_SOL / (2 pi R lambda_q),
    T = (3.5 q L_c / kappa0)^(2/7) upstream and at the (mitigated) target.
    """
    p_sol_mw, r_major, b_pol, expansion_factor, f_rad, q95, kappa0, pi = as_tensors(
        p_sol_mw, r_major, b_pol, expansion_factor, f_rad, q95, kappa0, torch.pi, dtype=dtype,
        device=device)
    lambda_q = 0.63e-3 * b_pol ** (-1.19)
    l_c = pi * r_major * q95
    q_par = (p_sol_mw * 1e6) / (2.0 * pi * r_major * lambda_q)
    t_u = torch.div(3.5 * q_par * l_c, kappa0) ** (2.0 / 7.0)
    q_t = torch.div(q_par * (1.0 - f_rad), expansion_factor)
    t_t = torch.div(3.5 * q_t * l_c, kappa0) ** (2.0 / 7.0)
    t_t = torch.minimum(torch.clamp(t_t, min=1.0), t_u)
    return DivertorLoad(lambda_q, q_par, q_t, t_u, t_t)


class TungstenResult(NamedTuple):
    t_surface_c: torch.Tensor
    melted: torch.Tensor


def tungsten_monoblock(q_target, *, k_w: float = 100.0, d_block_m: float = 0.01,
                       t_coolant_c: float = 100.0, dtype=None,
                       device="cuda") -> TungstenResult:
    """1D tungsten conduction limit: T_surf = T_coolant + q d / k."""
    q_target, k_w = as_tensors(q_target, k_w, dtype=dtype, device=device)
    t_surf = t_coolant_c + torch.div(q_target * d_block_m, k_w)
    return TungstenResult(t_surf, t_surf > W_MELT_C)


class LithiumShieldResult(NamedTuple):
    t_surface_c: torch.Tensor
    q_surface: torch.Tensor       # shielded flux reaching the substrate
    f_rad: torch.Tensor           # vapor-shield radiated fraction
    iterations: torch.Tensor


def lithium_vapor_shield(q_target, *, relaxation=0.7, tol=0.1, max_iter: int = 200,
                         a_li: float = 10.0, b_li: float = 8000.0, k_eff: float = 150.0,
                         d_m: float = 0.005, t_back_c: float = 300.0, dtype=None,
                         device="cuda") -> LithiumShieldResult:
    """Self-consistent vapor shielding: Alcock Li vapor pressure
    log10(P) = A - B/T_K drives a radiated fraction
    f_rad = 0.98 (1 - exp(-P/10)); the surface temperature solves the
    shielded conduction balance by under-relaxed Picard (step clipped to
    +-1200 C), one host read an iteration.  ``dtype``: the working float
    (the tensor's own for a tensor, else float32)."""
    q_target, a_li, b_li, k_eff, t_k0, ten = as_tensors(
        q_target, a_li, b_li, k_eff, 273.15, 10.0, dtype=dtype, device=device)

    def shield(t_surf):
        p_sat = torch.pow(ten, a_li - torch.div(b_li, t_surf + t_k0))
        f_rad = 0.98 * (1.0 - torch.exp(-torch.div(p_sat, ten)))
        q_surf = q_target * (1.0 - f_rad)
        t_new = t_back_c + torch.div(q_surf * d_m, k_eff)
        return t_new, q_surf, f_rad

    t = torch.full_like(q_target, 500.0)
    step = torch.full_like(q_target, 1.0 - relaxation)
    k = 0
    res = float("inf")
    while res > tol and k < max_iter:
        t_new, _, _ = shield(t)
        delta = torch.clamp(t_new - t, -1200.0, 1200.0)
        res_t = torch.abs(t_new - t)
        t = t + step * delta
        res = float(res_t)
        k += 1
    _, q_surf, f_rad = shield(t)
    return LithiumShieldResult(t, q_surf, f_rad,
                               torch.tensor(k, dtype=torch.int32, device=q_target.device))


def mhd_pressure_loss(flow_velocity_m_s, b_pol, *, channel_length_m: float = 1.2,
                      channel_half_gap_m: float = 0.012, density_kg_m3: float = 510.0,
                      viscosity_pa_s: float = 2.5e-3, conductivity_s_m: float = 8.0e5,
                      dtype=None, device="cuda"):
    """Hartmann-flow-corrected channel pressure loss.  Returns
    (pressure_loss_pa, hartmann_number)."""
    flow_velocity_m_s, b_pol = as_tensors(flow_velocity_m_s, b_pol, dtype=dtype, device=device)
    v = torch.clamp(flow_velocity_m_s, min=1e-6)
    nu = viscosity_pa_s / density_kg_m3
    ha = b_pol * channel_half_gap_m * math.sqrt(
        conductivity_s_m / max(density_kg_m3 * nu, 1e-12))
    dp_visc = 12.0 * viscosity_pa_s * channel_length_m * v / channel_half_gap_m**2
    return dp_visc * (1.0 + ha / 6.0), ha


def evaporation_rate(surface_temp_c, flow_velocity_m_s, *, dtype=None, device="cuda"):
    """Velocity-relieved Li evaporation [kg m^-2 s^-1]."""
    surface_temp_c, flow_velocity_m_s = as_tensors(surface_temp_c, flow_velocity_m_s,
                                                   dtype=dtype, device=device)
    v = torch.clamp(flow_velocity_m_s, min=1e-6)
    thermal = torch.exp(torch.clamp((surface_temp_c - 500.0) / 260.0, -8.0, 8.0))
    relief = 1.0 / (1.0 + 0.45 * torch.sqrt(v))
    return 2.0e-6 * thermal * relief


class LiquidMetalState(NamedTuple):
    t_surface_c: torch.Tensor
    q_surface: torch.Tensor
    shielding_fraction: torch.Tensor
    pressure_loss_pa: torch.Tensor
    hartmann: torch.Tensor
    evaporation_kg_m2_s: torch.Tensor
    stability_index: torch.Tensor
    is_stable: torch.Tensor


def temhd_liquid_metal_state(flow_velocity_m_s, p_sol_mw, r_major, b_pol, *,
                             expansion_factor=15.0, dtype=None,
                             device="cuda") -> LiquidMetalState:
    """Combined reduced TEMHD divertor operating state + stability index
    (flux/45 MW + dP/0.8 MPa + evap/1e-3 <= 1).  A (n,) flow velocity is one
    batch: the load and the shield, which do not depend on it, are solved
    once and broadcast."""
    flow_velocity_m_s, p_sol_mw, r_major, b_pol = as_tensors(
        flow_velocity_m_s, p_sol_mw, r_major, b_pol, dtype=dtype, device=device)
    load = divertor_heat_load(p_sol_mw, r_major, b_pol, expansion_factor=expansion_factor)
    li = lithium_vapor_shield(load.q_target)
    dp, ha = mhd_pressure_loss(flow_velocity_m_s, b_pol)
    evap = evaporation_rate(li.t_surface_c, flow_velocity_m_s)
    idx = li.q_surface / 45.0e6 + dp / 8.0e5 + evap / 1.0e-3
    shape = idx.shape
    return LiquidMetalState(li.t_surface_c.expand(shape), li.q_surface.expand(shape),
                            li.f_rad.expand(shape), dp, ha.expand(shape), evap, idx, idx <= 1.0)


def flow_velocity_scan(velocities, p_sol_mw, r_major, b_pol, *, expansion_factor=15.0,
                       dtype=None, device="cuda") -> LiquidMetalState:
    """Vectorised operating-window scan over channel flow speeds."""
    velocities, = as_tensors(velocities, dtype=dtype, device=device)
    return temhd_liquid_metal_state(velocities.reshape(-1), p_sol_mw, r_major, b_pol,
                                    expansion_factor=expansion_factor)
