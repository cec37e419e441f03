"""Integrated shot scenario: waveforms -> confinement -> burn -> flux budget
(port of ``scpn_fusion_tpu/models/physics/integrated_scenario.py``).

One loop over control ticks composes the pieces (JAX's ``lax.scan`` is a
Python loop here that carries only the recurrence: what a tick computes
without the stored energy or the L-H mode is computed for all ticks at
once, with the same operations in the same order):

* the breakpoint :class:`~scpn_fusion_tpu_torch.control.scenario.ScenarioSchedule`
  provides Ip/density/heating waveforms (evaluated for all ticks at once),
* the Martin-2008 L-H state machine switches the H98 factor,
* the plasma energy integrates dW/dt = P_aux + P_alpha - P_rad - W/tau_E
  with IPB98(y,2) tau_E (a DYNAMIC burn, not the instant 0D fixed point),
* Ejima flux consumption runs alongside and flags budget exhaustion,
* Greenwald/beta operational limits are monitored per tick.

The shot runs in float64 on ``device`` (the card by default), as JAX runs
it with x64 on; it is differentiable in the schedule's tensor values
(``control/optimal_scenario.py`` takes ``torch.autograd`` through it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.scenario import FluxBudget, ScenarioSchedule
from scpn_fusion_tpu_torch.models.physics.scaling_burn import IPB98Y2_C, IPB98Y2_EXP
from scpn_fusion_tpu_torch.models.transport.closures import bosch_hale_sigmav
from scpn_fusion_tpu_torch.models.transport.momentum_lh import (
    martin_lh_threshold_mw,
    plasma_surface_area,
)

E_KEV_J = 1.602176634e-16
E_FUSION_J = 17.6e6 * 1.602176634e-19


@dataclasses.dataclass(frozen=True)
class ScenarioMachine:
    r_m: float = 6.2
    a_m: float = 2.0
    kappa: float = 1.8
    b0_t: float = 5.3
    dilution: float = 0.8
    f_profile: float = 2.0
    rad_fraction: float = 0.3     # radiated fraction of heating power
    loop_voltage_v: float = 0.08  # flattop loop voltage
    bootstrap_fraction: float = 0.3
    t_init_kev: float = 0.5


class ShotTrace(NamedTuple):
    t_s: torch.Tensor
    ip_ma: torch.Tensor
    ne19: torch.Tensor
    p_aux_mw: torch.Tensor
    t_kev: torch.Tensor
    w_mj: torch.Tensor
    p_fusion_mw: torch.Tensor
    q_fusion: torch.Tensor
    h_mode: torch.Tensor
    tau_e_s: torch.Tensor
    flux_remaining_vs: torch.Tensor
    greenwald_fraction: torch.Tensor


class ShotReport(NamedTuple):
    q_flattop: torch.Tensor         # mean Q during the flattop window
    p_fusion_peak_mw: torch.Tensor
    h_mode_duration_s: torch.Tensor
    flux_exhausted: torch.Tensor
    greenwald_violated: torch.Tensor
    reached_burn: torch.Tensor      # Q >= 5 sustained at flattop


def run_shot(schedule: ScenarioSchedule, budget: FluxBudget,
             m: ScenarioMachine = ScenarioMachine(), *,
             dt_s: float = 0.5,
             device: torch.device | str = "cuda") -> tuple[ShotTrace, ShotReport]:
    """Integrate the whole shot (reference ``integrated_scenario`` role)."""
    n_steps = int(schedule.duration / dt_s)
    times = torch.arange(n_steps, dtype=torch.float64, device=device) * dt_s
    wf = schedule.evaluate(times)     # tensors over the full shot
    ip_tr = torch.clamp(wf["ip_ma"], min=0.1)
    ne_tr = torch.clamp(wf["ne19"], min=0.1)
    paux_tr = wf["p_aux_mw"]

    volume = 2.0 * math.pi ** 2 * m.r_m * m.a_m ** 2 * m.kappa
    eps = m.a_m / m.r_m
    f64 = times.dtype
    dev = times.device

    # Every quantity of a tick that the carried state (stored energy, L-H
    # mode) does not enter, for all ticks at once, with JAX's operations in
    # JAX's order; the loop keeps only the recurrence.
    # temperature from stored energy: W = 3 n T V
    w_coeff = torch.clamp(3.0 * ne_tr * (1e19 * E_KEV_J / 1e6) * volume, min=1e-9)  # MJ/keV
    n_d19 = 0.5 * (m.dilution * ne_tr)
    n_d19_sq = n_d19 * n_d19
    # L-H margin compares the power crossing the separatrix (the Martin
    # scaling's definition uses total loss power, not the radiation-corrected
    # core heating); the threshold depends on the density alone.
    p_lh = martin_lh_threshold_mw(ne_tr / 10.0, m.b0_t,
                                  plasma_surface_area(m.r_m, m.a_m, m.kappa))
    p_back = 0.8 * p_lh
    e = IPB98Y2_EXP
    tau_head = IPB98Y2_C * ip_tr ** e["ip_ma"] * m.b0_t ** e["bt_t"] * ne_tr ** e["ne19"]
    tails = (m.r_m ** e["r_m"], m.kappa ** e["kappa"], eps ** e["epsilon"], 2.5 ** e["m_amu"])
    h98_h, h98_l = (torch.full((), v, dtype=f64, device=dev)
                    for v in (1.0, 0.6))         # confinement_multiplier's defaults
    fus_const_mw = 1e38 * E_FUSION_J / 1e6

    w_mj = 3.0 * ne_tr[0] * (1e19 * E_KEV_J / 1e6) * volume * m.t_init_kev
    h_mode = torch.zeros((), dtype=torch.bool, device=dev)
    flux_used, used = 0.0, []
    cols: tuple[list, ...] = ([], [], [], [], [])
    for k in range(n_steps):
        p_aux = paux_tr[k]
        t_kev = torch.clamp(w_mj / w_coeff[k], 0.05, 100.0)

        t = torch.clamp(t_kev, 0.3, 100.0)
        sigmav = bosch_hale_sigmav(m.f_profile * t) / m.f_profile
        p_fus = n_d19_sq[k] * (sigmav * fus_const_mw) * volume
        p_alpha = p_fus / 5.0
        p_heat = p_aux + p_alpha
        p_net = (1.0 - m.rad_fraction) * p_heat

        h_mode = torch.where(h_mode, p_heat > p_back[k], p_heat > p_lh[k])
        h98 = torch.where(h_mode, h98_h, h98_l)
        tau = tau_head[k] * torch.clamp(p_net, min=0.5) ** e["ploss_mw"]
        for tail in tails:
            tau = tau * tail
        tau = h98 * tau
        dw = p_net - w_mj / torch.clamp(tau, min=1e-3)
        w_mj = torch.clamp(w_mj + dt_s * dw, min=0.01)

        # Flux consumption: resistive V-s during the whole shot
        flux_used = flux_used + m.loop_voltage_v * (1.0 - m.bootstrap_fraction) * dt_s
        used.append(flux_used)
        for col, v in zip(cols, (t_kev, w_mj, p_fus, h_mode, tau)):
            col.append(v)
    t_kev, w_tr, p_fus, h_tr, tau_tr = (torch.stack(col) for col in cols)
    remaining = (budget.phi_cs_vs - budget.inductive_flux(ip_tr)
                 - torch.tensor(used, dtype=f64, device=dev))
    n_gw = 10.0 * ip_tr / (math.pi * m.a_m ** 2)
    trace = ShotTrace(times, ip_tr, ne_tr, paux_tr, t_kev, w_tr, p_fus,
                      p_fus / torch.clamp(paux_tr, min=0.5), h_tr, tau_tr, remaining,
                      ne_tr / torch.clamp(n_gw, min=1e-6))

    # flattop window = where Ip is within 2% of its maximum
    at_flat = trace.ip_ma > 0.98 * trace.ip_ma.max()
    n_flat = torch.clamp(at_flat.sum(), min=1)
    q_flat = torch.where(at_flat, trace.q_fusion, torch.zeros_like(trace.q_fusion)).sum() / n_flat
    report = ShotReport(
        q_flattop=q_flat,
        p_fusion_peak_mw=trace.p_fusion_mw.max(),
        h_mode_duration_s=trace.h_mode.sum().to(f64) * dt_s,
        flux_exhausted=(trace.flux_remaining_vs < 0.0).any(),
        # The density limit is an operational constraint of the current
        # plateau; below ~1 MA (termination tail) it is not meaningful.
        greenwald_violated=((trace.greenwald_fraction > 1.0) & (trace.ip_ma > 1.0)).any(),
        reached_burn=q_flat >= 5.0)
    return trace, report
