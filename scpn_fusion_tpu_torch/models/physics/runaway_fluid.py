"""DREAM-style fluid runaway-electron rates + balance (port of
``scpn_fusion_tpu/models/physics/runaway_fluid.py``).

Reduced-order runaway density contract ``dn_RE/dt = S_Dreicer +
Gamma_ava n_RE - n_RE/tau_loss`` with the corrected Connor-Hastie Dreicer
generation rate (Connor & Hastie, NF 15, 415 (1975), in DREAM's corrected
form: Hoppe et al., CPC 268, 108098 (2021)) and the compact
Rosenbluth-Putvinski avalanche rate (NF 37, 1355 (1997), as quoted by
Hesslow et al., NF 59, 084004 (2019)), both with state-dependent Coulomb
logarithms.  Every rate takes batched inputs; guards are masks.  The fluid
run is an exact exponential integrator with constant coefficients, a loop
of one ``minimum`` a step on plain ops.

The functions take numbers or tensors: a tensor among the inputs sets the
device (and dtype), else ``dtype`` (float32; JAX takes its float from the
x64 flag) and ``device`` (``"cuda"``) do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

E_CHARGE = 1.602176634e-19      # C
M_E = 9.1093837015e-31          # kg
C_LIGHT = 2.99792458e8          # m/s
EPS_0 = 8.8541878128e-12        # F/m
# Classical electron radius r0 = e^2/(4 pi eps0 m_e c^2) [m]
R0_CLASSICAL = 2.8179403262e-15
# E_c = ne20 * lnL * _EC_PER_NE20_LNL  [V/m]; constant pre-folded in f64
# (e^3/(4 pi eps0^2 m_e c^2) * 1e20) so float32 never forms the
# underflowing e^3 product.
_EC_PER_NE20_LNL = 5.0990991e-3
# E_D = ne20 * lnL * _ED_PER_NE20_LNL / Te_keV  [V/m]
_MEC2_KEV = 510.99895
_ED_PER_NE20_LNL = _EC_PER_NE20_LNL * _MEC2_KEV


def coulomb_log_thermal(ne20, te_kev, *, dtype=None, device="cuda"):
    """Thermal e-e Coulomb log: 14.9 - 0.5 ln(ne20) + ln(Te_keV)."""
    ne20, te_kev = as_tensors(ne20, te_kev, dtype=dtype, device=device)
    return (14.9 - 0.5 * torch.log(torch.clamp(ne20, min=1e-12))
            + torch.log(torch.clamp(te_kev, min=1e-12)))


def coulomb_log_relativistic(ne20, te_kev, *, dtype=None, device="cuda"):
    """Relativistic Coulomb log: 14.6 + 0.5 ln(Te_eV / ne20)."""
    ne20, te_kev = as_tensors(ne20, te_kev, dtype=dtype, device=device)
    te_ev = torch.clamp(te_kev, min=1e-12) * 1e3
    return 14.6 + 0.5 * torch.log(te_ev / torch.clamp(ne20, min=1e-12))


def critical_field(ne20, ln_lambda, *, dtype=None, device="cuda"):
    """E_c = n_e e^3 lnL / (4 pi eps0^2 m_e c^2)  [V/m]."""
    ne20, ln_lambda = as_tensors(ne20, ln_lambda, dtype=dtype, device=device)
    return torch.clamp(ne20, min=0.0) * ln_lambda * _EC_PER_NE20_LNL


def dreicer_field(ne20, te_kev, ln_lambda, *, dtype=None, device="cuda"):
    """E_D = n_e e^3 lnL / (4 pi eps0^2 T_e)  [V/m]."""
    ne20, te_kev, ln_lambda = as_tensors(ne20, te_kev, ln_lambda, dtype=dtype, device=device)
    return (torch.clamp(ne20, min=0.0) * ln_lambda * _ED_PER_NE20_LNL
            / torch.clamp(te_kev, min=1e-12))


def dreicer_rate(ne20, te_kev, e_par, z_eff, *, dtype=None, device="cuda"):
    """Corrected Connor-Hastie primary generation rate [m^-3 s^-1].

    gamma_D = (n_e/tau_EE) (E/E_D)^alpha exp(-lambda/(4 E_ED)
              - sqrt(eta (1+Z)/E_ED)),  alpha = -3(1+Z)h/16,
    with h/eta/lambda relativistic correction factors of E/E_c and
    tau_EE = beta_th^3 / (4 pi r0^2 c n_e lnL_T).  Zero below the
    relativistic critical field (masked, not branched).
    """
    ne20, te_kev, e_par, z = as_tensors(ne20, te_kev, e_par, z_eff, dtype=dtype, device=device)
    lnl_t = coulomb_log_thermal(ne20, te_kev)
    lnl_c = coulomb_log_relativistic(ne20, te_kev)
    e_c = critical_field(ne20, lnl_c)
    e_d = dreicer_field(ne20, te_kev, lnl_t)

    valid = (e_par > e_c) & (te_kev > 0.0) & (ne20 > 0.0)
    # Clamp into the formula's domain (E/E_c > 1) on the masked-out side so
    # sqrt/arcsin stay finite; the result there is discarded by `valid`.
    e_ec = torch.clamp(e_par / torch.clamp(e_c, min=1e-30), min=1.0 + 1e-6)
    e_ed = torch.clamp(e_par / torch.clamp(e_d, min=1e-30), min=1e-8)

    h = (e_ec + 2.0 * (e_ec - 2.0) * torch.sqrt(e_ec / (e_ec - 1.0))
         - (z - 7.0) / (z + 1.0)) / (3.0 * (e_ec - 1.0))
    eta_f = 0.5 * math.pi - torch.asin(torch.clamp(1.0 - 2.0 / e_ec, -1.0, 1.0))
    eta = e_ec**2 / (4.0 * (e_ec - 1.0)) * eta_f**2
    lam = 8.0 * e_ec**2 * (1.0 - 0.5 / e_ec
                           - torch.sqrt(torch.clamp(1.0 - 1.0 / e_ec, min=0.0)))
    alpha = -3.0 / 16.0 * (1.0 + z) * h

    n_e = torch.clamp(ne20, min=1e-12) * 1e20
    beta_th = torch.sqrt(2.0 * torch.clamp(te_kev, min=1e-12) / _MEC2_KEV)
    tau_ee = beta_th**3 / (4.0 * math.pi * R0_CLASSICAL**2 * C_LIGHT * n_e * lnl_t)

    exponent = -lam / (4.0 * e_ed) - torch.sqrt(eta * (1.0 + z) / e_ed)
    rate = n_e / tau_ee * e_ed**alpha * torch.exp(torch.clamp(exponent, min=-200.0))
    rate = torch.where(torch.isfinite(rate), rate, torch.zeros_like(rate))
    return torch.where(valid & (exponent > -200.0), torch.clamp(rate, min=0.0),
                       torch.zeros_like(rate))


def avalanche_rate(ne20, te_kev, e_par, z_eff, *, dtype=None, device="cuda"):
    """Rosenbluth-Putvinski exponential avalanche rate Gamma_ava [1/s].

    Gamma = e (E - E_c) / (m_e c lnL_c sqrt(5 + Z_eff)); zero below E_c.
    """
    ne20, te_kev, e_par, z = as_tensors(ne20, te_kev, e_par, z_eff, dtype=dtype, device=device)
    lnl_c = coulomb_log_relativistic(ne20, te_kev)
    e_c = critical_field(ne20, lnl_c)
    gamma = (E_CHARGE * (e_par - e_c)
             / (M_E * C_LIGHT * lnl_c * torch.sqrt(5.0 + z)))
    return torch.clamp(gamma, min=0.0)


def hot_tail_seed(te_pre_kev, te_post_kev, ne20, quench_time_ms, *,
                  vc_vte_ref: float = 4.0, quench_exponent: float = 0.2,
                  dtype=None, device="cuda"):
    """Thermal-quench hot-tail seed density [m^-3] (Smith et al., Phys.
    Plasmas 15, 072502 (2008); parametric v_c/v_te fit to Fig. 3)."""
    te_pre_kev, te_post_kev, ne20, quench_time_ms = as_tensors(
        te_pre_kev, te_post_kev, ne20, quench_time_ms, dtype=dtype, device=device)
    v_c_v_te = vc_vte_ref * torch.clamp(quench_time_ms, min=1e-6) ** quench_exponent
    ratio = torch.clamp(te_pre_kev, min=1e-12) / torch.clamp(te_post_kev, min=1e-12)
    n_e = torch.clamp(ne20, min=0.0) * 1e20
    seed = (n_e * v_c_v_te**3
            * torch.exp(torch.clamp(-v_c_v_te**2, min=-200.0)) * ratio**1.5)
    return torch.where(te_post_kev < te_pre_kev, torch.clamp(seed, min=0.0),
                       torch.zeros_like(seed))


class FluidBalance(NamedTuple):
    dreicer_source: torch.Tensor     # [m^-3 s^-1]
    avalanche_source: torch.Tensor   # [m^-3 s^-1]
    loss_source: torch.Tensor        # [m^-3 s^-1] (positive = loss)
    total_source: torch.Tensor       # [m^-3 s^-1]
    runaway_fraction: torch.Tensor
    growth_time_s: torch.Tensor      # 1/Gamma_net (inf when non-growing)


def fluid_density_balance(ne20, te_kev, e_par, z_eff, n_re, *, loss_time_s=math.inf,
                          dtype=None, device="cuda") -> FluidBalance:
    """Evaluate the scalar DREAM-style density balance at one state."""
    ne20, te_kev, e_par, z_eff, n_re, loss = as_tensors(
        ne20, te_kev, e_par, z_eff, n_re, loss_time_s, dtype=dtype, device=device)
    s_d = dreicer_rate(ne20, te_kev, e_par, z_eff)
    gamma = avalanche_rate(ne20, te_kev, e_par, z_eff)
    s_a = gamma * n_re
    s_l = n_re / loss
    total = s_d + s_a - s_l
    net = gamma - 1.0 / loss
    growth = torch.where(net > 0.0, 1.0 / torch.clamp(net, min=1e-30),
                         torch.full_like(net, math.inf))
    frac = n_re / torch.clamp(ne20 * 1e20, min=1e-30)
    return FluidBalance(s_d, s_a, s_l, total, frac, growth)


class FluidRunawayTrace(NamedTuple):
    time_s: torch.Tensor
    n_re: torch.Tensor               # [m^-3]
    dreicer_source: torch.Tensor
    avalanche_source: torch.Tensor


def run_fluid_runaway(ne20, te_kev, e_par, z_eff, *, n_re_seed: float, t_max_s: float,
                      n_steps: int, loss_time_s: float = math.inf,
                      max_runaway_fraction: float = 1.0, dtype=None,
                      device="cuda") -> FluidRunawayTrace:
    """Integrate the fluid balance under prescribed (constant) E/n/T.

    The balance is linear with constant coefficients, so each step uses the
    exact exponential integrator
        n(t+dt) = n e^{g dt} + S_D (e^{g dt} - 1)/g,   g = Gamma - 1/tau,
    (series-expanded near g=0), making the trajectory dt-exact.  The density
    cap is enforced as a clamp (fail-closed callers gate on ``n_re``
    reaching the cap).
    """
    ne20, te_kev, e_par, z_eff = as_tensors(ne20, te_kev, e_par, z_eff, dtype=dtype,
                                            device=device)
    dt = t_max_s / n_steps
    s_d = dreicer_rate(ne20, te_kev, e_par, z_eff)
    gamma = avalanche_rate(ne20, te_kev, e_par, z_eff)
    g = gamma - 1.0 / loss_time_s
    cap = max_runaway_fraction * ne20 * 1e20

    small = torch.abs(g * dt) < 1e-8
    e_gdt = torch.exp(torch.clamp(g * dt, -200.0, 200.0))
    # (e^{g dt} - 1)/g, stable at g -> 0
    phi = torch.where(small, dt * (1.0 + 0.5 * g * dt),
                      (e_gdt - 1.0) / torch.where(small, torch.ones_like(g), g))

    n = torch.full_like(s_d, n_re_seed)
    n0, n_traj = n, []
    for _ in range(n_steps):
        n = torch.minimum(n * e_gdt + s_d * phi, cap)
        n_traj.append(n)
    n_traj = torch.stack(n_traj) if n_traj else n0.new_zeros((0, *n0.shape))
    t = torch.arange(1, n_steps + 1, dtype=s_d.dtype, device=s_d.device) * dt
    return FluidRunawayTrace(
        time_s=torch.cat([t.new_zeros(1), t]),
        n_re=torch.cat([n0[None], n_traj]),
        dreicer_source=torch.cat([s_d[None], s_d.expand_as(n_traj)]),
        avalanche_source=torch.cat([(gamma * n0)[None], gamma * n_traj]),
    )
