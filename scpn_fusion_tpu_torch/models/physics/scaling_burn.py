"""Confinement scaling, 0D burn physics and breeding-blanket neutronics
(port of ``scpn_fusion_tpu/models/physics/scaling_burn.py``).

* IPB98(y,2) energy-confinement scaling with the published ITER Physics
  Basis coefficients (NF 39 (1999) 2175) and the H-factor helper;
* the 0D burn point: power balance P_aux + P_alpha = W / tau_E(IPB98)
  relaxed as a damped fixed point over temperature, for one design point or
  a batch (JAX's ``fori_loop``: on the card one launch of row E,
  ``csrc/burn.cu``, on the CPU its plain loop of :func:`balance`);
* 1D cylindrical breeding-blanket neutronics: the diffusion-reaction
  equation with the reference's reduced-order closure, one Thomas solve
  (``ops/tridiag.py``: the CUDA kernel on the card), TBR from the
  cylindrical production integral.

``burn_equilibrium_0d`` and ``blanket_tbr`` take Python numbers; they run
in ``dtype`` (float64, JAX's default with x64 on) on ``device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.transport.closures import bosch_hale_sigmav
from scpn_fusion_tpu_torch.ops.tridiag import thomas_solve

# Published IPB98(y,2) coefficients — ITER Physics Basis, NF 39 (1999) 2175.
IPB98Y2_C = 0.0562
IPB98Y2_EXP = {
    "ip_ma": 0.93, "bt_t": 0.15, "ne19": 0.41, "ploss_mw": -0.69,
    "r_m": 1.97, "kappa": 0.78, "epsilon": 0.58, "m_amu": 0.19,
}
E_FUSION_J = 17.6e6 * 1.602176634e-19     # D-T fusion energy
E_ALPHA_J = 3.52e6 * 1.602176634e-19      # alpha-particle share
E_KEV_J = 1.602176634e-16


def ipb98y2_tau_e(ip_ma, bt_t, ne19, ploss_mw, r_m, kappa, epsilon, m_amu=2.5):
    """IPB98(y,2) thermal confinement time [s] (tensors or Python numbers)."""
    e = IPB98Y2_EXP
    return (IPB98Y2_C
            * ip_ma ** e["ip_ma"] * bt_t ** e["bt_t"] * ne19 ** e["ne19"]
            * ploss_mw ** e["ploss_mw"] * r_m ** e["r_m"]
            * kappa ** e["kappa"] * epsilon ** e["epsilon"]
            * m_amu ** e["m_amu"])


def h_factor(tau_actual, tau_predicted):
    """H98 = tau_actual / tau_IPB98 (reference ``compute_h_factor``)."""
    if isinstance(tau_predicted, torch.Tensor):
        return tau_actual / torch.clamp(tau_predicted, min=1e-30)
    return tau_actual / max(tau_predicted, 1e-30)


class BurnPoint(NamedTuple):
    q_fusion: torch.Tensor        # P_fus / P_aux
    p_fusion_mw: torch.Tensor
    p_alpha_mw: torch.Tensor
    tau_e_s: torch.Tensor
    t_kev: torch.Tensor           # converged volume-average temperature
    converged: torch.Tensor


# 1e38 (from n19^2) * E_FUSION_J folded into one f32-safe constant (~2.8e26,
# times sigmav ~1e-22)
FUS_CONST_MW = 1e38 * E_FUSION_J / 1e6
M_AMU_FACTOR = 2.5 ** IPB98Y2_EXP["m_amu"]   # the burn point's m_amu = 2.5 factor
RELAX = 0.3                                   # the damping of the temperature update


class BurnConstants(NamedTuple):
    """What hangs on a design point alone, formed once (tensors of the
    inputs' broadcast shape, in the plain code's order) for :func:`balance`
    and for row E (``ops/cuda_burn.py``)."""
    p_aux_mw: torch.Tensor
    nd2: torch.Tensor             # (0.5 dilution ne19)^2
    volume: torch.Tensor
    tau_pre: torch.Tensor         # C ip^0.93 bt^0.15 ne19^0.41
    r_f: torch.Tensor             # r^1.97
    k_f: torch.Tensor             # kappa^0.78
    e_f: torch.Tensor             # epsilon^0.58
    w_coeff: torch.Tensor         # W/T in 1e19-scaled units: 3 n_e T V e -> MW s / keV
    f_profile: float              # peaking factor of the <sigma v> average
    f_divisor: torch.Tensor       # 0-d f_profile, the divisor of <sigma v>
    five: torch.Tensor            # 0-d 5, P_alpha = P_fus / 5


def burn_constants(ne19, p_aux_mw, ip_ma, bt_t, r_m, a_m, kappa, dilution: float,
                   f_profile: float) -> BurnConstants:
    """:class:`BurnConstants` of tensors of one dtype on one device.  The
    divisors are 0-d tensors: on a CUDA tensor PyTorch multiplies by the
    reciprocal of a Python divisor, and row E divides."""
    e = IPB98Y2_EXP
    volume = 2.0 * math.pi**2 * r_m * a_m**2 * kappa
    epsilon = a_m / r_m
    # Density arithmetic in 1e19 units (n^2 in SI is above the f32 range).
    n_d19 = 0.5 * (dilution * ne19)
    tau_pre = IPB98Y2_C * ip_ma ** e["ip_ma"] * bt_t ** e["bt_t"] * ne19 ** e["ne19"]
    shape = torch.broadcast_shapes(*(x.shape for x in (ne19, p_aux_mw, ip_ma, bt_t, r_m, a_m,
                                                       kappa)))
    return BurnConstants(
        *(x.expand(shape) for x in (p_aux_mw, n_d19 * n_d19, volume, tau_pre, r_m ** e["r_m"],
                                    kappa ** e["kappa"], epsilon ** e["epsilon"],
                                    3.0 * ne19 * (1e19 * E_KEV_J / 1e6) * volume)),
        float(f_profile),
        *(torch.tensor(v, dtype=ne19.dtype, device=ne19.device) for v in (f_profile, 5.0)))


def balance(k: BurnConstants, t_kev):
    """(P_fus, P_alpha, tau_E, the energy-balance temperature) at ``t_kev``:
    the body of JAX's ``fori_loop`` (``scaling_burn.py:96-104``), whose last
    entry the relaxation moves toward."""
    t = torch.clamp(t_kev, 0.5, 100.0)
    sigmav = bosch_hale_sigmav(k.f_profile * t) / k.f_divisor
    p_fus_mw = (k.nd2 * (sigmav * FUS_CONST_MW)) * k.volume
    p_alpha_mw = p_fus_mw / k.five
    p_heat = k.p_aux_mw + p_alpha_mw
    # ipb98y2_tau_e's product, left to right, with the point's factors formed once
    tau = (k.tau_pre * torch.clamp(p_heat, min=1.0) ** IPB98Y2_EXP["ploss_mw"] * k.r_f * k.k_f
           * k.e_f * M_AMU_FACTOR)
    return p_fus_mw, p_alpha_mw, tau, p_heat * tau / k.w_coeff


def burn_equilibrium_0d(*, ne19, p_aux_mw, ip_ma, bt_t, r_m, a_m, kappa, t_init_kev=8.0,
                        dilution=0.8, f_profile=2.0, n_iter: int = 200,
                        dtype: torch.dtype = torch.float64,
                        device: torch.device | str = "cuda") -> BurnPoint:
    """0D steady-state burn point: relax T until the power balance closes.

    W = 3 n T V;  P_loss = W / tau_E(IPB98);  P_aux + P_alpha = P_loss.
    ``dilution`` is the fuel-ion fraction n_DT / n_e, ``f_profile`` the
    peaking factor of the <sigma v> average.  The inputs broadcast together
    (a batch of design points); on the card the relaxation of every point is
    one launch of row E (``ops/cuda_burn.burn_relax``), on the CPU its plain
    loop."""
    from scpn_fusion_tpu_torch.ops.cuda_burn import burn_relax

    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    k = burn_constants(*(as_t(x) for x in (ne19, p_aux_mw, ip_ma, bt_t, r_m, a_m, kappa)),
                       dilution, f_profile)
    t_final = burn_relax(k, t_init_kev, n_iter)
    t = torch.clamp(t_final, 0.5, 100.0)
    p_fus_mw, p_alpha_mw, tau, t_balance = balance(k, t_final)
    return BurnPoint(
        q_fusion=p_fus_mw / torch.clamp(k.p_aux_mw, min=1e-6),
        p_fusion_mw=p_fus_mw,
        p_alpha_mw=p_alpha_mw,
        tau_e_s=tau,
        t_kev=t,
        converged=(t_balance - t_final).abs() < 0.05 * t_final.abs(),
    )


class BlanketResult(NamedTuple):
    r_cm: torch.Tensor
    flux: torch.Tensor
    tbr: torch.Tensor
    production_rate: torch.Tensor


def blanket_tbr(*, thickness_cm=100.0, li6_enrichment=0.9, r_inner_cm=200.0,
                incident_flux=1e14, rear_albedo=0.0, n_points: int = 100,
                dtype: torch.dtype = torch.float64,
                device: torch.device | str = "cuda") -> BlanketResult:
    """1D cylindrical neutron diffusion + TBR (reference semantics).

    -D (1/r) d/dr(r dPhi/dr) + Sigma_rem Phi = 0, Dirichlet first wall,
    albedo back wall; Sigma from the reference's reduced-order 14 MeV
    closure (Li-6 capture 0.15 * enrichment, scatter 0.2, parasitic 0.02,
    Be (n,2n) 0.08 with gain 1.8)."""
    sig_li6 = 0.15 * li6_enrichment
    sig_scatter = 0.2
    sig_parasitic = 0.02
    sig_multiply = 0.08
    gain = 1.8

    sigma_total = sig_li6 + sig_scatter + sig_parasitic + sig_multiply
    d_coeff = 1.0 / (3.0 * sigma_total)
    sigma_removal = sig_li6 + sig_parasitic - sig_multiply * (gain - 1.0)

    r = linspace(r_inner_cm, r_inner_cm + thickness_cm, n_points, dtype, device)
    dr = r[1] - r[0]

    r_int = r[1:-1]
    c_plus = d_coeff * (r_int + 0.5 * dr) / (r_int * dr**2)
    c_minus = d_coeff * (r_int - 0.5 * dr) / (r_int * dr**2)

    # Tridiagonal rows 0..n-1 (Dirichlet front, albedo back).
    zero = torch.zeros(1, dtype=dtype, device=device)
    a = torch.cat([-c_minus, torch.full((1,), -rear_albedo, dtype=dtype, device=device)])
    b = torch.cat([zero + 1.0, c_plus + c_minus + sigma_removal, zero + 1.0])
    c = torch.cat([zero, -c_plus])
    rhs = torch.zeros(n_points, dtype=dtype, device=device)
    rhs[0] = incident_flux

    phi = torch.clamp(thomas_solve(a, b, c, rhs), min=0.0)

    production = sig_li6 * phi
    integrand = production * 2.0 * math.pi * r
    total_production = torch.sum(0.5 * (integrand[1:] + integrand[:-1]) * dr)
    incident_current = (phi[0] / 4.0) * (2.0 * math.pi * r_inner_cm)
    tbr = total_production / torch.clamp(incident_current, min=1e-12)
    return BlanketResult(r, phi, tbr, production)
