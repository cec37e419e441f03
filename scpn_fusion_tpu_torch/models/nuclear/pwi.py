"""Plasma-wall interaction: Bohdansky-Yamamura sputtering + erosion (port of
``scpn_fusion_tpu/models/nuclear/pwi.py``).

The reduced Bohdansky yield

    Y(E) = Q s_n(eps) (1 - (E_th/E)^{2/3})(1 - E_th/E)^2 f(angle)

with s_n = ln(1 + 1.2288 eps)/(1 + sqrt(eps)), eps = E/E_th, an angular
enhancement 1/cos(theta) capped at 5, redeposition, and the macroscopic
erosion rate in mm/year.  All functions broadcast over tensors and are
differentiable (wall-lifetime sensitivities from ``torch.autograd``).
Python numbers become ``dtype`` (float32 by default) on ``device``; a
tensor input sets both.
"""

from __future__ import annotations

import dataclasses

import torch

from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

_MATERIALS = {
    # (E_th [eV], Q, atomic mass [amu], density [g/cc])
    "Tungsten": (200.0, 0.03, 183.84, 19.25),
    "Carbon": (30.0, 0.1, 12.0, 2.2),
}


@dataclasses.dataclass(frozen=True)
class SputteringMaterial:
    e_th_ev: float = 200.0
    q_yield: float = 0.03
    atomic_mass: float = 183.84
    density_g_cc: float = 19.25
    redeposition_factor: float = 0.95

    @classmethod
    def from_name(cls, name: str = "Tungsten",
                  redeposition_factor: float = 0.95):
        e_th, q, mass, rho = _MATERIALS.get(name, _MATERIALS["Carbon"])
        return cls(e_th, q, mass, rho,
                   float(min(max(redeposition_factor, 0.0), 0.999)))


def sputtering_yield(mat: SputteringMaterial, e_ion_ev, angle_deg=45.0, *, dtype=None,
                     device="cuda"):
    """Atoms ejected per incident ion; zero below threshold (broadcasts)."""
    e, angle = as_tensors(e_ion_ev, angle_deg, dtype=dtype, device=device)
    e_safe = torch.clamp(e, min=mat.e_th_ev * (1.0 + 1e-9))
    eps = e_safe / mat.e_th_ev
    ratio = mat.e_th_ev / e_safe
    s_n = torch.log1p(1.2288 * eps) / (1.0 + torch.sqrt(eps))
    thr = torch.clamp((1.0 - ratio ** (2.0 / 3.0)) * (1.0 - ratio) ** 2, min=0.0)
    theta = torch.deg2rad(torch.clamp(angle, 0.0, 89.0))
    f_ang = torch.clamp(1.0 / torch.clamp(torch.cos(theta), min=1e-3), max=5.0)
    y = mat.q_yield * s_n * thr * f_ang
    return torch.where(e > mat.e_th_ev, torch.clamp(y, min=0.0), 0.0)


def erosion_rate(mat: SputteringMaterial, flux_m2_s, t_ion_ev, angle_deg=45.0, *, dtype=None,
                 device="cuda"):
    """Erosion metrics dict (impact energy 5 T_i sheath closure).

    Returns dict with Yield, E_impact, Net_Flux [1/m^2 s],
    Erosion_mm_year, Impurity_Source -- same keys as the reference.
    """
    flux, t_ion = as_tensors(flux_m2_s, t_ion_ev, dtype=dtype, device=device)
    e_impact = 5.0 * t_ion
    y = sputtering_yield(mat, e_impact, angle_deg)
    flux_net = flux * y * (1.0 - mat.redeposition_factor)
    recession = flux_net * (mat.atomic_mass * 1.66e-27) \
        / (mat.density_g_cc * 1000.0)
    mm_year = recession * 1000.0 * (3600.0 * 24.0 * 365.0)
    return {
        "Yield": y,
        "E_impact": e_impact,
        "Net_Flux": flux_net,
        "Redeposition": mat.redeposition_factor,
        "Erosion_mm_year": mm_year,
        "Impurity_Source": flux_net,
    }


def erosion_scan(mat: SputteringMaterial, flux_m2_s, t_min_ev, t_max_ev,
                 n_points: int = 50, angle_deg=45.0, *, dtype=torch.float32, device="cuda"):
    """Vectorised temperature scan (reference ``run_pwi_demo`` loop)."""
    temps = linspace(t_min_ev, t_max_ev, n_points, dtype, device)
    out = erosion_rate(mat, flux_m2_s, temps, angle_deg)
    return temps, out["Erosion_mm_year"], out["Yield"]
