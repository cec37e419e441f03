"""Breeding-blanket neutronics: 1-group and 3-group cylindrical diffusion
(port of ``scpn_fusion_tpu/models/nuclear/blanket.py``).

Steady-state cylindrical diffusion-reaction transport through an annular
LiPb/Be blanket with Li-6(n,t) tritium breeding:

* 1-group: 14 MeV closure with Be (n,2n) multiplication folded into a net
  removal cross-section; Dirichlet first-wall flux, albedo rear wall.
* 3-group: fast (>1 MeV) / epithermal / thermal (<1 eV) with downscatter
  chains fast->epi->thermal, Be multiplication in the fast group, and the
  dominant 940 b thermal Li-6 capture.  Groups are solved sequentially
  (each sources the next) exactly as in the reference.

The operators are vectorised tridiagonal bands, their boundary rows
out-of-place writes, solved by ``ops.tridiag.thomas_solve`` (one launch of
row T a group on the card).  Reference headline: TBR = 1.14 for 80 cm, 90%
Li-6, port coverage 0.80, streaming 0.85 -- reproduced by
:func:`multigroup_tbr`'s defaults.  The entry points take ``dtype`` (JAX
reads its x64 flag; float32 by default here) and ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.control.scenario import interp
from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.ops.tridiag import thomas_solve


def _cylindrical_tridiag(r: torch.Tensor, diffusion: float, sigma_rem: float):
    """Interior bands of -D (1/r) d/dr(r dPhi/dr) + sigma_rem Phi."""
    dr = r[1] - r[0]
    r_p = r + 0.5 * dr
    r_m = r - 0.5 * dr
    c_p = diffusion * r_p / (r * dr**2)
    c_m = diffusion * r_m / (r * dr**2)
    sub = -c_m
    diag = c_p + c_m + sigma_rem
    sup = -c_p
    return sub, diag, sup


def _set(x: torch.Tensor, index: int, value) -> torch.Tensor:
    """``x.at[index].set(value)``: a copy of ``x`` with one entry replaced."""
    y = x.clone()
    y[index] = value
    return y


def _solve_group(r, diffusion, sigma_rem, source, bc_left, bc_right):
    """One cylindrical diffusion group through the Thomas solver.

    bc_* = ("dirichlet", value) | ("neumann", gradient) | ("albedo", a).
    """
    sub, diag, sup = _cylindrical_tridiag(r, diffusion, sigma_rem)
    rhs = source

    kind_l, val_l = bc_left
    if kind_l == "dirichlet":
        diag = _set(diag, 0, 1.0)
        sup = _set(sup, 0, 0.0)
        rhs = _set(rhs, 0, val_l)
    else:  # neumann
        diag = _set(diag, 0, 1.0)
        sup = _set(sup, 0, -1.0)
        rhs = _set(rhs, 0, val_l * (r[1] - r[0]))

    kind_r, val_r = bc_right
    if kind_r == "dirichlet":
        diag = _set(diag, -1, 1.0)
        sub = _set(sub, -1, 0.0)
        rhs = _set(rhs, -1, val_r)
    elif kind_r == "albedo":
        diag = _set(diag, -1, 1.0)
        sub = _set(sub, -1, -val_r)
        rhs = _set(rhs, -1, 0.0)
    else:  # neumann
        diag = _set(diag, -1, 1.0)
        sub = _set(sub, -1, -1.0)
        rhs = _set(rhs, -1, val_r * (r[1] - r[0]))

    # thomas_solve takes (n-1,) off-diagonal bands: sub[i] couples row i+1
    # to x[i], sup[i] couples row i to x[i+1].
    return thomas_solve(sub[1:], diag, sup[:-1], rhs)


def _trapz(y, x):
    return torch.sum(0.5 * (y[..., 1:] + y[..., :-1]) * (x[1:] - x[:-1]), dim=-1)


@dataclasses.dataclass(frozen=True)
class BlanketConfig:
    """Geometry + Li-6 enrichment (reference ``BreedingBlanket.__init__``)."""

    thickness_cm: float = 100.0
    li6_enrichment: float = 1.0
    r_inner_cm: float = 200.0
    n_cells: int = 100

    def __post_init__(self):
        if not (0.0 <= self.li6_enrichment <= 1.0):
            raise ValueError("li6_enrichment must be in [0, 1]")
        if self.thickness_cm < 0.1 or self.r_inner_cm < 10.0:
            raise ValueError("thickness >= 0.1 cm, r_inner >= 10 cm required")


class BlanketResult(NamedTuple):
    tbr: torch.Tensor
    flux: torch.Tensor           # (n_cells,) or (3, n_cells)
    production: torch.Tensor     # tritium production density


def single_group_tbr(cfg: BlanketConfig, incident_flux: float = 1e14,
                     rear_albedo: float = 0.0, *, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda") -> BlanketResult:
    """1-group enriched-blanket TBR (reference ``BreedingBlanket``).

    Raises if the configured net removal is supercritical (enrichment too
    low for the Be multiplier) -- same fail-closed contract as the
    reference.
    """
    sig_cap = 0.15 * cfg.li6_enrichment
    sig_scat, sig_par, sig_mult, gain = 0.2, 0.02, 0.08, 1.8
    sigma_rem = sig_cap + sig_par - sig_mult * (gain - 1.0)
    if sigma_rem <= 0.0:
        raise ValueError(
            f"Supercritical blanket: net removal {sigma_rem:.4f} <= 0 "
            f"(Li-6 enrichment {cfg.li6_enrichment:.3f} too low for the Be "
            "multiplier)")
    diffusion = 1.0 / (3.0 * (sig_cap + sig_scat + sig_par + sig_mult))

    r = linspace(cfg.r_inner_cm, cfg.r_inner_cm + cfg.thickness_cm, cfg.n_cells, dtype, device)
    phi = _solve_group(r, diffusion, sigma_rem, torch.zeros_like(r),
                       ("dirichlet", incident_flux), ("albedo", rear_albedo))
    phi = torch.clamp(phi, min=0.0)
    production = sig_cap * phi
    total = _trapz(production * 2.0 * math.pi * r, r)
    incident_current = (phi[0] / 4.0) * (2.0 * math.pi * cfg.r_inner_cm)
    tbr = total / torch.clamp(incident_current, min=1e-12)
    return BlanketResult(tbr, phi, production)


@dataclasses.dataclass(frozen=True)
class MultiGroupConfig:
    """3-group cross-section set (reference ``MultiGroupBlanket``)."""

    thickness_cm: float = 80.0
    li6_enrichment: float = 0.9
    r_inner_cm: float = 200.0
    n_cells: int = 200
    multiplier_gain: float = 1.8

    # fast group (14 MeV source)
    sig_cap_g1: float = 0.005     # x enrichment
    sig_scat_g1: float = 0.20
    sig_mult_g1: float = 0.10
    sig_ds_12: float = 0.20
    sig_par_g1: float = 0.005
    # epithermal
    sig_cap_g2: float = 0.05      # x enrichment
    sig_scat_g2: float = 0.15
    sig_ds_23: float = 0.18
    sig_par_g2: float = 0.01
    # thermal (940 b Li-6)
    sig_cap_g3: float = 0.80      # x enrichment
    sig_scat_g3: float = 0.05
    sig_par_g3: float = 0.01


class MultiGroupResult(NamedTuple):
    tbr: torch.Tensor
    tbr_ideal: torch.Tensor
    tbr_per_group: torch.Tensor   # (3,)
    flux: torch.Tensor            # (3, n_cells)


def multigroup_tbr(cfg: MultiGroupConfig = MultiGroupConfig(),
                   incident_flux: float = 1e14,
                   port_coverage_factor: float = 0.80,
                   streaming_factor: float = 0.85, *, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> MultiGroupResult:
    """3-group downscatter-chain TBR (reference ``solve_transport``): three
    group solves, one launch of row T each on the card."""
    e = cfg.li6_enrichment
    r = linspace(cfg.r_inner_cm, cfg.r_inner_cm + cfg.thickness_cm, cfg.n_cells, dtype, device)

    # Group 1: fast, with Be multiplication in the removal term.
    cap1 = cfg.sig_cap_g1 * e
    tot1 = cap1 + cfg.sig_scat_g1 + cfg.sig_mult_g1 + cfg.sig_ds_12 \
        + cfg.sig_par_g1
    rem1 = cap1 + cfg.sig_ds_12 + cfg.sig_par_g1 \
        - cfg.sig_mult_g1 * (cfg.multiplier_gain - 1.0)
    phi1 = _solve_group(r, 1.0 / (3.0 * tot1), rem1, torch.zeros_like(r),
                        ("dirichlet", incident_flux), ("dirichlet", 0.0))
    phi1 = torch.clamp(phi1, min=0.0)

    # Group 2: epithermal, sourced by downscatter from group 1.
    cap2 = cfg.sig_cap_g2 * e
    tot2 = cap2 + cfg.sig_scat_g2 + cfg.sig_ds_23 + cfg.sig_par_g2
    rem2 = cap2 + cfg.sig_ds_23 + cfg.sig_par_g2
    phi2 = _solve_group(r, 1.0 / (3.0 * tot2), rem2, cfg.sig_ds_12 * phi1,
                        ("neumann", 0.0), ("dirichlet", 0.0))
    phi2 = torch.clamp(phi2, min=0.0)

    # Group 3: thermal, sourced by moderation from group 2.
    cap3 = cfg.sig_cap_g3 * e
    tot3 = cap3 + cfg.sig_scat_g3 + cfg.sig_par_g3
    rem3 = cap3 + cfg.sig_par_g3
    phi3 = _solve_group(r, 1.0 / (3.0 * tot3), rem3, cfg.sig_ds_23 * phi2,
                        ("neumann", 0.0), ("dirichlet", 0.0))
    phi3 = torch.clamp(phi3, min=0.0)

    prod = torch.stack([cap1 * phi1, cap2 * phi2, cap3 * phi3])
    ring = 2.0 * math.pi * r
    raw = _trapz(prod * ring, r)
    incident_current = (phi1[0] / 4.0) * (2.0 * math.pi * cfg.r_inner_cm)
    corr = port_coverage_factor * streaming_factor
    tbr_per_group = raw / torch.clamp(incident_current, min=1e-12) * corr
    tbr_ideal = torch.sum(raw) / torch.clamp(incident_current, min=1e-12)
    return MultiGroupResult(tbr_ideal * corr, tbr_ideal, tbr_per_group,
                            torch.stack([phi1, phi2, phi3]))


def enrichment_scan(enrichments, *, thickness_cm: float = 80.0, n_cells: int = 200,
                    dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"):
    """Design scan: TBR(enrichment), one 3-group solve a point (each point a
    configuration of its own, as in JAX), read back to the host a point."""
    out = []
    for e in enrichments:
        cfg = MultiGroupConfig(thickness_cm=thickness_cm,
                               li6_enrichment=float(e), n_cells=n_cells)
        out.append(float(multigroup_tbr(cfg, dtype=dtype, device=device).tbr))
    return torch.tensor(out, dtype=dtype, device=device)


class VolumetricResult(NamedTuple):
    tbr: torch.Tensor
    tbr_ideal: torch.Tensor
    blanket_volume_m3: torch.Tensor
    total_production_per_s: torch.Tensor
    incident_neutrons_per_s: torch.Tensor


def volumetric_tbr(
    cfg: BlanketConfig,
    *,
    major_radius_m: float = 6.2,
    minor_radius_m: float = 2.0,
    elongation: float = 1.7,
    radial_cells: int = 24,
    poloidal_cells: int = 72,
    toroidal_cells: int = 48,
    incident_flux: float = 1e14,
    port_coverage_factor: float = 0.80,
    streaming_factor: float = 0.85,
    blanket_fill_factor: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> VolumetricResult:
    """Reduced 3D toroidal-shell TBR surrogate on top of the 1D depth
    profile (reference ``calculate_volumetric_tbr``,
    ``nuclear/blanket_neutronics.py:194-310``): depth attenuation anchored
    to the nominal 80 cm / 90% enriched blanket, shaped poloidal section,
    incidence weighting ``max(0.2, 0.6 + 0.4 cos^2 th)``, 5% toroidal
    modulation, then the Fischer-style 3D corrections (port coverage,
    inter-module streaming, packing fraction).  The whole shell is one
    broadcast reduction; the anchor depth profile is this module's
    cylindrical 1-group solve (one launch of row T on the card).
    """
    anchor = BlanketConfig(thickness_cm=80.0, li6_enrichment=0.9,
                           r_inner_cm=cfg.r_inner_cm, n_cells=cfg.n_cells)
    phi_1d = single_group_tbr(anchor, incident_flux, rear_albedo=0.5, dtype=dtype,
                              device=device).flux
    x_norm = linspace(0.0, 1.0, anchor.n_cells, dtype, device)

    thickness_m = max(cfg.thickness_cm * 0.01, 1e-6)
    dr = thickness_m / radial_cells
    dtheta = 2.0 * math.pi / poloidal_cells
    dphi = 2.0 * math.pi / toroidal_cells
    sig_cap = 0.15 * cfg.li6_enrichment

    def centres(n: int, step: float) -> torch.Tensor:
        return (torch.arange(n, dtype=dtype, device=device) + 0.5) * step

    depth_m = centres(radial_cells, dr)                        # (nr,)
    base_flux = interp(depth_m / thickness_m, x_norm, phi_1d)
    shell_r = minor_radius_m + depth_m
    theta = centres(poloidal_cells, dtheta)                    # (np,)
    incidence = torch.clamp(0.6 + 0.4 * torch.cos(theta) ** 2, min=0.2)
    major_local = torch.clamp(
        major_radius_m + shell_r[:, None] * torch.cos(theta)[None, :], min=0.1)
    tor = 1.0 + 0.05 * torch.cos(centres(toroidal_cells, dphi))

    # production_density = sig_cap * flux_i * inc_j * tor_k [1/cm^3/s];
    # dvol = elongation * shell_r_i * dr * dtheta * dphi * major_ij [m^3].
    geo_ij = elongation * shell_r[:, None] * dr * dtheta * dphi * major_local
    production = sig_cap * torch.sum(
        (base_flux[:, None] * incidence[None, :] * geo_ij)) * torch.sum(tor) \
        * 1e6  # m^3 -> cm^3
    volume = torch.sum(geo_ij) * toroidal_cells

    first_wall_area_m2 = (4.0 * math.pi**2 * major_radius_m
                          * minor_radius_m * elongation)
    incident_neutrons = incident_flux * first_wall_area_m2 * 1e4
    tbr_ideal = production / max(incident_neutrons, 1e-9)
    tbr = tbr_ideal * port_coverage_factor * streaming_factor \
        * blanket_fill_factor
    return VolumetricResult(tbr, tbr_ideal, volume, production,
                            torch.tensor(incident_neutrons, dtype=dtype, device=device))
