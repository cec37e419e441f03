"""Neutron wall loading + material damage analysis (port of
``scpn_fusion_tpu/models/nuclear/wall_loading.py``).

The reference's nuclear engineering lab: 14.1 MeV neutron source map from
the fusion profile, first-wall generation, line-of-sight neutron wall
loading, material dpa/He analysis, ash-poisoning burn feedback.  The
(source-cell x wall-segment) transfer kernel -- inverse-square spreading x
incidence cosine -- is one batched outer-product contraction
(``torch.matmul`` against the source vector, as JAX leaves the product to
XLA), so wall loading for new profiles is a single product once the
geometry kernel is built.  The wall's points take ``dtype`` and ``device``;
the other functions follow their tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace, xla_mean
from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

E_FUSION_J = 17.6e6 * 1.602176634e-19
NEUTRON_FRACTION = 14.1 / 17.6


@dataclasses.dataclass(frozen=True)
class WallGeometry:
    """D-shaped first wall sampled in the poloidal plane."""

    r0_m: float = 6.2
    a_wall_m: float = 2.3
    kappa: float = 1.9
    delta: float = 0.45
    n_segments: int = 96

    def points(self, *, dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"):
        theta = linspace(-math.pi, math.pi, self.n_segments, dtype, device, endpoint=False)
        r = self.r0_m + self.a_wall_m * torch.cos(
            theta + math.asin(self.delta) * torch.sin(theta))
        z = self.kappa * self.a_wall_m * torch.sin(theta)
        return r, z, theta

    def normals(self, *, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda"):
        r, z, _ = self.points(dtype=dtype, device=device)
        dr = torch.roll(r, -1) - torch.roll(r, 1)
        dz = torch.roll(z, -1) - torch.roll(z, 1)
        norm = torch.sqrt(dr ** 2 + dz ** 2) + 1e-30
        # inward normal of a counter-clockwise contour
        return -dz / norm, dr / norm


def neutron_source_density(rr, zz, *, r0_m=6.2, a_m=2.0, kappa=1.8,
                           p_fusion_mw=500.0, peaking=3.0, dtype=None, device="cuda"):
    """Volumetric 14.1 MeV neutron emission S(R, Z) [n/m^3/s] on the mesh
    ``rr``, ``zz`` (tensors, or arrays made ``dtype`` on ``device``).

    Parabolic^peaking emission profile on elliptical flux labels,
    normalised so the volume integral carries the full neutron power.
    """
    rr, zz = as_tensors(rr, zz, dtype=dtype, device=device)
    s2 = ((rr - r0_m) / a_m) ** 2 + (zz / (kappa * a_m)) ** 2
    shape = torch.clamp(1.0 - s2, min=0.0) ** peaking
    rate_total = p_fusion_mw * 1e6 * NEUTRON_FRACTION / E_FUSION_J \
        / NEUTRON_FRACTION  # neutrons/s = P_fus / E_fus
    d_r = rr[0, 1] - rr[0, 0]
    d_z = zz[1, 0] - zz[0, 0]
    vol_weight = 2.0 * math.pi * rr * d_r * d_z
    norm = torch.sum(shape * vol_weight)
    return shape * rate_total / torch.clamp(norm, min=1e-30)


class WallLoading(NamedTuple):
    r_wall: torch.Tensor
    z_wall: torch.Tensor
    flux_n_m2_s: torch.Tensor      # (n_segments,)
    nwl_mw_m2: torch.Tensor        # neutron wall load
    peaking_factor: torch.Tensor


def compute_wall_loading(source: torch.Tensor, rr: torch.Tensor, zz: torch.Tensor,
                         wall: WallGeometry = WallGeometry()) -> WallLoading:
    """One-shot transfer-kernel contraction: flux_w = K @ S.

    K[w, c] = max(cos_incidence, 0) / (4 pi d^2) per unit source; the
    toroidal volume element folds into the source vector.
    """
    kw = dict(dtype=source.dtype, device=source.device)
    r_w, z_w, _ = wall.points(**kw)
    n_r, n_z = wall.normals(**kw)
    d_r = rr[0, 1] - rr[0, 0]
    d_z = zz[1, 0] - zz[0, 0]
    s_cells = (source * 2.0 * math.pi * rr * d_r * d_z).reshape(-1)
    src_r = rr.reshape(-1)
    src_z = zz.reshape(-1)

    dx = r_w[:, None] - src_r[None, :]
    dz_ = z_w[:, None] - src_z[None, :]
    d2 = dx ** 2 + dz_ ** 2 + 1e-12
    cos_inc = torch.clamp(
        (n_r[:, None] * (-dx) + n_z[:, None] * (-dz_))
        / torch.sqrt(d2), min=0.0)
    kernel = cos_inc / (4.0 * math.pi * d2)
    flux = kernel @ s_cells
    # Conservation rescale: the wall is closed, so the captured power must
    # equal the emitted power.  The in-plane kernel alone over-counts (it
    # ignores toroidal spreading); rescaling against the exact global
    # balance fixes the absolute level while keeping the poloidal shape.
    seg_len = torch.sqrt((torch.roll(r_w, -1) - r_w) ** 2
                         + (torch.roll(z_w, -1) - z_w) ** 2)
    seg_area = 2.0 * math.pi * r_w * seg_len
    captured = torch.sum(flux * seg_area)
    emitted = torch.sum(s_cells)
    flux = flux * emitted / torch.clamp(captured, min=1e-30)
    e_n_j = 14.1e6 * 1.602176634e-19
    nwl = flux * e_n_j / 1e6
    peak = torch.max(nwl) / torch.clamp(xla_mean(nwl), min=1e-30)
    return WallLoading(r_wall=r_w, z_wall=z_w, flux_n_m2_s=flux,
                       nwl_mw_m2=nwl, peaking_factor=peak)


# Material damage coefficients: (dpa per 1e25 n/m^2 fluence,
# appm He per dpa) -- representative first-wall values.
MATERIALS = {
    "tungsten": (0.30, 0.6),
    "eurofer": (1.0, 10.0),
    "sic": (1.1, 60.0),
    "beryllium": (1.4, 300.0),
}


class MaterialReport(NamedTuple):
    dpa_per_fpy: torch.Tensor       # (n_segments,)
    he_appm_per_fpy: torch.Tensor
    lifetime_fpy: torch.Tensor      # peak-position lifetime to dpa limit


def analyze_material(loading: WallLoading, material: str = "tungsten",
                     dpa_limit: float = 50.0) -> MaterialReport:
    """dpa/He production per full-power-year + wall lifetime (reference
    ``analyze_materials`` :340 contract)."""
    if material not in MATERIALS:
        raise ValueError(f"unknown material {material!r}; "
                         f"known: {sorted(MATERIALS)}")
    dpa_coeff, he_per_dpa = MATERIALS[material]
    fpy_s = 3.156e7
    fluence_fpy = loading.flux_n_m2_s * fpy_s
    dpa = dpa_coeff * fluence_fpy / 1e25
    he = dpa * he_per_dpa
    lifetime = dpa_limit / torch.clamp(torch.max(dpa), min=1e-30)
    return MaterialReport(dpa_per_fpy=dpa, he_appm_per_fpy=he,
                          lifetime_fpy=lifetime)


def ash_poisoning_dilution(f_helium, *, tau_ratio: float = 5.0, dtype=None, device="cuda"):
    """Steady helium-ash fuel dilution factor on the fusion rate
    (reference ``simulate_ash_poisoning`` :99 reduced form):
    fuel fraction = 1 - 2 f_He (quasi-neutral dilution); the fusion rate
    scales with its square."""
    (f_helium,) = as_tensors(f_helium, dtype=dtype, device=device)
    f_fuel = torch.clamp(1.0 - 2.0 * f_helium, 0.0, 1.0)
    return f_fuel ** 2
