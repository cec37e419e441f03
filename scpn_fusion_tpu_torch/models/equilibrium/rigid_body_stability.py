"""n=0 rigid-body stability: ring forces, stiffness matrix, field index (port
of ``scpn_fusion_tpu/models/equilibrium/rigid_body_stability.py``).

* Fields are sampled bilinearly from the grid-difference gradients with the
  edge handling of ``map_coordinates(order=1, mode="nearest")`` (both corner
  indices clamped to the grid), so the force model is a smooth function of
  ``(R, Z)`` that autograd differentiates;
* the stiffness matrix is the exact Jacobian ``K = -dF/d(R,Z)``
  (``torch.func.jacfwd``, forward mode as in the JAX module);
* the 2x2 eigenvalues are closed-form (trace/determinant);
* the stability landscape evaluates the force model on the whole query mesh
  at once (the JAX module ``vmap``s a point function; every operation here is
  elementwise in the query points).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.topology import gradient

MU0 = 4.0e-7 * math.pi


class RingForces(NamedTuple):
    f_r_n: torch.Tensor       # total radial force [N]
    f_z_n: torch.Tensor       # total vertical force [N]
    f_hoop_n: torch.Tensor
    f_lorentz_r_n: torch.Tensor
    f_lorentz_z_n: torch.Tensor
    n_index: torch.Tensor     # field decay index


class RigidBodyReport(NamedTuple):
    forces: RingForces
    stiffness_n_m: torch.Tensor    # 2x2, K = -dF/d(R,Z)
    eigenvalues: torch.Tensor      # complex pair (closed form)
    radial_stable: torch.Tensor    # bool: Re(lambda_R) > 0
    vertical_stable: torch.Tensor  # bool: Re(lambda_Z) > 0
    n_index_ok: torch.Tensor       # bool: 0 < n < 1.5


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _sample(field: torch.Tensor, grid: Grid, r, z) -> torch.Tensor:
    """Differentiable bilinear sample of a (NZ, NR) field at (r, z) (any
    matching shapes): ``map_coordinates(order=1, mode="nearest")``."""
    coords = ((_as(z, field) - grid.Z_min) / grid.dZ, (_as(r, field) - grid.R_min) / grid.dR)
    nodes = []
    for c, size in zip(coords, field.shape):
        lower = torch.floor(c)
        upper_w = c - lower
        index = lower.to(torch.int32)
        nodes.append(((torch.clamp(index, 0, size - 1).long(), 1 - upper_w),
                      (torch.clamp(index + 1, 0, size - 1).long(), upper_w)))
    out = None
    for iz, wz in nodes[0]:
        for ir, wr in nodes[1]:
            term = (wz * wr) * field[iz, ir]
            out = term if out is None else out + term
    return out


def vacuum_field_at(psi_vac: torch.Tensor, grid: Grid, r, z):
    """``(Bz, Br, n_index)`` at (R, Z) from the vacuum flux map.

    ``Bz = (1/R) dPsi/dR``, ``Br = -(1/R) dPsi/dZ``,
    ``n = -(R/Bz) dBz/dR``; the grid-difference gradient fields are sampled
    bilinearly, and the decay index uses a second sampled derivative.
    """
    dpsi_dr = gradient(psi_vac, grid.dR, 1)
    dpsi_dz = gradient(psi_vac, grid.dZ, 0)
    r = _as(r, psi_vac)
    bz_field = dpsi_dr / torch.clamp(grid.RR.to(psi_vac.device), min=1e-9)
    bz = _sample(bz_field, grid, r, z)
    br = -_sample(dpsi_dz, grid, r, z) / r
    dbz_dr = _sample(gradient(bz_field, grid.dR, 1), grid, r, z)
    n_index = -r / torch.where(bz.abs() > 1e-12, bz, torch.sign(bz) * 1e-12 + 1e-15) * dbz_dr
    return bz, br, n_index


def ring_forces(psi_vac: torch.Tensor, grid: Grid, r, z, ip_ma, *, beta_p: float = 0.5,
                li: float = 0.8, minor_radius_fraction: float = 1.0 / 3.0) -> RingForces:
    """Forces on the rigid plasma ring.

    Hoop (Shafranov): ``F = (mu0 Ip^2 / 2)(ln(8R/a) + beta_p + li/2 - 3/2)/R``
    with ``a = R * minor_radius_fraction``; Lorentz: ``F_R = Ip Bz 2 pi R``,
    ``F_Z = -Ip Br 2 pi R``.
    """
    r = _as(r, psi_vac)
    ip_a = _as(ip_ma, psi_vac) * 1e6
    bz, br, n_index = vacuum_field_at(psi_vac, grid, r, z)
    a = r * minor_radius_fraction
    term = torch.log(8.0 * r / a) + beta_p + li / 2.0 - 1.5
    f_hoop = (MU0 * ip_a**2 / 2.0) * term / r
    f_lor_r = ip_a * bz * 2.0 * math.pi * r
    f_lor_z = -ip_a * br * 2.0 * math.pi * r
    return RingForces(f_r_n=f_hoop + f_lor_r, f_z_n=f_lor_z, f_hoop_n=f_hoop,
                      f_lorentz_r_n=f_lor_r, f_lorentz_z_n=f_lor_z, n_index=n_index)


def _eig2x2(k: torch.Tensor) -> torch.Tensor:
    """Closed-form eigenvalues of a real 2x2 (complex output)."""
    tr = k[0, 0] + k[1, 1]
    det = k[0, 0] * k[1, 1] - k[0, 1] * k[1, 0]
    disc = (tr / 2.0) ** 2 - det
    cdtype = torch.complex128 if disc.dtype == torch.float64 else torch.complex64
    root = torch.sqrt(disc.to(cdtype))
    return torch.stack([tr / 2.0 + root, tr / 2.0 - root])


def analyze_rigid_body(psi_vac: torch.Tensor, grid: Grid, *, r_target, z_target, ip_ma,
                       beta_p: float = 0.5, li: float = 0.8) -> RigidBodyReport:
    """Force-balance linearisation + eigenvalue stability summary on
    ``psi_vac``'s device.

    ``K = -dF/d(R,Z)`` is the exact forward-mode Jacobian of the force
    model; a positive eigenvalue is a restoring force along that mode.
    """
    def force_vec(x):
        f = ring_forces(psi_vac, grid, x[0], x[1], ip_ma, beta_p=beta_p, li=li)
        return torch.stack([f.f_r_n, f.f_z_n])

    x0 = torch.stack([_as(r_target, psi_vac), _as(z_target, psi_vac)])
    forces = ring_forces(psi_vac, grid, x0[0], x0[1], ip_ma, beta_p=beta_p, li=li)
    k = -torch.func.jacfwd(force_vec)(x0)
    eig = _eig2x2(k)
    # Mode identification: for the (near-)diagonal K of an up-down-symmetric
    # machine the first eigenvalue tracks K_RR (radial), the second K_ZZ.
    radial_idx = torch.argmin((eig.real - k[0, 0]).abs())
    lam_r = eig.real[radial_idx]
    lam_z = eig.real[1 - radial_idx]
    n0 = forces.n_index
    return RigidBodyReport(
        forces=forces, stiffness_n_m=k, eigenvalues=eig,
        radial_stable=lam_r > 0.0, vertical_stable=lam_z > 0.0,
        n_index_ok=(n0 > 0.0) & (n0 < 1.5))


def stability_landscape(psi_vac: torch.Tensor, grid: Grid, *, r_points: torch.Tensor,
                        z_points: torch.Tensor, ip_ma) -> tuple[torch.Tensor, torch.Tensor]:
    """(F_R, F_Z) maps over the query mesh ``meshgrid(r_points, z_points,
    indexing="xy")``, shape ``(len(z_points), len(r_points))``."""
    rr, zz = torch.meshgrid(_as(r_points, psi_vac), _as(z_points, psi_vac), indexing="xy")
    f = ring_forces(psi_vac, grid, rr, zz, ip_ma)
    return f.f_r_n, f.f_z_n
