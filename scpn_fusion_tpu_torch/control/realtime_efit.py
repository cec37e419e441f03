"""Realtime EFIT: equilibrium reconstruction from magnetics in one matmul
(port of ``scpn_fusion_tpu/control/realtime_efit.py``).

All geometry-dependent work happens once at build time -- the basis current
distributions (p' modes ~ R s^k, FF' modes ~ s^k / R over an elliptical
plasma region), their Green's-function responses at every flux loop and B
probe, the coil responses, the basis psi maps on the grid and the
Tikhonov-regularised solve operator -- so one reconstruction is
``coeffs = P @ residual`` and ``psi = coeffs @ basis_maps``.

The B-probe responses are derivatives of the filament flux with respect to
the observation point: the JAX package takes ``jax.grad`` of
``green_coil_psi`` per probe and source; the port takes one autograd pass
over the observation coordinate expanded to one copy a source.  The basis psi
maps sum the filament flux of every cell at every grid point, O(N^4): the
port takes the observation points in chunks under a fixed byte budget
(:data:`PSI_MAP_BYTES`), each point's sum over the sources one reduction (a
row of one matrix product with the six bases' cell weights), where JAX
materialises the whole (N^2, N^2) array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.core.special import green_coil_psi

MU0 = 4.0e-7 * math.pi
PSI_MAP_BYTES = 1 << 26      # the bytes of one (chunk, sources) temporary of the psi maps


@dataclasses.dataclass(frozen=True)
class MagneticsLayout:
    """Sensor geometry (reference ``MagneticDiagnostics`` contract)."""

    flux_loops: tuple            # ((r, z), ...)
    b_probes: tuple              # ((r, z, "R"|"Z"), ...)
    coil_r: tuple
    coil_z: tuple

    def __post_init__(self):
        if len(self.flux_loops) + len(self.b_probes) < 4:
            raise ValueError("need at least 4 magnetic sensors")
        for r, z, d in self.b_probes:
            if d not in ("R", "Z"):
                raise ValueError("B probe direction must be 'R' or 'Z'")


def _sensor_responses(src_r: torch.Tensor, src_z: torch.Tensor,
                      layout: MagneticsLayout) -> torch.Tensor:
    """(n_src, n_sensors): unit-current responses of each source filament at
    the flux loops, then the B probes (B_Z = (1/R) dpsi/dR, B_R = -(1/R)
    dpsi/dZ at the probe)."""
    dtype, dev = src_r.dtype, src_r.device
    cols = []
    for r, z in layout.flux_loops:
        cols.append(green_coil_psi(src_r, src_z, torch.tensor(r, dtype=dtype, device=dev),
                                   torch.tensor(z, dtype=dtype, device=dev), MU0))
    for r, z, direction in layout.b_probes:
        with torch.enable_grad():
            obs = torch.full_like(src_r, r if direction == "Z" else z).requires_grad_(True)
            rz = (obs, torch.full_like(src_r, z)) if direction == "Z" else \
                (torch.full_like(src_r, r), obs)
            psi = green_coil_psi(src_r.detach(), src_z.detach(), rz[0], rz[1], MU0)
            (g,) = torch.autograd.grad(psi.sum(), obs)
        cols.append(g / r if direction == "Z" else -g / r)
    if not cols:
        return torch.zeros((src_r.shape[0], 0), dtype=dtype, device=dev)
    return torch.stack(cols, dim=1)


class EFITModel(NamedTuple):
    """Precomputed reconstruction operator (geometry-static)."""

    basis_maps: torch.Tensor       # (n_k, NZ, NR) psi map per unit coeff
    basis_sensor: torch.Tensor     # (n_sensors, n_k)
    basis_ip: torch.Tensor         # (n_k,) plasma current per unit coeff
    coil_sensor: torch.Tensor      # (n_sensors, n_coils)
    coil_maps: torch.Tensor        # (n_coils, NZ, NR)
    solve_op: torch.Tensor         # (n_k, n_sensors + 1) Tikhonov inverse
    ip_weight: torch.Tensor        # weight of the Ip constraint row
    r_1d: torch.Tensor
    z_1d: torch.Tensor


class EFITResult(NamedTuple):
    psi: torch.Tensor
    coeffs: torch.Tensor
    ip_reconstructed: torch.Tensor
    axis_r: torch.Tensor
    axis_z: torch.Tensor
    residual_norm: torch.Tensor


def _psi_maps(weights: torch.Tensor, rr: torch.Tensor, zz: torch.Tensor,
              eps2: float) -> torch.Tensor:
    """(n_k, NZ, NR): at every grid point, the sum over the cells of the
    filament flux times each basis' cell weight (``weights``: (n_k, n_src);
    a product of the (chunk, sources) flux block with ``weights.T``),
    the point's own cell (d^2 <= eps2, the log-singular self term) left out.
    Observation points go in chunks of at most :data:`PSI_MAP_BYTES` a
    (chunk, sources) temporary."""
    src_r, src_z = rr.reshape(-1), zz.reshape(-1)
    n = src_r.shape[0]
    chunk = max(1, PSI_MAP_BYTES // (n * src_r.element_size()))
    out = []
    for lo in range(0, n, chunk):
        robs, zobs = src_r[lo:lo + chunk, None], src_z[lo:lo + chunk, None]
        g = green_coil_psi(src_r, src_z, robs, zobs, MU0)
        d2 = (src_r - robs) ** 2 + (src_z - zobs) ** 2
        g = torch.where(d2 > eps2, g, torch.zeros_like(g))
        out.append(g @ weights.T)
    return torch.cat(out, dim=0).T.reshape(weights.shape[0], *rr.shape)


def build_efit_model(grid: Grid, layout: MagneticsLayout, *, r_axis: float,
                     z_axis: float = 0.0, a_minor: float = 1.0, kappa: float = 1.6,
                     n_p_modes: int = 3, n_ff_modes: int = 3, tikhonov: float = 1e-3,
                     ip_weight: float = 10.0) -> EFITModel:
    """Build all response matrices once per machine geometry, in the grid's
    dtype on its device."""
    rr, zz = grid.RR, grid.ZZ
    s2 = ((rr - r_axis) / a_minor) ** 2 + ((zz - z_axis) / (kappa * a_minor)) ** 2
    s = torch.sqrt(torch.clamp(s2, 0.0, 1.0))
    inside = (s2 < 1.0).to(rr.dtype)
    shape = (1.0 - s ** 2) * inside       # peaked flux-label weight

    bases = [rr / r_axis * shape ** (k + 1) for k in range(n_p_modes)]
    bases += [r_axis / rr * shape ** (k + 1) for k in range(n_ff_modes)]
    j_basis = torch.stack(bases)          # (n_k, NZ, NR) current density

    d_area = grid.dR * grid.dZ
    basis_ip = torch.sum(j_basis, dim=(1, 2)) * d_area

    # Discretised Green's responses: every grid cell is a filament.
    weights = (j_basis * d_area).reshape(j_basis.shape[0], -1)      # (n_k, n_cells)
    cell_resp = _sensor_responses(rr.reshape(-1), zz.reshape(-1), layout)   # (n_cells, n_s)
    basis_sensor = torch.stack([(w[:, None] * cell_resp).sum(dim=0) for w in weights], dim=1)

    # Exclude the self-cell (log-singular Green's function): its
    # principal-value contribution is O(dA log dA) and negligible.
    eps2 = 0.25 * (grid.dR ** 2 + grid.dZ ** 2)
    basis_maps = _psi_maps(weights, rr, zz, eps2)

    coil_r = torch.tensor(layout.coil_r, dtype=rr.dtype, device=rr.device)
    coil_z = torch.tensor(layout.coil_z, dtype=rr.dtype, device=rr.device)
    coil_sensor = _sensor_responses(coil_r, coil_z, layout).T
    coil_maps = green_coil_psi(coil_r[:, None, None], coil_z[:, None, None], rr, zz, MU0)

    # Tikhonov-regularised solve operator with the Ip constraint appended as
    # a weighted row: A = [basis_sensor; w * basis_ip].
    a = torch.cat([basis_sensor, ip_weight * basis_ip[None, :]], dim=0)
    gram = a.T @ a + tikhonov * torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    solve_op = torch.linalg.solve(gram, a.T)

    return EFITModel(basis_maps=basis_maps, basis_sensor=basis_sensor, basis_ip=basis_ip,
                     coil_sensor=coil_sensor, coil_maps=coil_maps, solve_op=solve_op,
                     ip_weight=torch.tensor(ip_weight, dtype=basis_ip.dtype,
                                            device=basis_ip.device),
                     r_1d=grid.R, z_1d=grid.Z)


def reconstruct(model: EFITModel, measurements: torch.Tensor, coil_currents: torch.Tensor,
                ip_target) -> EFITResult:
    """One rt reconstruction: subtract the coil contributions, solve for the
    basis coefficients, assemble psi; the axis is psi's argmax on the grid.
    Small matmuls and no host read."""
    resid = measurements - model.coil_sensor @ coil_currents
    ip = torch.as_tensor(ip_target, dtype=resid.dtype, device=resid.device).reshape(1)
    rhs = torch.cat([resid, model.ip_weight * ip])
    coeffs = model.solve_op @ rhs
    psi = (torch.tensordot(coeffs, model.basis_maps, dims=([0], [0]))
           + torch.tensordot(coil_currents, model.coil_maps, dims=([0], [0])))
    ip_rec = model.basis_ip @ coeffs
    fit = model.basis_sensor @ coeffs
    residual_norm = torch.linalg.norm(fit - resid)
    idx = torch.argmax(psi)
    nr = psi.shape[1]
    return EFITResult(psi=psi, coeffs=coeffs, ip_reconstructed=ip_rec,
                      axis_r=model.r_1d[idx % nr], axis_z=model.z_1d[idx // nr],
                      residual_norm=residual_norm)


def synthetic_measurements(model: EFITModel, coeffs: torch.Tensor,
                           coil_currents: torch.Tensor) -> torch.Tensor:
    """Forward model: sensor values for known basis coeffs."""
    return model.basis_sensor @ coeffs + model.coil_sensor @ coil_currents
