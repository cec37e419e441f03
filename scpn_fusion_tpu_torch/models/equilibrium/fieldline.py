"""3D field-line tracing: Poincaré sections, q from line-following,
connection length (port of ``scpn_fusion_tpu/models/equilibrium/fieldline.py``).

The tracer integrates all seed lines at once: the state is a batch of
(R, Z) points advanced by RK4 over toroidal steps in a Python loop (the JAX
module's ``lax.scan``).  The field is an axisymmetric equilibrium (psi
interpolated bilinearly) plus an optional helical perturbation.  The
model's tables are moved to the device once a trace.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class FieldModel:
    """Axisymmetric field from psi + F=R B_phi, plus helical perturbation.

    B_R = -(1/R) dpsi/dZ, B_Z = (1/R) dpsi/dR, B_phi = f_tor / R;
    perturbation: B_r_pert = eps * B0 * cos(m theta - n phi) mapped onto
    (R, Z) around the axis (the standard island-seeding form).
    """

    r_1d: tuple
    z_1d: tuple
    psi: tuple              # flattened row-major (NZ*NR,)
    f_tor: float = 12.0     # R0 * B0
    axis_r: float = 6.2
    axis_z: float = 0.0
    pert_eps: float = 0.0
    pert_m: int = 2
    pert_n: int = 1

    def arrays(self, dtype: torch.dtype = torch.float64, device: torch.device | str = "cuda"):
        """(r_1d, z_1d, psi) as tensors on ``device``."""
        r = torch.tensor(self.r_1d, dtype=dtype, device=device)
        z = torch.tensor(self.z_1d, dtype=dtype, device=device)
        psi = torch.tensor(self.psi, dtype=dtype, device=device).reshape(z.shape[0], r.shape[0])
        return r, z, psi


def _bilinear(psi, r_1d, z_1d, r, z):
    d_r = r_1d[1] - r_1d[0]
    d_z = z_1d[1] - z_1d[0]
    tr = torch.clamp((r - r_1d[0]) / d_r, 0.0, r_1d.shape[0] - 1.001)
    tz = torch.clamp((z - z_1d[0]) / d_z, 0.0, z_1d.shape[0] - 1.001)
    i0 = torch.floor(tr).to(torch.int32).long()
    j0 = torch.floor(tz).to(torch.int32).long()
    wr = tr - i0.to(tr.dtype)
    wz = tz - j0.to(tz.dtype)
    return ((1 - wz) * ((1 - wr) * psi[j0, i0] + wr * psi[j0, i0 + 1])
            + wz * ((1 - wr) * psi[j0 + 1, i0] + wr * psi[j0 + 1, i0 + 1]))


def _b_field(model: FieldModel, tables, r, z, phi):
    r_1d, z_1d, psi = tables
    eps_fd = 1e-4

    def psi_at(rr, zz):
        return _bilinear(psi, r_1d, z_1d, rr, zz)

    dpsi_dr = (psi_at(r + eps_fd, z) - psi_at(r - eps_fd, z)) / (2 * eps_fd)
    dpsi_dz = (psi_at(r, z + eps_fd) - psi_at(r, z - eps_fd)) / (2 * eps_fd)
    b_r = -dpsi_dz / r
    b_z = dpsi_dr / r
    b_phi = model.f_tor / r

    if model.pert_eps != 0.0:
        theta = torch.atan2(z - model.axis_z, r - model.axis_r)
        b0 = model.f_tor / model.axis_r
        amp = model.pert_eps * b0 * torch.cos(model.pert_m * theta - model.pert_n * phi)
        b_r = b_r + amp * torch.cos(theta)
        b_z = b_z + amp * torch.sin(theta)
    return b_r, b_phi, b_z


def b_field_at(model: FieldModel, r: torch.Tensor, z: torch.Tensor, phi):
    """(B_R, B_phi, B_Z) at cylindrical points (batched), on ``r``'s device."""
    return _b_field(model, model.arrays(r.dtype, r.device), r, z, phi)


class TraceResult(NamedTuple):
    r: torch.Tensor           # (n_steps+1, n_lines)
    z: torch.Tensor
    phi: torch.Tensor         # (n_steps+1,)


def trace_field_lines(model: FieldModel, r0, z0, *, n_turns: float = 50.0,
                      steps_per_turn: int = 128, dtype: torch.dtype = torch.float64,
                      device: torch.device | str = "cuda") -> TraceResult:
    """RK4 integration of dR/dphi = R B_R/B_phi, dZ/dphi = R B_Z/B_phi for
    all seed lines simultaneously, on ``device`` in ``dtype``."""
    n_steps = int(n_turns * steps_per_turn)
    d_phi = 2.0 * math.pi / steps_per_turn
    tables = model.arrays(dtype, device)

    def rhs(r, z, phi):
        b_r, b_phi, b_z = _b_field(model, tables, r, z, phi)
        safe = torch.where(b_phi.abs() > 1e-12, b_phi, torch.full_like(b_phi, 1e-12))
        return r * b_r / safe, r * b_z / safe

    r = torch.atleast_1d(torch.as_tensor(r0, dtype=dtype, device=device))
    z = torch.atleast_1d(torch.as_tensor(z0, dtype=dtype, device=device))
    rs, zs = [r], [z]
    for k in range(n_steps):
        phi = k * d_phi
        k1r, k1z = rhs(r, z, phi)
        k2r, k2z = rhs(r + 0.5 * d_phi * k1r, z + 0.5 * d_phi * k1z, phi + 0.5 * d_phi)
        k3r, k3z = rhs(r + 0.5 * d_phi * k2r, z + 0.5 * d_phi * k2z, phi + 0.5 * d_phi)
        k4r, k4z = rhs(r + d_phi * k3r, z + d_phi * k3z, phi + d_phi)
        r = r + d_phi / 6.0 * (k1r + 2 * k2r + 2 * k3r + k4r)
        z = z + d_phi / 6.0 * (k1z + 2 * k2z + 2 * k3z + k4z)
        rs.append(r)
        zs.append(z)
    phis = torch.arange(n_steps + 1, dtype=dtype, device=device) * d_phi
    return TraceResult(r=torch.stack(rs), z=torch.stack(zs), phi=phis)


def poincare_section(trace: TraceResult, steps_per_turn: int):
    """(R, Z) puncture points at phi = 0 mod 2pi for every line."""
    return trace.r[::steps_per_turn], trace.z[::steps_per_turn]


def _unwrap(p: torch.Tensor) -> torch.Tensor:
    """``jnp.unwrap(p, axis=0)`` (period 2 pi)."""
    period = 2.0 * math.pi
    interval = period / 2
    dd = torch.diff(p, dim=0)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), torch.full_like(ddmod, interval), ddmod)
    ph_correct = torch.where(dd.abs() < interval, torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[:1], p[1:] + torch.cumsum(ph_correct, dim=0)], dim=0)


def safety_factor_from_trace(trace: TraceResult, axis_r: float, axis_z: float,
                             steps_per_turn: int):
    """q per line = toroidal turns / poloidal turns of the traced line."""
    theta = _unwrap(torch.atan2(trace.z - axis_z, trace.r - axis_r))
    n_tor_turns = trace.phi[-1] / (2.0 * math.pi)
    n_pol_turns = (theta[-1] - theta[0]) / (2.0 * math.pi)
    return n_tor_turns / torch.where(n_pol_turns.abs() > 1e-9, n_pol_turns,
                                     torch.full_like(n_pol_turns, float("inf")))


def connection_length(model: FieldModel, r0, z0, *, wall_psi: float, n_turns: float = 200.0,
                      steps_per_turn: int = 64, dtype: torch.dtype = torch.float64,
                      device: torch.device | str = "cuda"):
    """Parallel length until the line crosses the wall flux surface
    (open-line SOL metric; the whole traced length if it never does)."""
    r_1d, z_1d, psi = model.arrays(dtype, device)
    tr = trace_field_lines(model, r0, z0, n_turns=n_turns, steps_per_turn=steps_per_turn,
                           dtype=dtype, device=device)
    psi_line = _bilinear(psi, r_1d, z_1d, tr.r, tr.z)
    outside = psi_line < wall_psi
    d_phi = 2.0 * math.pi / steps_per_turn
    # arc length element ~ sqrt((R dphi)^2 + dR^2 + dZ^2) accumulated
    dl = torch.sqrt((tr.r[:-1] * d_phi) ** 2 + torch.diff(tr.r, dim=0) ** 2
                    + torch.diff(tr.z, dim=0) ** 2)
    cum = torch.cumsum(dl, dim=0)
    hit = outside[1:]
    first = torch.argmax(hit.to(torch.uint8), dim=0)
    l_conn = torch.gather(cum, 0, first[None])[0]
    return torch.where(hit.any(dim=0), l_conn, cum[-1])
