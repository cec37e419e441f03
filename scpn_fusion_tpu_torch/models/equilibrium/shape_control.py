"""Free-boundary shape control: response matrices, targets, the wall
response (port of ``scpn_fusion_tpu/models/equilibrium/shape_control.py``).

* the magnetic-probe response matrix: flux-loop rows (the coils' Green's
  flux) and B_R / B_Z probe rows (central differences of the same flux);
* coil currents from magnetics: weighted, Tikhonov-regularised around the
  prior, box-bounded (projected FISTA, ``ops/lstsq``);
* isoflux / X-point-null / strike-point targets as rows of one linear system
  in the coil currents, solved by one bounded least squares;
* the von Hagenow wall response ``M[wall, interior]``: the plasma's flux on
  the computational wall as one matrix product a Picard step.

The JAX module's ``vmap`` over coils and points is broadcasting here.  The
matrix products are ``torch.matmul`` with TF32 off (PyTorch's default), so a
float32 product stays float32.  ``jnp.gradient`` is ``topology.gradient``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.core.special import green_coil_psi
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import (
    MU0_SI,
    CoilSet,
    interp_psi_at_points,
    mutual_inductance_matrix,
)
from scpn_fusion_tpu_torch.models.equilibrium.topology import gradient
from scpn_fusion_tpu_torch.ops.lstsq import bounded_lstsq


# ── Probe response (flux loops + B probes) ──


def _coil_flux_at(coils: CoilSet, r_obs: torch.Tensor, z_obs: torch.Tensor,
                  mu0: float) -> torch.Tensor:
    """(n_pts, n_coils): flux at each point per unit current of each coil."""
    return coils.turns * green_coil_psi(coils.r, coils.z, r_obs[:, None], z_obs[:, None], mu0)


def probe_response_matrix(
    coils: CoilSet,
    *,
    flux_points: torch.Tensor | None = None,     # (n_flux, 2)
    b_probe_points: torch.Tensor | None = None,  # (n_b, 2)
    b_probe_dirs: torch.Tensor | None = None,    # (n_b,) 0 = B_R, 1 = B_Z
    mu0: float = MU0_SI,
) -> torch.Tensor:
    """Diagnostic response matrix ``(n_flux + n_b, n_coils)``.  B rows are
    central differences of the flux kernel with the reference's step rule:
    ``B_R = -(1/R) dpsi/dZ``, ``B_Z = (1/R) dpsi/dR``."""
    if flux_points is None and b_probe_points is None:
        raise ValueError("need flux_points and/or b_probe_points")
    blocks = []
    if flux_points is not None:
        blocks.append(_coil_flux_at(coils, flux_points[:, 0], flux_points[:, 1], mu0))
    if b_probe_points is not None:
        if b_probe_dirs is None:
            raise ValueError("b_probe_dirs required with b_probe_points")
        r_o, z_o = b_probe_points[:, 0], b_probe_points[:, 1]
        eps_r = torch.clamp(1e-5 * r_o.abs(), min=1e-5)
        eps_z = torch.clamp(1e-5 * (1.0 + z_o.abs()), min=1e-5)
        r_safe = torch.maximum(r_o, eps_r)
        b_r = -(_coil_flux_at(coils, r_safe, z_o + eps_z, mu0)
                - _coil_flux_at(coils, r_safe, z_o - eps_z, mu0)) / (2.0 * eps_z * r_safe)[:, None]
        b_z = (_coil_flux_at(coils, r_safe + eps_r, z_o, mu0)
               - _coil_flux_at(coils, r_safe - eps_r, z_o, mu0)) / (2.0 * eps_r * r_safe)[:, None]
        blocks.append(torch.where((b_probe_dirs == 0)[:, None], b_r, b_z))
    return torch.cat(blocks)


class ReconstructionResult(NamedTuple):
    coil_currents: torch.Tensor
    residual: torch.Tensor
    weighted_residual_rms: torch.Tensor
    residual_rms: torch.Tensor


def _box(limits: torch.Tensor | None, like: torch.Tensor):
    """(lb, ub): +-|limits|, or +-1e30 without limits."""
    if limits is not None:
        return -limits.abs(), limits.abs()
    big = torch.full_like(like, 1e30)
    return -big, big


def reconstruct_coil_currents(
    response: torch.Tensor,        # (n_meas, n_coils)
    measurements: torch.Tensor,    # (n_meas,)
    prior: torch.Tensor,           # (n_coils,) prior currents
    *,
    sigma: torch.Tensor | None = None,
    tikhonov_alpha: float | torch.Tensor = 1e-6,
    current_limits: torch.Tensor | None = None,
    n_iter: int = 300,
) -> ReconstructionResult:
    """Bounded coil currents from magnetics:
    ``min ||W (R I - m)||^2 + ||sqrt(alpha) (I - I_prior)||^2`` in the box;
    ``tikhonov_alpha`` is a scalar or one value a column.  The bounded solve
    starts from the unconstrained least squares, not from the prior."""
    dt, dev = response.dtype, response.device
    w = torch.ones(response.shape[0], dtype=dt, device=dev) if sigma is None else 1.0 / sigma
    n_coils = response.shape[1]
    sq = torch.sqrt(torch.as_tensor(tikhonov_alpha, dtype=dt, device=dev).expand(n_coils))
    a = torch.cat([response * w[:, None], torch.diag(sq)])
    b = torch.cat([measurements * w, sq * prior])
    lb, ub = _box(current_limits, prior)
    currents = bounded_lstsq(a, b, lb, ub, n_iter=n_iter)
    residual = response @ currents - measurements
    return ReconstructionResult(
        coil_currents=currents,
        residual=residual,
        weighted_residual_rms=torch.sqrt(((residual * w) ** 2).mean()),
        residual_rms=torch.sqrt((residual**2).mean()),
    )


def _b_grids(psi: torch.Tensor, grid: Grid) -> tuple[torch.Tensor, torch.Tensor]:
    """B_R and B_Z on the grid from central differences of ``psi``."""
    rr = torch.clamp(grid.RR, min=1e-6)
    return -gradient(psi, grid.dZ, 0) / rr, gradient(psi, grid.dR, 1) / rr


def synthetic_magnetics(
    psi_total: torch.Tensor,
    grid: Grid,
    *,
    flux_points: torch.Tensor | None = None,
    b_probe_points: torch.Tensor | None = None,
    b_probe_dirs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Magnetics forward-modelled from a flux map: flux loops read psi, B
    probes read the grid's B_R / B_Z, both interpolated at the sensors (the
    convention of :func:`probe_response_matrix`)."""
    out = []
    if flux_points is not None:
        out.append(interp_psi_at_points(psi_total, grid, flux_points))
    if b_probe_points is not None:
        b_r_grid, b_z_grid = _b_grids(psi_total, grid)
        b_r = interp_psi_at_points(b_r_grid, grid, b_probe_points)
        b_z = interp_psi_at_points(b_z_grid, grid, b_probe_points)
        out.append(torch.where(b_probe_dirs == 0, b_r, b_z))
    return torch.cat(out)


# ── Shape-target machinery (isoflux / X-point null / strike points) ──


class ShapeTargets(NamedTuple):
    """Mixed shape-control target set, all optional (None = absent).

    isoflux_points : (n_iso, 2) points whose flux must equal the flux at
        ``isoflux_reference`` (a single (2,) point, e.g. on the desired LCFS).
    flux_points / flux_values : explicit psi targets (n_f, 2) / (n_f,).
    x_points : (n_x, 2) desired field nulls — B_R = 0 and B_Z = 0 rows.
    strike_points : (n_s, 2) divertor-plate points pinned to the reference
        flux — isoflux rows against the same reference point.
    weights : per-family scalar weights (iso, flux, xnull, strike).
    """

    isoflux_points: torch.Tensor | None = None
    isoflux_reference: torch.Tensor | None = None
    flux_points: torch.Tensor | None = None
    flux_values: torch.Tensor | None = None
    x_points: torch.Tensor | None = None
    strike_points: torch.Tensor | None = None
    weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


def build_shape_system(
    coils: CoilSet,
    targets: ShapeTargets,
    psi_plasma: torch.Tensor,
    grid: Grid,
    *,
    mu0: float = MU0_SI,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Assemble (A, b) over the coil currents for the mixed target set:
    ``A @ I = b``, where the coils must supply what the (fixed) plasma flux
    does not.  Isoflux rows are differences of response rows, so the
    absolute flux level drops out."""
    w_iso, w_flux, w_xn, w_strike = targets.weights
    rows, rhs = [], []

    def iso_rows(points, ref_point, weight):
        m_pts = mutual_inductance_matrix(coils.r, coils.z, coils.turns, points, mu0).T
        m_ref = mutual_inductance_matrix(coils.r, coils.z, coils.turns, ref_point[None, :],
                                         mu0).T
        psi_p = interp_psi_at_points(psi_plasma, grid, points)
        psi_ref = interp_psi_at_points(psi_plasma, grid, ref_point[None, :])
        rows.append(weight * (m_pts - m_ref))
        rhs.append(weight * (psi_ref - psi_p))

    if targets.isoflux_points is not None:
        if targets.isoflux_reference is None:
            raise ValueError("isoflux_points needs isoflux_reference")
        iso_rows(targets.isoflux_points, targets.isoflux_reference, w_iso)
    if targets.strike_points is not None:
        if targets.isoflux_reference is None:
            raise ValueError("strike_points needs isoflux_reference")
        iso_rows(targets.strike_points, targets.isoflux_reference, w_strike)
    if targets.flux_points is not None:
        m_pts = mutual_inductance_matrix(coils.r, coils.z, coils.turns, targets.flux_points,
                                         mu0).T
        psi_p = interp_psi_at_points(psi_plasma, grid, targets.flux_points)
        rows.append(w_flux * m_pts)
        rhs.append(w_flux * (targets.flux_values - psi_p))
    if targets.x_points is not None:
        n_x = targets.x_points.shape[0]
        dev = targets.x_points.device
        for direction, b_plasma in zip((0, 1), _plasma_b_at_points(psi_plasma, grid,
                                                                  targets.x_points)):
            dirs = torch.full((n_x,), direction, dtype=torch.int32, device=dev)
            rows.append(w_xn * probe_response_matrix(coils, b_probe_points=targets.x_points,
                                                     b_probe_dirs=dirs, mu0=mu0))
            rhs.append(w_xn * (-b_plasma))
    if not rows:
        raise ValueError("ShapeTargets is empty")
    return torch.cat(rows), torch.cat(rhs)


def _plasma_b_at_points(psi_plasma: torch.Tensor, grid: Grid, points: torch.Tensor):
    b_r, b_z = _b_grids(psi_plasma, grid)
    return interp_psi_at_points(b_r, grid, points), interp_psi_at_points(b_z, grid, points)


def optimize_shape_currents(
    coils: CoilSet,
    targets: ShapeTargets,
    psi_plasma: torch.Tensor,
    grid: Grid,
    *,
    tikhonov_alpha: float = 1e-4,
    mu0: float = MU0_SI,
    n_iter: int = 300,
) -> torch.Tensor:
    """Bounded Tikhonov solve of the mixed shape system for the coil
    currents, regularised towards and started from the present currents."""
    a, b = build_shape_system(coils, targets, psi_plasma, grid, mu0=mu0)
    dt, dev = a.dtype, a.device
    n_coils = a.shape[1]
    sq = torch.sqrt(torch.tensor(tikhonov_alpha, dtype=dt, device=dev))
    a_aug = torch.cat([a, sq * torch.eye(n_coils, dtype=dt, device=dev)])
    b_aug = torch.cat([b, sq * coils.currents])
    lb, ub = _box(coils.current_limits, coils.currents)
    return bounded_lstsq(a_aug, b_aug, lb, ub, x0=coils.currents, n_iter=n_iter)


# ── Von Hagenow wall response ──


def wall_indices(nz: int, nr: int, device: torch.device | str = "cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat indices of the computational-wall ring and of the interior cells."""
    mask = np.zeros((nz, nr), bool)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    flat = mask.reshape(-1)
    return (torch.from_numpy(np.where(flat)[0]).to(device),
            torch.from_numpy(np.where(~flat)[0]).to(device))


def wall_response_matrix(grid: Grid, mu0: float = MU0_SI
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Von Hagenow response ``M[wall, interior]`` and the (wall, interior)
    indices: ``M[b, s]`` is the flux at wall point b per unit toroidal
    current at interior cell s.  Geometry only, so it is built once a solve
    (512 x 16129 at 129^2: 33 MB in float32, 66 MB in float64) and applied
    as ``psi_wall = M @ (J_phi_interior * dA)``."""
    b_idx, s_idx = wall_indices(grid.NZ, grid.NR, grid.device)
    rr = grid.RR.reshape(-1)
    zz = grid.ZZ.reshape(-1)
    m = green_coil_psi(rr[s_idx][None, :], zz[s_idx][None, :], rr[b_idx][:, None],
                       zz[b_idx][:, None], mu0)
    return m, b_idx, s_idx


def plasma_wall_flux(m: torch.Tensor, b_idx: torch.Tensor, s_idx: torch.Tensor,
                     j_phi: torch.Tensor, d_area: float, shape: tuple[int, int]) -> torch.Tensor:
    """The plasma's wall flux as a full (NZ, NR) field, zero in the interior
    (added to the coils' flux for the free-boundary Dirichlet ring)."""
    wall_vals = m @ (j_phi.reshape(-1)[s_idx] * d_area)
    out = torch.zeros(shape[0] * shape[1], dtype=j_phi.dtype, device=j_phi.device)
    out[b_idx] = wall_vals
    return out.reshape(shape)
