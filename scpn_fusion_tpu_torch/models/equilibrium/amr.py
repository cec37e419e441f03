"""AMR patch: local refinement of psi around the X-point (port of
``scpn_fusion_tpu/models/equilibrium/amr.py``).

A square window of ``2 window + 1`` coarse cells around the X-point is cut
out, prolonged bilinearly by ``factor``, relaxed with plain red-black SOR
against its frozen (prolonged) boundary, and the saddle is localised on the
fine patch by one quadratic Newton correction.  The JAX module cuts the
window with ``lax.dynamic_slice`` at traced indices; here the coordinates
and then the X-point index are read on the host (two reads a call) and the
window is a plain slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.equilibrium.topology import find_x_point, gradient
from scpn_fusion_tpu_torch.ops.stencil import sor_step


class AMRPatchResult(NamedTuple):
    psi_fine: torch.Tensor      # (n_fine, n_fine) refined local solution
    r_fine: torch.Tensor        # (n_fine,) patch R coordinates
    z_fine: torch.Tensor        # (n_fine,)
    x_point_r: torch.Tensor     # refined X-point position
    x_point_z: torch.Tensor
    x_point_psi: torch.Tensor
    grad_psi_at_x: torch.Tensor  # |grad psi| at the refined saddle


def _bilinear_upsample(tile: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear prolongation of a (m, m) tile to ((m-1)f+1, (m-1)f+1)."""
    m = tile.shape[0]
    n = (m - 1) * factor + 1
    # sample positions in coarse index space
    xi = linspace(0.0, m - 1.0, n, tile.dtype, tile.device)
    i0 = torch.clamp(torch.floor(xi).to(torch.int32), 0, m - 2).long()
    w = xi - i0.to(xi.dtype)
    rows = tile[i0, :] * (1.0 - w)[:, None] + tile[i0 + 1, :] * w[:, None]
    return rows[:, i0] * (1.0 - w)[None, :] + rows[:, i0 + 1] * w[None, :]


def _quadratic_saddle_refine(psi: torch.Tensor, iz, ir, d_r: float, d_z: float):
    """Sub-cell saddle localisation from the local quadratic patch."""
    f_r = (psi[iz, ir + 1] - psi[iz, ir - 1]) / (2.0 * d_r)
    f_z = (psi[iz + 1, ir] - psi[iz - 1, ir]) / (2.0 * d_z)
    f_rr = (psi[iz, ir + 1] - 2.0 * psi[iz, ir] + psi[iz, ir - 1]) / d_r**2
    f_zz = (psi[iz + 1, ir] - 2.0 * psi[iz, ir] + psi[iz - 1, ir]) / d_z**2
    f_rz = (psi[iz + 1, ir + 1] - psi[iz + 1, ir - 1]
            - psi[iz - 1, ir + 1] + psi[iz - 1, ir - 1]) / (4.0 * d_r * d_z)
    det = f_rr * f_zz - f_rz ** 2
    safe = det.abs() > 1e-30
    zero = torch.zeros_like(det)
    dr = torch.where(safe, (-f_r * f_zz + f_z * f_rz) / det, zero)
    dz = torch.where(safe, (-f_z * f_rr + f_r * f_rz) / det, zero)
    # clamp the Newton update to one cell
    dr = torch.clamp(dr, -d_r, d_r)
    dz = torch.clamp(dz, -d_z, d_z)
    return dr, dz, torch.sqrt(f_r ** 2 + f_z ** 2)


def refine_x_point(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                   z_1d: torch.Tensor, *, window: int = 9, factor: int = 4,
                   n_sweeps: int = 200, omega: float = 1.7) -> AMRPatchResult:
    """Extract, refine, re-solve and re-localise around the X-point, on the
    fields' device.

    psi/source: (NZ, NR) global fields; window: half-size in coarse cells;
    factor: refinement ratio; the patch solve keeps the prolonged boundary
    fixed (Dirichlet from the coarse solution).
    """
    nz, nr = psi.shape
    zz = z_1d[:, None].expand(psi.shape)
    # Two host reads: the coordinates with their spacings (in their dtype),
    # then the coarse X-point index.
    host = torch.cat([r_1d, z_1d, r_1d[1:2] - r_1d[:1], z_1d[1:2] - z_1d[:1]]).tolist()
    r_h, z_h, (d_r, d_z) = host[:nr], host[nr:nr + nz], host[nr + nz:]
    iz_t, ir_t, _ = find_x_point(psi, zz, d_r, d_z, z_h[0])
    iz, ir = (int(v) for v in torch.stack([iz_t, ir_t]).tolist())
    ir = min(max(ir, window), nr - window - 1)
    iz = min(max(iz, window), nz - window - 1)

    m = 2 * window + 1
    rows, cols = slice(iz - window, iz - window + m), slice(ir - window, ir - window + m)

    # Prolong to the fine patch.
    psi_f = _bilinear_upsample(psi[rows, cols], factor)
    src_f = _bilinear_upsample(source[rows, cols], factor)
    n_f = psi_f.shape[0]
    r_f = linspace(r_h[ir - window], r_h[ir + window], n_f, psi.dtype, psi.device)
    z_f = linspace(z_h[iz - window], z_h[iz + window], n_f, psi.dtype, psi.device)
    d_rf = d_r / factor
    d_zf = d_z / factor

    # Local re-solve with frozen Dirichlet boundary.
    for _ in range(n_sweeps):
        psi_f = sor_step(psi_f, src_f, r_f, d_rf, d_zf, omega)

    # Refined saddle: min |grad psi| on the fine patch interior, then one
    # quadratic Newton correction.
    gz, gr = gradient(psi_f, d_zf, 0), gradient(psi_f, d_rf, 1)
    gmag = torch.sqrt(gr ** 2 + gz ** 2)
    interior = torch.full_like(gmag, float("inf"))
    interior[2:-2, 2:-2] = gmag[2:-2, 2:-2]
    idx = torch.argmin(interior)
    fz, fr = idx // n_f, idx % n_f
    dr, dz, grad_at = _quadratic_saddle_refine(psi_f, fz, fr, d_rf, d_zf)
    x_r = r_f[fr] + dr
    x_z = z_f[fz] + dz
    # psi at the refined point (bilinear)
    tr = (x_r - r_f[0]) / d_rf
    tz = (x_z - z_f[0]) / d_zf
    i0 = torch.clamp(torch.floor(tr).to(torch.int32), 0, n_f - 2).long()
    j0 = torch.clamp(torch.floor(tz).to(torch.int32), 0, n_f - 2).long()
    wr = tr - i0.to(tr.dtype)
    wz = tz - j0.to(tz.dtype)
    psi_x = ((1 - wz) * ((1 - wr) * psi_f[j0, i0] + wr * psi_f[j0, i0 + 1])
             + wz * ((1 - wr) * psi_f[j0 + 1, i0] + wr * psi_f[j0 + 1, i0 + 1]))

    return AMRPatchResult(psi_fine=psi_f, r_fine=r_f, z_fine=z_f,
                          x_point_r=x_r, x_point_z=x_z, x_point_psi=psi_x,
                          grad_psi_at_x=grad_at)
