"""Magnetic topology extraction: O-point (axis), X-point, B-field (port of
``scpn_fusion_tpu/models/equilibrium/topology.py``).

Gradients follow ``jnp.gradient``: central differences inside, one-sided at
the edges, ``(f[i+1] - f[i-1]) * 0.5 / h``.  The spacing divides as a 0-dim
tensor on the field's device, so every device rounds the quotient the same
way (PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal instead).  |grad psi| is ``sqrt(a*a + b*b)``, not ``hypot``, and
argmax/argmin take the first row-major extremum, as in the JAX package.
The soft (differentiable) variants are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Topology(NamedTuple):
    psi_axis: torch.Tensor      # flux at magnetic axis (O-point)
    psi_boundary: torch.Tensor  # flux at X-point / separatrix
    axis_iz: torch.Tensor
    axis_ir: torch.Tensor
    x_iz: torch.Tensor
    x_ir: torch.Tensor


def gradient(psi: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """``jnp.gradient(psi, h, axis=dim)`` for a uniform spacing ``h``."""
    h_t = torch.full((), h, dtype=psi.dtype, device=psi.device)
    f = psi.movedim(dim, 0)
    inner = (f[2:] - f[:-2]) * 0.5 / h_t
    lo = (f[1:2] - f[0:1]) / h_t
    hi = (f[-1:] - f[-2:-1]) / h_t
    return torch.cat([lo, inner, hi], 0).movedim(0, dim)


def grad_magnitude(psi: torch.Tensor, d_r: float, d_z: float) -> torch.Tensor:
    """|grad psi| as ``sqrt(dR^2 + dZ^2)`` (the X-point search metric)."""
    dpsi_dz = gradient(psi, d_z, 0)
    dpsi_dr = gradient(psi, d_r, 1)
    return torch.sqrt(dpsi_dr * dpsi_dr + dpsi_dz * dpsi_dz)


def find_magnetic_axis(psi: torch.Tensor):
    """O-point as the global psi maximum; |psi_axis| is floored at 1e-6.

    Returns (iz, ir, psi_axis)."""
    idx = torch.argmax(psi)
    nr = psi.shape[1]
    psi_axis = psi.reshape(-1)[idx]
    psi_axis = torch.where(psi_axis.abs() < 1e-6, torch.full_like(psi_axis, 1e-6), psi_axis)
    return idx // nr, idx % nr, psi_axis


def find_x_point(psi: torch.Tensor, zz: torch.Tensor, d_r: float, d_z: float, z_min: float):
    """X-point as the minimum-|grad psi| point in the divertor region
    ``ZZ < Z_min/2``; the global psi minimum when that region is empty.

    Returns (iz, ir, psi_x)."""
    b_mag = grad_magnitude(psi, d_r, d_z)
    mask = zz < (z_min * 0.5)
    masked_b = torch.where(mask, b_mag, torch.full_like(b_mag, float("inf")))
    idx = torch.argmin(masked_b)
    nr = psi.shape[1]
    psi_x = psi.reshape(-1)[idx]
    psi_out = torch.where(mask.any(), psi_x, psi.min())
    return idx // nr, idx % nr, psi_out


def analyze_topology(psi: torch.Tensor, zz: torch.Tensor, d_r: float, d_z: float,
                     z_min: float) -> Topology:
    """Axis + X-point, with the degeneracy guard: when
    |psi_axis - psi_boundary| < 0.1 the boundary flux snaps to
    ``0.1 * psi_axis``."""
    axis_iz, axis_ir, psi_axis = find_magnetic_axis(psi)
    x_iz, x_ir, psi_b = find_x_point(psi, zz, d_r, d_z, z_min)
    psi_b = torch.where((psi_axis - psi_b).abs() < 0.1, psi_axis * 0.1, psi_b)
    return Topology(psi_axis, psi_b, axis_iz, axis_ir, x_iz, x_ir)


def compute_b_field(psi: torch.Tensor, rr: torch.Tensor, d_r: float, d_z: float):
    """Poloidal field components B_R = -(1/R) dpsi/dZ, B_Z = (1/R) dpsi/dR."""
    dpsi_dz = gradient(psi, d_z, 0)
    dpsi_dr = gradient(psi, d_r, 1)
    r_safe = torch.clamp(rr, min=1e-6)
    return -dpsi_dz / r_safe, dpsi_dr / r_safe
