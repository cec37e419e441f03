"""Grad-Shafranov elliptic (GS*) stencil operations in plain PyTorch (port of
``scpn_fusion_tpu/ops/stencil.py``).

The toroidal five-point stencil of ``Delta* psi = S`` on a uniform (Z, R)
grid has R-dependent east/west coefficients

    a_E = 1/dR^2 - 1/(2 R dR),   a_W = 1/dR^2 + 1/(2 R dR),
    a_NS = 1/dZ^2,               a_C = 2/dR^2 + 2/dZ^2.

These are the plain ops: the path for f64, for grids the kernels do not
take, and for the solver with kernels off.  Like the JAX module they clip
SOR and Jacobi updates at ``NUMERIC_CAP``; the hand-written kernels
(``ops/cuda_stencil.py``) do not, like the Pallas kernels they replace.
"""

from __future__ import annotations

import functools

import torch

NUMERIC_CAP = 1e12


def stencil_coeffs(r_1d: torch.Tensor, d_r: float, d_z: float):
    """(a_E, a_W, a_NS, a_C): 1D east/west rows over R, scalar a_NS/a_C."""
    r_safe = torch.clamp(r_1d, min=1e-10)
    inv_dr2 = 1.0 / (d_r * d_r)
    a_e = inv_dr2 - 1.0 / (2.0 * r_safe * d_r)
    a_w = inv_dr2 + 1.0 / (2.0 * r_safe * d_r)
    a_ns = 1.0 / (d_z * d_z)
    a_c = 2.0 * inv_dr2 + 2.0 / (d_z * d_z)
    return a_e, a_w, a_ns, a_c


def _neighbour_sum(psi: torch.Tensor, a_e, a_w, a_ns) -> torch.Tensor:
    return (a_e[None, :] * psi[1:-1, 2:] + a_w[None, :] * psi[1:-1, :-2]
            + a_ns * (psi[:-2, 1:-1] + psi[2:, 1:-1]))


def _with_interior(psi: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    out = psi.clone()
    out[1:-1, 1:-1] = interior
    return out


def gs_operator(psi: torch.Tensor, r_1d: torch.Tensor, d_r: float, d_z: float) -> torch.Tensor:
    """The discrete GS* operator on interior points; zero on the ring."""
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    interior = _neighbour_sum(psi, a_e, a_w, a_ns) - a_c * psi[1:-1, 1:-1]
    return _with_interior(torch.zeros_like(psi), interior)


def gs_residual(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                d_r: float, d_z: float) -> torch.Tensor:
    """Residual r = S - L[psi] on interior points (zero on the ring)."""
    res = source - gs_operator(psi, r_1d, d_r, d_z)
    res[0, :] = 0.0
    res[-1, :] = 0.0
    res[:, 0] = 0.0
    res[:, -1] = 0.0
    return res


def gs_residual_rms(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                    d_r: float, d_z: float) -> torch.Tensor:
    """RMS of the interior GS residual (convergence diagnostic)."""
    res = gs_residual(psi, source, r_1d, d_r, d_z)
    n_int = (psi.shape[0] - 2) * (psi.shape[1] - 2)
    return torch.sqrt((res * res).sum() / n_int)


def apply_dirichlet(psi: torch.Tensor, psi_bc: torch.Tensor) -> torch.Tensor:
    """``psi`` with the boundary ring of ``psi_bc`` (a new tensor)."""
    out = psi.clone()
    out[0, :] = psi_bc[0, :]
    out[-1, :] = psi_bc[-1, :]
    out[:, 0] = psi_bc[:, 0]
    out[:, -1] = psi_bc[:, -1]
    return out


def jacobi_step(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                d_r: float, d_z: float) -> torch.Tensor:
    """One undamped Jacobi iteration (boundaries unchanged)."""
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    new = (_neighbour_sum(psi, a_e, a_w, a_ns) - source[1:-1, 1:-1]) / a_c
    return _with_interior(psi, torch.clamp(new, -NUMERIC_CAP, NUMERIC_CAP))


def _interior_parity_mask(shape: tuple[int, int], parity: int, device) -> torch.Tensor:
    """Boolean checkerboard over interior indices: (iz + ir) % 2 == parity."""
    nz, nr = shape
    iz = torch.arange(1, nz - 1, device=device)[:, None]
    ir = torch.arange(1, nr - 1, device=device)[None, :]
    return (iz + ir) % 2 == parity


@functools.lru_cache(maxsize=256)
def _parity_weights(shape: tuple[int, int], parity: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """The checkerboard as 0/1 weights in ``dtype``, built once a level (a
    plain sweep is launch-bound; this saves six launches a half-sweep)."""
    return _interior_parity_mask(shape, parity, device).to(dtype)


def sor_step(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
             d_r: float, d_z: float, omega: float = 1.6) -> torch.Tensor:
    """One red-black SOR sweep (red half-sweep, then black on the updated
    red points), clipped at ``NUMERIC_CAP``."""
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    for parity in (0, 1):
        gs = (_neighbour_sum(psi, a_e, a_w, a_ns) - source[1:-1, 1:-1]) / a_c
        old = psi[1:-1, 1:-1]
        mask = _parity_weights(tuple(psi.shape), parity, psi.device, psi.dtype)
        updated = torch.clamp(old + mask * omega * (gs - old), -NUMERIC_CAP, NUMERIC_CAP)
        psi = _with_interior(psi, updated)
    return psi


def sor_sweeps(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
               d_r: float, d_z: float, omega: float, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` red-black SOR sweeps."""
    for _ in range(n_sweeps):
        psi = sor_step(psi, source, r_1d, d_r, d_z, omega)
    return psi


def jacobi_sweeps(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                  d_r: float, d_z: float, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` Jacobi iterations."""
    for _ in range(n_sweeps):
        psi = jacobi_step(psi, source, r_1d, d_r, d_z)
    return psi
