"""Geometric multigrid for the GS* operator (port of
``scpn_fusion_tpu/ops/multigrid.py``).

The level hierarchy follows the JAX module: ``n_c = (n_f + 1) // 2``,
full-weighting restriction, bilinear prolongation, red-black SOR smoothing,
coarse-grid right-hand side ``source - L[psi]`` with the correction added.
Levels are plain strided slices; the TPU layout helpers of the JAX module
(``_downsample_even``, ``downsample_even_mxu``, ``upsample_even_mxu``) have
no counterpart.

Kernel dispatch copies the JAX module with the CUDA kernels in place of the
Pallas ones (``use_pallas`` means "use the hand-written kernels"):

* a square 2^k+1 level up to 257^2 runs the whole sub-cycle through
  ``ops/cuda_mg.fused_coarse_vcycle``;
* a square 2^k+1 level above 257^2 up to 513^2 runs its smoothing and
  transfer legs through ``fine_presmooth_restrict`` / ``fine_prolong_smooth``;
* square 2^k+1 levels from 1025^2 to 4097^2 have no kernel route yet and
  raise ``NotImplementedError`` (ROADMAP Queue 2, the tiled pair 6 and 7);
* any other level runs the plain ops here, with its smoothing through
  ``ops/cuda_stencil.sor_sweeps``, as the JAX module runs XLA ops there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scpn_fusion_tpu_torch.ops.cuda_mg import is_pow2_plus1_square
from scpn_fusion_tpu_torch.ops.stencil import gs_residual, sor_step


def restrict_full_weight(fine: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction (fine -> coarse, 9-point stencil), with
    the boundary ring injected.  Coarse shape ``((nz+1)//2, (nr+1)//2)``."""
    nz_f, nr_f = fine.shape
    nz_c, nr_c = (nz_f + 1) // 2, (nr_f + 1) // 2
    fp = F.pad(fine[None, None], (1, 1, 1, 1))[0, 0]

    def at(di: int, dj: int) -> torch.Tensor:
        # fine[2I + di, 2J + dj] (zero outside), as a coarse-shaped tensor
        return fp[1 + di:1 + di + 2 * nz_c - 1:2, 1 + dj:1 + dj + 2 * nr_c - 1:2]

    weighted = (4.0 * at(0, 0) + 2.0 * (at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1))
                + (at(1, 1) + at(1, -1) + at(-1, 1) + at(-1, -1))) / 16.0
    out = fine[0:2 * nz_c - 1:2, 0:2 * nr_c - 1:2].clone()
    out[1:-1, 1:-1] = weighted[1:-1, 1:-1]
    return out


def prolongate_bilinear(coarse: torch.Tensor, nz_f: int, nr_f: int) -> torch.Tensor:
    """Bilinear prolongation (coarse -> fine) for 2^k+1-compatible grids."""
    c = coarse
    c_r = F.pad(c[:, 1:], (0, 1))
    c_d = F.pad(c[1:, :], (0, 0, 0, 1))
    c_dr = F.pad(c[1:, 1:], (0, 1, 0, 1))
    fine = torch.empty((2 * c.shape[0], 2 * c.shape[1]), dtype=c.dtype, device=c.device)
    fine[0::2, 0::2] = c
    fine[0::2, 1::2] = 0.5 * (c + c_r)
    fine[1::2, 0::2] = 0.5 * (c + c_d)
    fine[1::2, 1::2] = 0.25 * (c + c_r + c_d + c_dr)
    return fine[:nz_f, :nr_f]


def smooth(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, d_r: float,
           d_z: float, omega: float, n_sweeps: int, use_pallas: bool = False) -> torch.Tensor:
    """Red-black SOR smoother: ``n_sweeps`` full sweeps (the SOR kernel's
    wrapper with ``use_pallas``, the clipped plain sweep otherwise)."""
    if use_pallas:
        from scpn_fusion_tpu_torch.ops.cuda_stencil import sor_sweeps
        return sor_sweeps(psi, source, r_1d, d_r, d_z, omega, n_sweeps)
    for _ in range(n_sweeps):
        psi = sor_step(psi, source, r_1d, d_r, d_z, omega)
    return psi


def _vcycle_impl(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, d_r: float,
                 d_z: float, omega: float, pre_smooth: int, post_smooth: int, min_grid: int,
                 coarse_sweeps: int, use_pallas: bool = False) -> torch.Tensor:
    nz, nr = psi.shape
    if min_grid >= nz or min_grid >= nr:
        return smooth(psi, source, r_1d, d_r, d_z, omega, coarse_sweeps, use_pallas)

    if use_pallas and is_pow2_plus1_square(psi.shape):
        from scpn_fusion_tpu_torch.ops import cuda_mg
        if nz <= 257:
            return cuda_mg.fused_coarse_vcycle(
                psi, source, r_1d, d_r, d_z, omega, pre_smooth=pre_smooth,
                post_smooth=post_smooth, min_grid=min_grid, coarse_sweeps=coarse_sweeps)
        if nz <= 513:
            psi_s, d_coarse = cuda_mg.fine_presmooth_restrict(
                psi, source, r_1d, d_r, d_z, omega, pre_smooth=pre_smooth)
            e_coarse = _vcycle_impl(torch.zeros_like(d_coarse), d_coarse, r_1d[::2],
                                    d_r * 2.0, d_z * 2.0, omega, pre_smooth, post_smooth,
                                    min_grid, coarse_sweeps, use_pallas)
            return cuda_mg.fine_prolong_smooth(psi_s, source, e_coarse, r_1d, d_r, d_z,
                                               omega, post_smooth=post_smooth)
        if nz <= 4097:
            raise NotImplementedError(
                f"no CUDA kernel route for a {nz}^2 level yet: the tiled fine legs "
                "(ROADMAP Queue 2, kernels 6 and 7) are still to be ported")

    psi = smooth(psi, source, r_1d, d_r, d_z, omega, pre_smooth, use_pallas)
    d_coarse = restrict_full_weight(gs_residual(psi, source, r_1d, d_r, d_z))
    e_coarse = _vcycle_impl(torch.zeros_like(d_coarse), d_coarse, r_1d[::2], d_r * 2.0,
                            d_z * 2.0, omega, pre_smooth, post_smooth, min_grid,
                            coarse_sweeps, use_pallas)
    psi = psi + prolongate_bilinear(e_coarse, nz, nr)
    return smooth(psi, source, r_1d, d_r, d_z, omega, post_smooth, use_pallas)


def vcycle(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, d_r: float,
           d_z: float, *, omega: float = 1.0, pre_smooth: int = 3, post_smooth: int = 3,
           min_grid: int = 5, coarse_sweeps: int = 50, use_pallas: bool = False) -> torch.Tensor:
    """One geometric-multigrid V-cycle for ``Delta* psi = source``; the
    Dirichlet values of ``psi`` are preserved exactly."""
    return _vcycle_impl(psi, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                        min_grid, coarse_sweeps, use_pallas)


def mg_solve(psi0: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, d_r: float,
             d_z: float, *, n_cycles: int = 20, omega: float = 1.0, pre_smooth: int = 3,
             post_smooth: int = 3, min_grid: int = 5, use_pallas: bool = False) -> torch.Tensor:
    """``n_cycles`` V-cycles (standalone converged MG solve)."""
    p = psi0
    for _ in range(n_cycles):
        p = _vcycle_impl(p, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                         min_grid, 50, use_pallas)
    return p
