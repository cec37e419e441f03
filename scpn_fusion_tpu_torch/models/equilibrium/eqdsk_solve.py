"""G-EQDSK-driven fixed-boundary reconstruction (port of
``scpn_fusion_tpu/models/equilibrium/eqdsk_solve.py``).

Given an EFIT G-EQDSK file, rebuild psi on the file's own grid by solving

    Delta* psi = -mu0 R J_phi,   J_phi = R p'(psi_N) + FF'(psi_N) / (mu0 R)

with p' and FF' sampled from the file (linear interpolation on the uniform
psi_N grid), the Dirichlet ring from the file's psirz, and the plasma current
renormalised to the file's Ip; ``MU0`` is the SI value.  The span-relative
RMSE against the file's psirz is the reconstruction metric.

The JAX ``lax.while_loop`` is a Python loop with one host read of the mean
update an iteration.  Each iteration runs ``n_inner_cycles`` multigrid
V-cycles at (3, 3) smoothing; on a CUDA device in float32 a square 2^k+1
grid up to 257^2 (the SPARC file's 129 x 129) takes each as one launch of
the fused V-cycle kernel (``ops/cuda_mg.fused_coarse_vcycle``).  The source
is the file's sampled profiles in plain ops, not the fused source kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.io.geqdsk import GEqdsk
from scpn_fusion_tpu_torch.models.equilibrium.fixed_boundary import _as_dtype
from scpn_fusion_tpu_torch.ops.multigrid import _vcycle_impl
from scpn_fusion_tpu_torch.ops.stencil import apply_dirichlet

MU0 = 4.0e-7 * np.pi


class EqdskSolveResult(NamedTuple):
    """``converged`` and ``iterations`` are host values."""

    psi: torch.Tensor
    j_phi: torch.Tensor
    converged: bool
    iterations: int
    residual: torch.Tensor
    span_rel_rmse: torch.Tensor       # vs the file's psirz, full domain
    span_rel_rmse_core: torch.Tensor  # psi_N <= 0.95 region only


def _sampled_profile(psi_n: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a profile sampled on uniform psi_N in [0, 1]."""
    n = table.shape[0]
    x = torch.clamp(psi_n, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(x.to(torch.int64), 0, n - 2)
    frac = x - i0
    return table[i0] * (1.0 - frac) + table[i0 + 1] * frac


def _solve_eqdsk_impl(
    grid: Grid,
    psi_ref: torch.Tensor,
    pprime: torch.Tensor,
    ffprime: torch.Tensor,
    i_target: torch.Tensor,
    sibry: torch.Tensor,
    alpha: float,
    tol: float,
    *,
    max_iter: int,
    n_inner_cycles: int,
    use_pallas: bool,
) -> EqdskSolveResult:
    """The Picard loop on ``psi_ref``'s device and dtype; ``alpha`` and
    ``tol`` are Python floats already rounded to that dtype."""
    r_1d = grid.R
    rr = r_1d[None, :].expand(grid.NZ, grid.NR)
    d_r, d_z = grid.dR, grid.dZ

    def source_from(psi: torch.Tensor) -> torch.Tensor:
        # the axis flux tracks the solution; the LCFS flux is the file's sibry
        psi_axis = psi.max()
        denom = sibry - psi_axis
        denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        psi_n = (psi - psi_axis) / denom
        inside = (psi_n >= 0.0) & (psi_n < 1.0)
        pp = _sampled_profile(psi_n, pprime)
        ffp = _sampled_profile(psi_n, ffprime)
        j_phi = torch.where(inside, rr * pp + ffp / (MU0 * rr), torch.zeros_like(psi))
        i_cur = j_phi.sum() * d_r * d_z
        scale = torch.where(i_cur.abs() > 1e-12, i_target / i_cur, torch.zeros_like(i_cur))
        return j_phi * scale

    psi = psi_ref   # the Dirichlet ring comes from the file itself
    k, diff, converged = 0, 1e30, False
    diff_t = torch.full((), diff, dtype=psi.dtype, device=psi.device)
    while k < max_iter and not converged and math.isfinite(diff):
        src = -MU0 * rr * source_from(psi)
        psi_new = psi
        for _ in range(n_inner_cycles):
            psi_new = _vcycle_impl(psi_new, src, r_1d, d_r, d_z, 1.0, 3, 3, 5, 50, use_pallas)
        psi_new = apply_dirichlet(psi_new, psi_ref)
        diff_t = (psi_new - psi).abs().mean()
        psi = (1.0 - alpha) * psi + alpha * psi_new
        diff = diff_t.item()     # the one host read of the iteration
        converged = diff < tol
        k += 1

    j_phi = source_from(psi)
    span = psi_ref.max() - psi_ref.min()
    err = psi - psi_ref
    rmse = torch.sqrt((err**2).mean()) / span

    psi_axis = psi_ref.max()
    denom = sibry - psi_axis
    psi_n_ref = (psi_ref - psi_axis) / torch.where(denom.abs() < 1e-12,
                                                   torch.full_like(denom, 1e-12), denom)
    core = psi_n_ref <= 0.95
    n_core = torch.clamp(core.sum(), min=1)
    rmse_core = torch.sqrt(torch.where(core, err**2, torch.zeros_like(err)).sum() / n_core) / span
    return EqdskSolveResult(psi=psi, j_phi=j_phi, converged=converged, iterations=k,
                            residual=diff_t, span_rel_rmse=rmse, span_rel_rmse_core=rmse_core)


def _eqdsk_problem(eq: GEqdsk, alpha: float, tol: float | None, dtype: torch.dtype,
                   device: torch.device) -> tuple:
    """The positional arguments of ``_solve_eqdsk_impl`` for ``eq`` on
    ``device`` in ``dtype``; ``tol`` defaults to 1e-5 of the file's psi
    span."""
    grid = Grid.from_bounds(eq.nw, eq.nh, eq.rleft, eq.rleft + eq.rdim,
                            eq.zmid - eq.zdim / 2, eq.zmid + eq.zdim / 2,
                            dtype=dtype, device=device)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dtype=dtype, device=device)

    if tol is None:
        tol = 1e-5 * float(eq.psirz.max() - eq.psirz.min())
    return (grid, t(eq.psirz), t(eq.pprime), t(eq.ffprime), t(eq.current), t(eq.sibry),
            _as_dtype(alpha, dtype), _as_dtype(tol, dtype))


def solve_from_geqdsk(
    eq: GEqdsk,
    *,
    max_iter: int = 300,
    alpha: float = 0.1,
    tol: float | None = None,
    n_inner_cycles: int = 1,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> EqdskSolveResult:
    """Reconstruct the equilibrium of a G-EQDSK file on its own grid, on
    ``device`` in ``dtype`` (the JAX entry point's default dtype depends on
    x64; here it is explicit).  ``tol`` defaults to 1e-5 of the file's psi
    span.  The hand-written kernels run on a CUDA device in float32, as the
    JAX entry point runs its Pallas kernels on a TPU."""
    device = torch.device(device)
    use_pallas = device.type == "cuda" and dtype == torch.float32
    return _solve_eqdsk_impl(*_eqdsk_problem(eq, alpha, tol, dtype, device),
                             max_iter=max_iter, n_inner_cycles=n_inner_cycles,
                             use_pallas=use_pallas)
