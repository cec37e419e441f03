"""VMEC-lite: fixed-boundary spectral 3D equilibrium relaxation (port of
``scpn_fusion_tpu/models/equilibrium/vmec_lite.py``).

(R_mn, Z_mn) Fourier coefficients on a radial s-grid relax under radial
curvature tension with a q^2 dp/ds Shafranov-shift drive on the (0,0) mode,
fixed boundary, adaptive residual-monotone steps (a ladder of 10 halved
trial steps an iteration).  The JAX ``lax.while_loop`` is a Python loop
under ``torch.no_grad`` with one host read of the convergence flag an
iteration; ``differentiable=True`` runs exactly ``max_iter`` iterations with
the autograd graph kept across them (the JAX ``fori_loop``), so gradients
flow to the boundary shape and the profiles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.grid import linspace
from scpn_fusion_tpu_torch.models.equilibrium.topology import gradient


@dataclasses.dataclass(frozen=True)
class SpectralBasis:
    """Fourier basis over (m, n) mode pairs (static layout)."""

    m_pol: int = 3
    n_tor: int = 2
    n_fp: int = 1

    @property
    def mn_modes(self) -> tuple:
        modes = []
        for m in range(self.m_pol + 1):
            n_min = -self.n_tor if m > 0 else 0
            for n in range(n_min, self.n_tor + 1):
                modes.append((m, n))
        return tuple(modes)

    @property
    def n_modes(self) -> int:
        return len(self.mn_modes)

    def mode_index(self, m: int, n: int) -> int:
        return self.mn_modes.index((m, n))

    def evaluate(self, coeffs: torch.Tensor, theta: torch.Tensor, zeta: torch.Tensor,
                 is_sin: bool = False) -> torch.Tensor:
        """Evaluate sum_mn c_mn {cos|sin}(m theta - n n_fp zeta)."""
        m = torch.tensor([mm for mm, _ in self.mn_modes], dtype=coeffs.dtype,
                         device=coeffs.device)
        n = torch.tensor([nn for _, nn in self.mn_modes], dtype=coeffs.dtype,
                         device=coeffs.device)
        angle = (m[:, None] * theta.reshape(-1)[None, :]
                 - self.n_fp * n[:, None] * zeta.reshape(-1)[None, :])
        basis = torch.sin(angle) if is_sin else torch.cos(angle)
        return (coeffs @ basis).reshape(theta.shape)


class VMECResult(NamedTuple):
    """``iterations`` is a host value."""

    r_mn: torch.Tensor      # (n_s, n_modes)
    z_mn: torch.Tensor
    b_mn: torch.Tensor
    residual: torch.Tensor
    iterations: int
    converged: torch.Tensor


def tokamak_boundary(r0: float, a: float, kappa: float, delta: float, basis: SpectralBasis,
                     *, dtype: torch.dtype = torch.float64,
                     device: torch.device | str = "cuda"):
    """Low-order Fourier boundary for a shaped axisymmetric tokamak, on
    ``device``."""
    r_b = {(0, 0): r0, (1, 0): a, (2, 0): -delta * a / 2.0}
    z_b = {(1, 0): kappa * a}
    r_vec = np.zeros(basis.n_modes)
    z_vec = np.zeros(basis.n_modes)
    for (m, n), v in r_b.items():
        if (m, n) in basis.mn_modes:
            r_vec[basis.mode_index(m, n)] = v
    for (m, n), v in z_b.items():
        if (m, n) in basis.mn_modes:
            z_vec[basis.mode_index(m, n)] = v
    return (torch.as_tensor(r_vec, dtype=dtype).to(device),
            torch.as_tensor(z_vec, dtype=dtype).to(device))


def _interior_add(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x.at[1:-1].add(delta)``, out of place."""
    return torch.cat([x[:1], x[1:-1] + delta, x[-1:]])


def solve_vmec_lite(
    basis: SpectralBasis,
    r_boundary: torch.Tensor,   # (n_modes,)
    z_boundary: torch.Tensor,
    pressure: torch.Tensor,     # (n_s,)
    iota: torch.Tensor,         # (n_s,)
    *,
    n_s: int = 21,
    max_iter: int = 100,
    tol: float = 1e-4,
    differentiable: bool = False,
) -> VMECResult:
    """Spectral steepest-descent relaxation on the boundary's device.

    ``differentiable=True`` runs a fixed ``max_iter`` iterations (no early
    exit) and keeps the graph, so autograd flows through the solve.
    """
    dtype, device = r_boundary.dtype, r_boundary.device
    s_grid = linspace(0.0, 1.0, n_s, dtype, device)
    idx_00 = basis.mode_index(0, 0)
    m_arr = torch.tensor([m for m, _ in basis.mn_modes], dtype=dtype, device=device)
    col_00 = torch.arange(basis.n_modes, device=device) == idx_00

    # Initial guess: s^(m/2) interpolation from axis to boundary; (0,0)
    # mode constant at the boundary major radius.
    shape = s_grid[:, None] ** (m_arr[None, :] / 2.0)
    r_mn = torch.where(col_00, r_boundary[idx_00], shape * r_boundary[None, :])
    z_mn = torch.where(col_00, torch.zeros((), dtype=dtype, device=device),
                       shape * z_boundary[None, :])

    ds = s_grid[1] - s_grid[0]
    dp_ds_full = gradient(pressure, 1.0, 0) / ds
    q_prof = 1.0 / torch.clamp(iota.abs(), min=0.01)
    r00_bound = torch.clamp(r_boundary[idx_00].abs(), min=1e-3)

    def forces(r, z):
        lap_r = (r[2:] - 2.0 * r[1:-1] + r[:-2]) * 2.0
        lap_z = (z[2:] - 2.0 * z[1:-1] + z[:-2]) * 2.0
        shaf = q_prof[1:-1] ** 2 * dp_ds_full[1:-1] / r00_bound * 1e-6
        lap_r = torch.where(col_00, lap_r + (-shaf)[:, None], lap_r)
        zero_row = torch.zeros_like(r[:1])
        f_r = torch.cat([zero_row, lap_r, zero_row])
        f_z = torch.cat([zero_row, lap_z, zero_row])
        res = f_r.abs().max() + f_z.abs().max()
        return f_r, f_z, res

    def body(r, z, lr):
        f_r, f_z, res = forces(r, z)
        step = lr
        accepted = torch.zeros((), dtype=torch.bool, device=device)
        best_r, best_z = r, z
        zero = torch.zeros((), dtype=dtype, device=device)
        for _ in range(10):
            trial = torch.where(accepted, zero, step)
            r_try = _interior_add(r, trial * f_r[1:-1])
            z_try = _interior_add(z, trial * f_z[1:-1])
            _, _, res_try = forces(r_try, z_try)
            ok = (~accepted) & torch.isfinite(res_try) & (res_try <= res)
            best_r = torch.where(ok, r_try, best_r)
            best_z = torch.where(ok, z_try, best_z)
            step = step * 0.5
            accepted = accepted | ok
        lr = torch.where(accepted, torch.clamp(lr * 1.1, max=0.2), lr * 0.5)
        return best_r, best_z, lr, res, res < tol

    lr = torch.full((), 0.1, dtype=dtype, device=device)
    residual = torch.full((), 1e30, dtype=dtype, device=device)
    converged = torch.zeros((), dtype=torch.bool, device=device)
    k = 0
    with contextlib.nullcontext() if differentiable else torch.no_grad():
        while k < max_iter and (differentiable or not bool(converged)):
            r_mn, z_mn, lr, residual, converged = body(r_mn, z_mn, lr)
            k += 1

    # B-field spectral estimate (1/R toroidal + iota poloidal shaping).
    r00_s = torch.clamp(r_mn[:, idx_00].abs(), min=1e-6)
    b_mn = -r_mn / r00_s[:, None]
    b_mn = b_mn + torch.where((m_arr == 1.0)[None, :],
                              iota[:, None] * z_mn.abs() / r00_s[:, None],
                              torch.zeros((), dtype=dtype, device=device))
    b_mn = torch.where(col_00, torch.ones((), dtype=dtype, device=device), b_mn)
    return VMECResult(r_mn, z_mn, b_mn, residual, k, converged)


def flux_surface_rz(basis: SpectralBasis, result: VMECResult, s_index: int,
                    n_theta: int = 64, zeta: float = 0.0):
    """Evaluate one flux surface (R, Z)(theta) at fixed toroidal angle."""
    like = result.r_mn
    theta = linspace(0.0, 2.0 * math.pi, n_theta, like.dtype, like.device)
    zeta_arr = torch.full_like(theta, zeta)
    r = basis.evaluate(result.r_mn[s_index], theta, zeta_arr, is_sin=False)
    z = basis.evaluate(result.z_mn[s_index], theta, zeta_arr, is_sin=True)
    return r, z
