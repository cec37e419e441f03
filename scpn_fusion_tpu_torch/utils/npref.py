"""Pure-NumPy reference twins of the stencil/multigrid kernels.

Mirrors the reference framework's dual-backend strategy (every accelerated
path has a NumPy twin used as a parity fixture, ``ARCHITECTURE.md:175-178``):
these implementations follow the reference's NumPy semantics
(``fusion_kernel_iterative_solver.py``, ``multigrid_solve.py``) and are used
by the test-suite to pin the JAX/Pallas kernels' behaviour.  They are NOT on
any hot path.
"""

from __future__ import annotations

import numpy as np


def stencil_coeffs_np(r_1d: np.ndarray, d_r: float, d_z: float):
    r_safe = np.maximum(r_1d, 1e-10)
    a_e = 1.0 / d_r**2 - 1.0 / (2.0 * r_safe * d_r)
    a_w = 1.0 / d_r**2 + 1.0 / (2.0 * r_safe * d_r)
    a_ns = 1.0 / d_z**2
    a_c = 2.0 / d_r**2 + 2.0 / d_z**2
    return a_e, a_w, a_ns, a_c


def jacobi_step_np(psi: np.ndarray, source: np.ndarray, r_1d: np.ndarray,
                   d_r: float, d_z: float) -> np.ndarray:
    a_e, a_w, a_ns, a_c = stencil_coeffs_np(r_1d[1:-1], d_r, d_z)
    out = psi.copy()
    out[1:-1, 1:-1] = (
        a_e[None, :] * psi[1:-1, 2:]
        + a_w[None, :] * psi[1:-1, :-2]
        + a_ns * (psi[:-2, 1:-1] + psi[2:, 1:-1])
        - source[1:-1, 1:-1]
    ) / a_c
    return out


def sor_step_np(psi: np.ndarray, source: np.ndarray, r_1d: np.ndarray,
                d_r: float, d_z: float, omega: float = 1.6) -> np.ndarray:
    """Red-black SOR, sequential-equivalent vectorised (reference semantics)."""
    a_e, a_w, a_ns, a_c = stencil_coeffs_np(r_1d[1:-1], d_r, d_z)
    out = psi.copy()
    nz, nr = psi.shape
    ii, jj = np.mgrid[1:nz - 1, 1:nr - 1]
    for parity in (0, 1):
        mask = ((ii + jj) % 2) == parity
        gs = (
            a_e[None, :] * out[1:-1, 2:]
            + a_w[None, :] * out[1:-1, :-2]
            + a_ns * (out[:-2, 1:-1] + out[2:, 1:-1])
            - source[1:-1, 1:-1]
        ) / a_c
        interior = out[1:-1, 1:-1]
        interior[mask] = (1.0 - omega) * interior[mask] + omega * gs[mask]
        out[1:-1, 1:-1] = interior
    return out


def gs_operator_np(psi: np.ndarray, r_1d: np.ndarray, d_r: float, d_z: float) -> np.ndarray:
    """Discrete GS* operator on interior points (edges zero)."""
    r_safe = np.maximum(r_1d[1:-1], 1e-10)
    d2r = (psi[1:-1, 2:] - 2.0 * psi[1:-1, 1:-1] + psi[1:-1, :-2]) / d_r**2
    d1r = (psi[1:-1, 2:] - psi[1:-1, :-2]) / (2.0 * d_r)
    d2z = (psi[2:, 1:-1] - 2.0 * psi[1:-1, 1:-1] + psi[:-2, 1:-1]) / d_z**2
    out = np.zeros_like(psi)
    out[1:-1, 1:-1] = d2r - d1r / r_safe[None, :] + d2z
    return out


def gs_residual_np(psi: np.ndarray, source: np.ndarray, r_1d: np.ndarray,
                   d_r: float, d_z: float) -> np.ndarray:
    res = source - gs_operator_np(psi, r_1d, d_r, d_z)
    res[0, :] = res[-1, :] = 0.0
    res[:, 0] = res[:, -1] = 0.0
    return res


def restrict_full_weight_np(fine: np.ndarray) -> np.ndarray:
    nz_f, nr_f = fine.shape
    nz_c, nr_c = (nz_f + 1) // 2, (nr_f + 1) // 2
    coarse = np.zeros((nz_c, nr_c), dtype=fine.dtype)
    coarse[1:-1, 1:-1] = (
        4.0 * fine[2:-2:2, 2:-2:2]
        + 2.0 * (fine[1:-3:2, 2:-2:2] + fine[3:-1:2, 2:-2:2]
                 + fine[2:-2:2, 1:-3:2] + fine[2:-2:2, 3:-1:2])
        + (fine[1:-3:2, 1:-3:2] + fine[1:-3:2, 3:-1:2]
           + fine[3:-1:2, 1:-3:2] + fine[3:-1:2, 3:-1:2])
    ) / 16.0
    coarse[0, :] = fine[0, ::2][:nr_c]
    coarse[-1, :] = fine[-1, ::2][:nr_c]
    coarse[:, 0] = fine[::2, 0][:nz_c]
    coarse[:, -1] = fine[::2, -1][:nz_c]
    return coarse


def prolongate_bilinear_np(coarse: np.ndarray, nz_f: int, nr_f: int) -> np.ndarray:
    fine = np.zeros((nz_f, nr_f), dtype=coarse.dtype)
    fine[::2, ::2] = coarse
    fine[::2, 1::2] = 0.5 * (coarse[:, :-1] + coarse[:, 1:])
    fine[1::2, ::2] = 0.5 * (coarse[:-1, :] + coarse[1:, :])
    fine[1::2, 1::2] = 0.25 * (coarse[:-1, :-1] + coarse[1:, :-1]
                               + coarse[:-1, 1:] + coarse[1:, 1:])
    return fine


def smooth_np(psi, source, r_1d, d_r, d_z, omega, n_sweeps):
    for _ in range(n_sweeps):
        psi = sor_step_np(psi, source, r_1d, d_r, d_z, omega)
    return psi


def vcycle_np(psi, source, r_1d, d_r, d_z, omega=1.0, pre=3, post=3,
              min_grid=5, coarse_sweeps=50):
    nz, nr = psi.shape
    if min_grid >= nz or min_grid >= nr:
        return smooth_np(psi, source, r_1d, d_r, d_z, omega, coarse_sweeps)
    psi = smooth_np(psi, source, r_1d, d_r, d_z, omega, pre)
    defect = gs_residual_np(psi, source, r_1d, d_r, d_z)
    d_c = restrict_full_weight_np(defect)
    e_c = vcycle_np(np.zeros_like(d_c), d_c, r_1d[::2], d_r * 2, d_z * 2,
                    omega, pre, post, min_grid, coarse_sweeps)
    psi = psi + prolongate_bilinear_np(e_c, nz, nr)
    return smooth_np(psi, source, r_1d, d_r, d_z, omega, post)


def _anderson_mix_np(psi_hist: list, f_hist: list) -> np.ndarray:
    """Tikhonov-regularised Anderson mixing — NumPy twin of
    ``fixed_boundary._anderson_mix`` (same 1e-10 Tikhonov term, same
    degenerate-weight fallback)."""
    m = len(psi_hist)
    f = np.stack(f_hist)                       # (m, N), oldest..newest
    d_f = f[1:] - f[:-1]
    gram = d_f @ d_f.T
    scale = np.trace(gram) / (m - 1)
    gram = gram + (1e-10 + 1e-8 * scale) * np.eye(m - 1)
    gamma = np.linalg.solve(gram, d_f @ f[-1])
    g_norm = float(np.linalg.norm(gamma))
    if g_norm > 10.0:
        gamma *= 10.0 / g_norm
    # Telescoped type-II AA iterate weights (twin of the JAX fix):
    # y_last - sum_j gamma_j (y_{j+1} - y_j).
    alpha = np.zeros(m)
    alpha[:-1] += gamma
    alpha[1:] -= gamma
    alpha[-1] += 1.0
    s = alpha.sum()
    if abs(s) < 1e-12:
        return psi_hist[-1]
    return (alpha / s) @ np.stack(psi_hist)


def solve_equilibrium_np(
    r_1d: np.ndarray,
    z_1d: np.ndarray,
    psi_bc: np.ndarray,
    i_target: float,
    *,
    mu0: float = 1.0,
    max_iter: int = 600,
    tol: float = 1e-4,
    alpha: float = 0.1,
    anderson_m: int = 0,
    psi0: np.ndarray | None = None,
) -> dict:
    """NumPy twin of the full Picard + multigrid equilibrium solve (L-mode).

    Same algorithm and constants as the JAX solver in
    ``models/equilibrium/fixed_boundary.py`` — used as the performance and
    parity comparator (the reference's NumPy lane,
    ``fusion_kernel_newton_solver.py:390-615`` with method="multigrid").

    ``anderson_m > 0`` enables the same Anderson acceleration over the
    V-cycle as the JAX ``anderson_mg`` method (depth-``anderson_m`` history,
    mix every 3rd iteration once >= 3 iterates are banked) — so the
    headline bench can compare algorithm-matched lanes (ADVICE r2 medium).
    """
    nr, nz = len(r_1d), len(z_1d)
    d_r = float(r_1d[1] - r_1d[0])
    d_z = float(z_1d[1] - z_1d[0])
    rr, zz = np.meshgrid(r_1d, z_1d)
    if psi0 is not None:
        # Warm start (FMG cascade / previous-shot reuse): take the
        # supplied interior, re-impose the Dirichlet boundary, skip the
        # Gaussian seed phase — same semantics as the JAX solver's
        # preserve_initial_state path.
        psi = psi0.astype(np.float64).copy()
        psi[0, :], psi[-1, :] = psi_bc[0, :], psi_bc[-1, :]
        psi[:, 0], psi[:, -1] = psi_bc[:, 0], psi_bc[:, -1]
    else:
        psi = psi_bc.copy()

        # Seed plasma: normalised Gaussian + 50 Jacobi sweeps
        r_center = 0.5 * (r_1d[0] + r_1d[-1])
        j_seed = np.exp(-((rr - r_center) ** 2 + zz**2) / 2.0)
        j_seed *= i_target / max(j_seed.sum() * d_r * d_z, 1e-30)
        seed_src = -mu0 * rr * j_seed
        for _ in range(50):
            psi = jacobi_step_np(psi, seed_src, r_1d, d_r, d_z)

    z_min = float(z_1d[0])
    divertor = zz < (z_min * 0.5)
    converged = False
    iters = 0
    diff = np.inf
    psi_hist: list = []
    f_hist: list = []
    for k in range(max_iter):
        iters = k + 1
        psi_axis = psi.max()
        if abs(psi_axis) < 1e-6:
            psi_axis = 1e-6
        dpsi_dz, dpsi_dr = np.gradient(psi, d_z, d_r)
        b_mag = np.hypot(dpsi_dr, dpsi_dz)
        masked = np.where(divertor, b_mag, np.inf)
        iz, ir = np.unravel_index(np.argmin(masked), psi.shape)
        psi_b = psi[iz, ir]
        if abs(psi_axis - psi_b) < 0.1:
            psi_b = 0.1 * psi_axis

        denom = psi_b - psi_axis
        if abs(denom) < 1e-9:
            denom = 1e-9
        psi_n = (psi - psi_axis) / denom
        inside = (psi_n >= 0) & (psi_n < 1.0)
        prof = np.where(inside, 1.0 - psi_n, 0.0)
        j_raw = 0.5 * rr * prof + 0.5 * prof / (mu0 * rr)
        i_cur = j_raw.sum() * d_r * d_z
        j_phi = j_raw * (i_target / i_cur) if abs(i_cur) > 1e-9 else np.zeros_like(psi)

        source = -mu0 * rr * j_phi
        psi_new = vcycle_np(psi.copy(), source, r_1d, d_r, d_z)
        psi_new[0, :] = psi_bc[0, :]
        psi_new[-1, :] = psi_bc[-1, :]
        psi_new[:, 0] = psi_bc[:, 0]
        psi_new[:, -1] = psi_bc[:, -1]

        diff = float(np.mean(np.abs(psi_new - psi)))
        psi_relaxed = (1.0 - alpha) * psi + alpha * psi_new
        if anderson_m > 0:
            psi_hist.append(psi_relaxed.reshape(-1).copy())
            # Undamped fixed-point residual (twin of the JAX fix; the old
            # psi_new - psi_relaxed vanishes at alpha = 1).
            f_hist.append((psi_new - psi).reshape(-1).copy())
            if len(psi_hist) > anderson_m:
                psi_hist.pop(0)
                f_hist.pop(0)
            if len(psi_hist) >= 3 and k % 3 == 0:
                psi = _anderson_mix_np(psi_hist, f_hist).reshape(psi.shape)
                psi[0, :] = psi_bc[0, :]
                psi[-1, :] = psi_bc[-1, :]
                psi[:, 0] = psi_bc[:, 0]
                psi[:, -1] = psi_bc[:, -1]
            else:
                psi = psi_relaxed
        else:
            psi = psi_relaxed
        if diff < tol:
            converged = True
            break

    return {"psi": psi, "converged": converged, "iterations": iters,
            "residual": diff}
