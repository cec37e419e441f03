"""Vessel eddy-current circuits + RZIP rigid-plasma vertical response (port
of ``scpn_fusion_tpu/control/vessel_rzip.py``).

* Vessel: toroidal filaments as a struct-of-arrays circuit
  M dI/dt + R I = -dPhi_ext/dt, advanced by one backward-Euler solve per
  step; the O(n^2) mutual-inductance assembly is one broadcast over the
  filament arrays.
* RZIP: rigid vertical-displacement state space x = [Z, dZ/dt, I_1..I_n],
  destabilising force K = n mu0 Ip^2/(4 pi R0), with the plasma-filament
  coupling dM/dz from ``torch.func.vmap(torch.func.grad(...))`` of the
  analytic mutual inductance (JAX's ``vmap(grad(...))``).
* VerticalStabilityAnalysis: midplane n-index from psi, passive margin,
  additive-lag feedback-gain sizing.
* LQR voltage controller: gain from the shared CARE integrator
  (``control/hinf.solve_care_ode``).

Growth rates and closed-loop eigenvalues use host NumPy ``eigvals`` on the
tiny (n+2) matrices, as the JAX module does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.control.hinf import _mv, _t, solve_care_ode
from scpn_fusion_tpu_torch.core.special import ellipe, ellipk

MU_0 = 4.0e-7 * math.pi


class Vessel(NamedTuple):
    """Struct-of-arrays toroidal filament set (wall and/or active coils)."""

    r: torch.Tensor           # (n,) filament major radius [m]
    z: torch.Tensor           # (n,)
    resistance: torch.Tensor  # (n,) loop resistance [Ohm]
    inductance: torch.Tensor  # (n,) self-inductance [H]


def _as_tensors(*xs):
    """Tensors of the first tensor's dtype and device (float64 on the CPU for
    plain numbers, as Python computes them)."""
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    kw = (dict(dtype=ref.dtype, device=ref.device) if ref is not None
          else dict(dtype=torch.float64, device="cpu"))
    return [x if isinstance(x, torch.Tensor) else torch.as_tensor(x, **kw) for x in xs]


def mutual_inductance(r1, z1, r2, z2):
    """Mutual inductance of two coaxial toroidal loops,
    M = mu0 sqrt(R1 R2) [(2 - k^2) K - 2 E] / k  (broadcasts; smooth in z
    so autograd gives exact dM/dz)."""
    r1, z1, r2, z2 = _as_tensors(r1, z1, r2, z2)
    denom = (r1 + r2) ** 2 + (z1 - z2) ** 2
    k2 = torch.clamp(4.0 * r1 * r2 / torch.clamp(denom, min=1e-30), 1e-9, 0.999999)
    return (MU_0 * torch.sqrt(r1 * r2)
            * ((2.0 - k2) * ellipk(k2) - 2.0 * ellipe(k2)) / torch.sqrt(k2))


def mutual_matrix(v: Vessel) -> torch.Tensor:
    """(n, n) circuit inductance matrix: pairwise mutuals, self on diagonal."""
    m = mutual_inductance(v.r[:, None], v.z[:, None], v.r[None, :], v.z[None, :])
    n = v.r.shape[0]
    eye = torch.eye(n, dtype=v.r.dtype, device=v.r.device)
    return m * (1.0 - eye) + torch.diag(v.inductance)


def vessel_step(v: Vessel, currents: torch.Tensor, dphi_ext_dt: torch.Tensor,
                dt) -> torch.Tensor:
    """Backward-Euler circuit step: (M + dt R) I' = M I - dt dPhi_ext/dt."""
    m = mutual_matrix(v)
    lhs = m + dt * torch.diag(v.resistance)
    rhs = _mv(m, currents) - dt * dphi_ext_dt
    return torch.linalg.solve(lhs, rhs)


def psi_vessel(v: Vessel, currents: torch.Tensor, r_obs: torch.Tensor,
               z_obs: torch.Tensor) -> torch.Tensor:
    """Poloidal flux at observation points from the filament currents
    (Green contraction; flux per rad = M/(2 pi) * I)."""
    shape = r_obs.shape
    rf = r_obs.reshape(-1)
    zf = z_obs.reshape(-1)
    g = mutual_inductance(rf[:, None], zf[:, None], v.r[None, :], v.z[None, :]) / (2.0 * math.pi)
    return _mv(g, currents).reshape(shape)


class RZIPStateSpace(NamedTuple):
    a: torch.Tensor   # (2+n, 2+n)
    b: torch.Tensor   # (2+n, n_coils)
    c: torch.Tensor   # (1, 2+n)
    d: torch.Tensor   # (1, n_coils)


def build_rzip_state_space(wall_and_coils: Vessel, *, n_wall: int, r0, ip_ma, n_index,
                           m_eff=1.0) -> RZIPStateSpace:
    """Continuous-time rigid vertical-motion model (reference
    ``RZIPModel.build_state_space``), assembled without per-circuit loops;
    ``r0``, ``ip_ma``, ``n_index`` and ``m_eff`` may be numbers or 0-d
    tensors (as JAX traces them, in the vessel's dtype).

    dZ'/dt = (-K Z + sum_k C_k I_k)/m_eff,   K = n mu0 Ip^2/(4 pi R0)
    M dI/dt = V - R I - C dZ/dt,             C_k = Ip dM_pk/dz.
    """
    v = wall_and_coils
    dtype, dev = v.r.dtype, v.r.device
    r0, ip_ma, n_index, m_eff = (torch.as_tensor(x, dtype=dtype, device=dev)
                                 for x in (r0, ip_ma, n_index, m_eff))
    n_circ = v.r.shape[0]
    n_coils = n_circ - n_wall
    ip = ip_ma * 1e6

    k_force = n_index * MU_0 * ip ** 2 / (4.0 * math.pi * r0)

    # Exact dM/dz of the plasma-filament mutual at the filament position.
    def dm_dz(rk, zk):
        return torch.func.grad(lambda zp: mutual_inductance(r0, zp, rk, zk))(
            torch.zeros((), dtype=dtype, device=dev))

    c_vec = torch.func.vmap(dm_dz)(v.r, v.z) * ip          # (n_circ,)

    m = mutual_matrix(v)
    m_inv = torch.linalg.inv(m)
    m_inv_r = m_inv * v.resistance[None, :]          # M^-1 @ diag(R)
    m_inv_c = _mv(m_inv, c_vec)

    n_states = 2 + n_circ
    a = torch.zeros((n_states, n_states), dtype=dtype, device=dev)
    a[0, 1] = 1.0
    a[1, 0] = -k_force / m_eff
    a[1, 2:] = c_vec / m_eff
    a[2:, 1] = -m_inv_c
    a[2:, 2:] = -m_inv_r

    b = torch.zeros((n_states, n_coils), dtype=dtype, device=dev)
    b[2:, :] = m_inv[:, n_wall:]
    c = torch.zeros((1, n_states), dtype=dtype, device=dev)
    c[0, 0] = 1.0
    d = torch.zeros((1, n_coils), dtype=dtype, device=dev)
    return RZIPStateSpace(a, b, c, d)


def vertical_growth_rate(ss: RZIPStateSpace) -> float:
    """Max real eigenvalue of A [1/s] (host eig on the tiny matrix)."""
    return float(np.max(np.real(np.linalg.eigvals(ss.a.detach().cpu().numpy()))))


def vertical_growth_time_ms(ss: RZIPStateSpace) -> float:
    gamma = vertical_growth_rate(ss)
    return float("inf") if gamma <= 0.0 else 1000.0 / gamma


def compute_n_index(psi: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
                    r0: float) -> torch.Tensor:
    """Midplane vertical-stability index n = -(R0/Bz) dBz/dR from a psi map
    (reference ``VerticalStabilityAnalysis.compute_n_index``)."""
    dr = r[1] - r[0]
    z0_idx = torch.argmin(z.abs())
    psi_mid = psi[z0_idx, :]
    bz = _gradient_1d(psi_mid, dr) / r
    dbz_dr = _gradient_1d(bz, dr)
    r0_idx = torch.argmin((r - r0).abs())
    bz_local = bz[r0_idx]
    floor = torch.full_like(bz_local, 1e-12)
    return -(r0 / torch.where(bz_local.abs() < 1e-12, floor, bz_local)) * dbz_dr[r0_idx]


def _gradient_1d(f, dx):
    """Second-order gradient with one-sided second-order edges."""
    interior = (f[2:] - f[:-2]) / (2.0 * dx)
    left = (-3.0 * f[0] + 4.0 * f[1] - f[2]) / (2.0 * dx)
    right = (3.0 * f[-1] - 4.0 * f[-2] + f[-3]) / (2.0 * dx)
    return torch.cat([left[None], interior, right[None]])


def passive_stability_margin(n_index: float, tau_wall: float) -> float:
    """Contract-parity proxy: the margin is the n-index itself."""
    return n_index


def required_feedback_gain(gamma: float, tau_wall: float, tau_controller: float) -> float:
    """Additive-lag sizing rule g_min = gamma (tau_wall + tau_ctrl)."""
    if not (math.isfinite(gamma) and math.isfinite(tau_wall)
            and math.isfinite(tau_controller)):
        raise ValueError("gamma, tau_wall, tau_controller must be finite")
    if gamma <= 0 or tau_wall <= 0 or tau_controller <= 0:
        raise ValueError("gamma, tau_wall, tau_controller must be positive")
    return gamma * (tau_wall + tau_controller)


def rzip_lqr_gain(ss: RZIPStateSpace, kp: float = 10.0, kd: float = 10.0, *,
                  dt: float = 1e-4, n_steps: int = 20000) -> torch.Tensor:
    """LQR voltage-controller gain K = R^-1 B^T P via the shared CARE
    integrator (reference ``RZIPController.__init__`` uses SciPy ARE).
    Q weights [Z, dZ/dt]; R = I."""
    a, b = ss.a, ss.b
    n = a.shape[0]
    q = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    q[0, 0] = max(kp, 1.0)
    q[1, 1] = max(kd, 1.0)
    s = b @ _t(b)      # R = I -> B R^-1 B^T
    p = solve_care_ode(a, s, q, dt=dt, n_steps=n_steps)
    return _t(b) @ p


def rzip_voltage_command(k_gain: torch.Tensor, z_meas, dz_dt) -> torch.Tensor:
    """u = -K x with only (Z, dZ/dt) measured; circuit states assumed 0."""
    x = torch.zeros((k_gain.shape[1],), dtype=k_gain.dtype, device=k_gain.device)
    x[0] = z_meas
    x[1] = dz_dt
    return -_mv(k_gain, x)


def closed_loop_eigenvalues(ss: RZIPStateSpace, k_gain: torch.Tensor) -> np.ndarray:
    """Eigenvalues of A - B K (host eig; stability smoke checks)."""
    a, b, k = (t.detach().cpu().numpy() for t in (ss.a, ss.b, k_gain))
    return np.linalg.eigvals(a - b @ k)
